"""von Mises-Fisher distribution on the real unit hypersphere.

Counterpart of ``pb_bss_tpu.models.von_mises_fisher``: the log
normalizer through the exponentially scaled modified Bessel function,
the log-pdf and the closed-form [Banerjee2005] trainer.

PyTorch has no general-order ``ive``, so :func:`log_ive` is the JAX
package's log-domain power series: ``logsumexp`` over 512 terms whose
gamma constants are computed on the host for the (static) order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import Model, modelclass

__all__ = ['VonMisesFisher', 'VonMisesFisherTrainer', 'log_ive']

_SERIES_TERMS = 512


def _series_constants(nu):
    """(log m! + log Gamma(m + nu + 1), 2 m + nu) over the series terms,
    float64 on the host."""
    m = np.arange(_SERIES_TERMS, dtype=np.float64)
    log_gamma = np.array([math.lgamma(i + 1) + math.lgamma(i + nu + 1)
                          for i in m])
    return log_gamma, 2 * m + nu


def log_ive(nu, kappa):
    """``log(ive(nu, kappa)) = log I_nu(kappa) - kappa``.

    Power series of the modified Bessel function in the log domain:
    ``I_nu(k) = sum_m (k/2)^(2m+nu) / (m! Gamma(m+nu+1))``. With 512
    terms the series dominates up to ``kappa ~ 900`` (the largest term
    sits near m = kappa/2), which covers the trainers' concentration
    range (at most 500).

    Args:
        nu: the order, a Python number.
        kappa: tensor of concentrations (float32 or float64).
    """
    kappa = torch.as_tensor(kappa)
    if not kappa.is_floating_point():
        kappa = kappa.to(torch.float32)
    log_gamma, orders = _series_constants(float(nu))
    log_gamma = torch.as_tensor(log_gamma, dtype=kappa.dtype,
                                device=kappa.device)
    orders = torch.as_tensor(orders, dtype=kappa.dtype, device=kappa.device)
    log_half_kappa = torch.log(torch.clamp(
        kappa / 2, min=torch.finfo(kappa.dtype).tiny))
    terms = orders * log_half_kappa[..., None] - log_gamma
    return torch.logsumexp(terms, dim=-1) - kappa


@modelclass
class VonMisesFisher(Model):
    mean: torch.Tensor = None  # (..., D)
    concentration: torch.Tensor = None  # (...,)
    # the rank of each field right of an utterance's axes as an
    # integration model's spectral component, (..., K, ...): what a
    # batch-sharded fit gathers (_shard.py)
    core_ranks = {'mean': 2, 'concentration': 1}

    def log_norm(self):
        """Stable for concentration > 1e-10."""
        D = self.mean.shape[-1]
        concentration = torch.as_tensor(self.concentration)
        return ((D / 2) * math.log(2 * math.pi)
                + log_ive(D / 2 - 1, concentration)
                + (concentration.abs()
                   - (D / 2 - 1) * torch.log(concentration)))

    def sample(self, size):
        raise NotImplementedError(
            'A good implementation can be found in libdirectional: '
            'https://github.com/libDirectional/libDirectional/blob/master/'
            'lib/distributions/Hypersphere/VMFDistribution.m#L239'
        )

    def norm(self):
        return torch.exp(self.log_norm())

    def log_pdf(self, y):
        """y: (..., N, D) observations; unit-normalized internally."""
        y = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                            min=torch.finfo(y.dtype).tiny)
        result = torch.einsum('...nd,...d->...n', y, self.mean)
        result = result * self.concentration[..., None]
        return result - self.log_norm()[..., None]

    def pdf(self, y):
        return torch.exp(self.log_pdf(y))


class VonMisesFisherTrainer:
    def fit(self, y, saliency=None, min_concentration=1e-10,
            max_concentration=500) -> VonMisesFisher:
        """Closed-form [Banerjee2005] fit.

        Args:
            y: (..., N, D) real observations (normalized internally).
            saliency: optional (..., N), broadcastable.
        """
        assert not y.is_complex(), y.dtype
        y = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                            min=torch.finfo(y.dtype).tiny)
        if saliency is not None:
            torch.broadcast_shapes(y.shape[:-1], saliency.shape)
        return self._fit(y, saliency=saliency,
                         min_concentration=min_concentration,
                         max_concentration=max_concentration)

    def _fit(self, y, saliency, min_concentration,
             max_concentration, reduce=None) -> VonMisesFisher:
        """``reduce`` (optional) completes each sum over the
        observations, e.g. over the ranks of a sharded fit."""
        D = y.shape[-1]
        if reduce is None:
            def reduce(x):
                return x
        if saliency is None:
            saliency = torch.ones(y.shape[:-1], dtype=y.dtype,
                                  device=y.device)
        # [Banerjee2005vMF] Equation 2.4
        r = reduce(torch.einsum('...n,...nd->...d', saliency, y))
        norm = torch.linalg.vector_norm(r, dim=-1)
        mean = r / torch.clamp(norm, min=torch.finfo(y.dtype).tiny)[..., None]
        # [Banerjee2005vMF] Equation 2.5
        r_bar = norm / reduce(saliency.sum(-1))
        # [Banerjee2005vMF] Equation 4.4
        concentration = (r_bar * D - r_bar ** 3) / (1 - r_bar ** 2)
        concentration = torch.clamp(concentration, min_concentration,
                                    max_concentration)
        return VonMisesFisher(mean=mean, concentration=concentration)
