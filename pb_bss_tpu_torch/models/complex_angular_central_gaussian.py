"""Complex angular central Gaussian (cACG) — the core spatial density.

Counterpart of ``pb_bss_tpu.models.complex_angular_central_gaussian``:
eigendecomposition parameterization with eigenvalue max-normalization
and floor, unit-norm + time-last observation normalization,
quadratic-form log-pdf and the weighted-scatter M-step.
"""
from __future__ import annotations

import torch

from .._dtypes import real_dtype as _real_dtype, tiny as _tiny
from ..ops.linalg import eigh
from ._precision import full_fp32
from .base import Model, force_hermitian, modelclass, unit_norm
from .complex_circular_symmetric_gaussian import (
    ComplexCircularSymmetricGaussian,
)

__all__ = [
    'ComplexAngularCentralGaussian',
    'ComplexAngularCentralGaussianTrainer',
    'sample_complex_angular_central_gaussian',
    'normalize_observation',
]


def normalize_observation(observation):
    """Unit-norm over channels, then time-last layout.

    Args:
        observation: (..., N, D) complex.
    Returns:
        (..., D, N) unit-norm observations (zero vectors stay zero).
    """
    observation = unit_norm(observation, axis=-1, eps=_tiny(observation),
                            eps_style='where')
    return observation.transpose(-2, -1)


def sample_complex_angular_central_gaussian(size, covariance,
                                            generator=None):
    """Draw cACG samples: complex circular-symmetric Gaussian draws of
    ``covariance`` (D, D), normalized to unit norm.

    Args:
        size: int or tuple, the sample shape; returns (*size, D).
        generator: ``torch.Generator`` (default: one seeded 0 on the
            covariance's device).
    """
    csg = ComplexCircularSymmetricGaussian(
        covariance=torch.as_tensor(covariance))
    x = csg.sample(size=size, generator=generator)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@modelclass
class ComplexAngularCentralGaussian(Model):
    """Parameterized by the covariance eigendecomposition; eigenvalues
    are normalized and floored (see ``from_covariance``)."""

    covariance_eigenvectors: torch.Tensor = None  # (..., D, D)
    covariance_eigenvalues: torch.Tensor = None  # (..., D)
    # the frequency axis of each field as a mixture's component,
    # (..., F, K, ...): what a sharded fit gathers (_shard.py)
    bin_axes = {'covariance_eigenvectors': -4, 'covariance_eigenvalues': -3}

    @classmethod
    def from_covariance(cls, covariance, eigenvalue_floor=0.,
                        covariance_norm='eigenvalue', eigh_sweeps=None,
                        eigh_method='auto'):
        if covariance_norm == 'trace':
            cov_trace = torch.diagonal(
                covariance, dim1=-2, dim2=-1).sum(-1)[..., None, None]
            covariance = covariance / torch.clamp(
                cov_trace.abs(), min=_tiny(covariance))
        else:
            assert covariance_norm in ['eigenvalue', False], covariance_norm

        eigenvals, eigenvecs = eigh(
            covariance, method=eigh_method, sweeps=eigh_sweeps)
        if covariance_norm == 'eigenvalue':
            # the scale of the eigenvalues does not matter for the density
            eigenvals = eigenvals / torch.clamp(
                eigenvals.max(-1, keepdim=True).values,
                min=_tiny(eigenvals))
            eigenvals = torch.clamp(eigenvals, min=eigenvalue_floor)
        else:
            eigenvals = torch.maximum(
                eigenvals,
                eigenvals.max(-1, keepdim=True).values * eigenvalue_floor)
        return cls(covariance_eigenvalues=eigenvals,
                   covariance_eigenvectors=eigenvecs)

    @property
    def covariance(self):
        """``V diag(lambda) V^H`` (..., D, D)."""
        vectors = self.covariance_eigenvectors
        return torch.einsum(
            '...wx,...x,...zx->...wz', vectors,
            self.covariance_eigenvalues.to(vectors.dtype), vectors.conj())

    @property
    def log_determinant(self):
        return torch.log(self.covariance_eigenvalues).sum(-1)

    def sample(self, size, generator=None):
        """(*size, D) unit-norm samples (unbatched model)."""
        return sample_complex_angular_central_gaussian(
            size=size, covariance=self.covariance, generator=generator)

    def log_pdf(self, y):
        """y: (..., N, D) -> (..., N)."""
        log_pdf, _ = self._log_pdf(normalize_observation(y))
        return log_pdf

    def _log_pdf(self, y):
        """y in time-last layout (..., D, N); returns (log_pdf,
        quadratic_form), both (..., N)."""
        D = y.shape[-2]
        with full_fp32():
            # z = V^H y, then the quadratic form sum_e |z_e|^2 / l_e
            z = torch.einsum(
                '...de,...dt->...et', self.covariance_eigenvectors.conj(),
                y)
            quadratic_form = torch.einsum(
                '...et,...e->...t', z.real ** 2 + z.imag ** 2,
                1. / self.covariance_eigenvalues)
        quadratic_form = torch.clamp(quadratic_form, min=_tiny(y))
        log_pdf = -D * torch.log(quadratic_form)
        log_pdf = log_pdf - self.log_determinant[..., None]
        return log_pdf, quadratic_form


class ComplexAngularCentralGaussianTrainer:
    def fit(self, y, saliency=None, hermitize=True,
            covariance_norm='eigenvalue', eigenvalue_floor=1e-10,
            iterations=10):
        """Fixed-point iteration for a single cACG: ``iterations``
        M-steps, each from the previous model's quadratic form (the
        first from ones).

        Args:
            y: (..., N, D) complex; normalized to unit norm here.
            saliency: optional (..., N) weights.
        """
        assert y.is_complex(), y.dtype
        assert y.shape[-1] > 1
        *independent, N, D = y.shape
        y = normalize_observation(y)  # (..., D, N)
        assert iterations > 0, iterations
        quadratic_form = torch.ones((*independent, N),
                                    dtype=_real_dtype(y), device=y.device)
        model = None
        for _ in range(iterations):
            model = self._fit(
                y=y, saliency=saliency, quadratic_form=quadratic_form,
                hermitize=hermitize, covariance_norm=covariance_norm,
                eigenvalue_floor=eigenvalue_floor)
            _, quadratic_form = model._log_pdf(y)
        return model

    def _fit(self, y, saliency, quadratic_form, hermitize=True,
             covariance_norm='eigenvalue', eigenvalue_floor=1e-10,
             eigh_sweeps=None, eigh_method='auto'):
        """Single M-step. y in time-last layout (..., D, N);
        saliency/quadratic_form: (..., N)."""
        D = y.shape[-2]
        N = quadratic_form.shape[-1]
        rdtype = _real_dtype(y)
        # floor: a zero covariance gives a zero quadratic form
        quadratic_form = torch.clamp(
            quadratic_form, min=10 * _tiny(quadratic_form))
        if saliency is None:
            weights = 1.0 / quadratic_form
            denominator = torch.tensor(N, dtype=rdtype, device=y.device)
        else:
            weights = saliency / quadratic_form
            denominator = saliency.sum(-1)[..., None, None]
        yw = y * weights[..., None, :].to(rdtype)
        with full_fp32():
            covariance = D * torch.einsum('...dn,...en->...de', yw, y.conj())
        covariance = covariance / torch.clamp(
            denominator, min=_tiny(covariance)).to(rdtype)
        if hermitize:
            covariance = force_hermitian(covariance)
        return ComplexAngularCentralGaussian.from_covariance(
            covariance, eigenvalue_floor=eigenvalue_floor,
            covariance_norm=covariance_norm, eigh_sweeps=eigh_sweeps,
            eigh_method=eigh_method)
