"""Complex circular-symmetric Gaussian (counterpart of
``pb_bss_tpu.models.complex_circular_symmetric_gaussian``): the log-pdf,
a sampler driven by a ``torch.Generator`` (where the JAX package takes a
key) and the weighted-scatter trainer."""
from __future__ import annotations

import math

import torch

from .._dtypes import real_dtype as _real_dtype
from .base import Model, force_hermitian, modelclass

__all__ = [
    'ComplexCircularSymmetricGaussian',
    'ComplexCircularSymmetricGaussianTrainer',
]


@modelclass
class ComplexCircularSymmetricGaussian(Model):
    covariance: torch.Tensor = None  # (..., D, D)

    def log_pdf(self, y):
        """y: (..., N, D) -> (..., N)."""
        D = y.shape[-1]
        _, logdet = torch.linalg.slogdet(self.covariance)
        inv_y = torch.linalg.solve(
            self.covariance, y.transpose(-2, -1))  # (..., D, N)
        quad = torch.einsum('...nd,...dn->...n', y.conj(), inv_y).real
        return -D * math.log(math.pi) - logdet.real[..., None] - quad

    def sample(self, size, generator=None):
        """Draw ``size`` (int or tuple) samples of an unbatched model.

        Args:
            generator: ``torch.Generator`` (default: one seeded 0 on the
                covariance's device).
        Returns:
            (*size, D) complex samples.
        """
        if isinstance(size, int):
            size = (size,)
        covariance = self.covariance
        D = covariance.shape[-1]
        assert covariance.ndim == 2, (
            'Not implemented for batched covariance', covariance.shape)
        if generator is None:
            generator = torch.Generator(covariance.device).manual_seed(0)
        rdtype = _real_dtype(covariance)

        def normal():
            return torch.randn((*size, D), generator=generator,
                               dtype=rdtype, device=covariance.device)

        x = torch.complex(normal(), normal()) * math.sqrt(0.5)
        cholesky = torch.linalg.cholesky(covariance)
        return (cholesky @ x[..., None])[..., 0]


class ComplexCircularSymmetricGaussianTrainer:
    def fit(self, y, saliency=None):
        """y: (..., N, D) complex; saliency: optional (..., N)."""
        assert y.is_complex(), y.dtype
        return self._fit(y, saliency=saliency)

    def _fit(self, y, saliency):
        if saliency is None:
            denominator = torch.tensor(
                y.shape[-2], dtype=_real_dtype(y), device=y.device)
            covariance = torch.einsum('...nd,...ne->...de', y, y.conj())
        else:
            denominator = saliency.sum(-1)[..., None, None]
            covariance = torch.einsum(
                '...n,...nd,...ne->...de', saliency.to(y.dtype), y,
                y.conj())
        return ComplexCircularSymmetricGaussian(
            covariance=force_hermitian(covariance / denominator))
