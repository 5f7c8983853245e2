"""Real Gaussian models (full / diagonal / spherical covariance).

Counterpart of ``pb_bss_tpu.models.gaussian``: the models store only
(mean, covariance) and the full model whitens on the fly with a batched
Cholesky and a triangular solve; the trainer's weighted ML fit
dispatches on the covariance type.
"""
from __future__ import annotations

import math

import torch

from .._dtypes import tiny as _tiny
from .base import Model, modelclass

__all__ = [
    'Gaussian',
    'DiagonalGaussian',
    'SphericalGaussian',
    'GaussianTrainer',
]


@modelclass
class Gaussian(Model):
    mean: torch.Tensor = None  # (..., D)
    covariance: torch.Tensor = None  # (..., D, D)

    @property
    def precision_cholesky(self):
        """Upper-triangular P with covariance^-1 = P P^T (sklearn
        convention)."""
        d = self.mean.shape[-1]
        chol = torch.linalg.cholesky(self.covariance)
        eye = torch.eye(d, dtype=chol.dtype, device=chol.device).expand(
            chol.shape)
        inv = torch.linalg.solve_triangular(chol, eye, upper=False)
        return inv.transpose(-1, -2)

    @property
    def log_det_precision_cholesky(self):
        chol = torch.linalg.cholesky(self.covariance)
        return -torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)

    def log_pdf(self, y):
        """y: (..., N, D) -> (..., N)."""
        d = self.mean.shape[-1]
        chol = torch.linalg.cholesky(self.covariance)
        difference = y - self.mean[..., None, :]
        # white_x = L^-1 (y - mu): a batched triangular solve
        rhs = difference.transpose(-1, -2)
        batch = torch.broadcast_shapes(chol.shape[:-2], rhs.shape[:-2])
        white_x = torch.linalg.solve_triangular(
            chol.expand(*batch, d, d), rhs.expand(*batch, *rhs.shape[-2:]),
            upper=False)
        log_det_precision_cholesky = -torch.log(
            torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        return (-0.5 * d * math.log(2 * math.pi)
                + log_det_precision_cholesky[..., None]
                - 0.5 * (white_x ** 2).sum(-2))


@modelclass
class DiagonalGaussian(Model):
    mean: torch.Tensor = None  # (..., D)
    covariance: torch.Tensor = None  # (..., D)

    def log_pdf(self, y):
        d = self.mean.shape[-1]
        difference = y - self.mean[..., None, :]
        precision = 1.0 / self.covariance
        log_det_precision_cholesky = -0.5 * torch.log(
            self.covariance).sum(-1)
        return (-0.5 * d * math.log(2 * math.pi)
                + log_det_precision_cholesky[..., None]
                - 0.5 * (difference ** 2 * precision[..., None, :]).sum(-1))


@modelclass
class SphericalGaussian(Model):
    mean: torch.Tensor = None  # (..., D)
    covariance: torch.Tensor = None  # (...,)

    def log_pdf(self, y):
        d = self.mean.shape[-1]
        difference = y - self.mean[..., None, :]
        precision = 1.0 / self.covariance
        log_det_precision_cholesky = -0.5 * d * torch.log(self.covariance)
        return (-0.5 * d * math.log(2 * math.pi)
                + log_det_precision_cholesky[..., None]
                - 0.5 * (difference ** 2).sum(-1) * precision[..., None])


class GaussianTrainer:
    def fit(self, y, saliency=None, covariance_type='full'):
        """Weighted ML fit.

        Args:
            y: (..., N, D) real observations.
            saliency: optional (..., N) weights.
            covariance_type: 'full' | 'diagonal' | 'spherical'.
        """
        assert not y.is_complex(), y.dtype
        if saliency is not None:
            torch.broadcast_shapes(y.shape[:-1], saliency.shape)
        return self._fit(y, saliency=saliency,
                         covariance_type=covariance_type)

    def _fit(self, y, saliency, covariance_type, reduce=None):
        """``reduce`` (optional, with ``saliency``) completes each sum
        over the observations, e.g. over the ranks of a sharded fit."""
        dimension = y.shape[-1]
        if reduce is None:
            def reduce(x):
                return x
        if saliency is None:
            denominator = torch.tensor(y.shape[-2], dtype=y.dtype,
                                       device=y.device)
            mean = y.sum(-2)
        else:
            denominator = torch.clamp(reduce(saliency.sum(-1)), min=_tiny(y))
            mean = reduce(torch.einsum('...n,...nd->...d', saliency, y))
        mean = mean / denominator[..., None]
        difference = y - mean[..., None, :]

        if covariance_type == 'full':
            operation = '...nd,...nD->...dD'
            denominator_c = denominator[..., None, None]
            model_cls = Gaussian
        elif covariance_type == 'diagonal':
            operation = '...nd,...nd->...d'
            denominator_c = denominator[..., None]
            model_cls = DiagonalGaussian
        elif covariance_type == 'spherical':
            operation = '...nd,...nd->...'
            denominator_c = denominator * dimension
            model_cls = SphericalGaussian
        else:
            raise ValueError(f"Unknown covariance type '{covariance_type}'.")

        if saliency is None:
            covariance = torch.einsum(operation, difference, difference)
        else:
            covariance = reduce(torch.einsum('...n,' + operation, saliency,
                                             difference, difference))
        return model_cls(mean=mean, covariance=covariance / denominator_c)
