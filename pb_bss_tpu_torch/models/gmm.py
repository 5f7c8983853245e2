"""GMM and k-means (``BinaryGMM``) for Deep-Clustering embeddings
(counterpart of ``pb_bss_tpu.models.gmm``).

``GMM`` / ``GMMTrainer``: EM on real observations with any number of
independent dimensions, full, diagonal or spherical covariances and an
optional fixed covariance, through the shared loop of
:mod:`pb_bss_tpu_torch.models._em`. ``BinaryGMM`` / ``BinaryGMMTrainer``:
Lloyd k-means with farthest-point (k-means++-style) seeding. The JAX
package runs both loops as ``lax.scan``; here they are plain loops. A
``torch.Generator`` takes the place of the JAX key.
"""
from __future__ import annotations

from operator import xor

import numpy as np
import torch

from ._em import run_em
from .base import Model, modelclass
from .gaussian import Gaussian, GaussianTrainer
from .mixture_model_utils import (
    estimate_mixture_weight,
    log_pdf_to_affiliation,
)

__all__ = ['GMM', 'GMMTrainer', 'BinaryGMM', 'BinaryGMMTrainer', 'kmeans']


def _generator(generator, device):
    if generator is None:
        return torch.Generator(device).manual_seed(0)
    return generator


@modelclass
class GMM(Model):
    weight: torch.Tensor = None  # (..., K, 1)
    gaussian: Gaussian = None

    def predict(self, x):
        """x: (..., N, D) -> affiliations (..., K, N)."""
        return log_pdf_to_affiliation(
            self.weight, self.gaussian.log_pdf(x[..., None, :, :]))


class GMMTrainer:
    def __init__(self, eps=1e-10):
        self.eps = eps
        self.log_likelihood_history = []

    def fit(self, y, initialization=None, num_classes=None, iterations=100,
            *, generator=None, saliency=None, weight_constant_axis=(-1,),
            covariance_type='full', fixed_covariance=None):
        """EM for GMMs with any number of independent dimensions.

        Args:
            y: (..., N, D) real observations.
            initialization: affiliations (..., K, N) or None.
            num_classes: K (exclusive with initialization).
            generator: ``torch.Generator`` of the random initialization
                (default: one seeded 0 on y's device).
            saliency: optional (..., N) weights.
            fixed_covariance: replaces the learned covariance (its shape
                must be that of ``covariance_type``'s covariance).
        """
        assert xor(initialization is None, num_classes is None), (
            'Provide either `initialization` or `num_classes` — not '
            'both and not neither. Got initialization is None: '
            f'{initialization is None}, num_classes is None: '
            f'{num_classes is None}.')
        y = torch.as_tensor(y)
        assert not y.is_complex(), y.dtype
        if initialization is None:
            *independent, num_observations, _ = y.shape
            initialization = torch.rand(
                (*independent, num_classes, num_observations),
                generator=_generator(generator, y.device), dtype=y.dtype,
                device=y.device)
            initialization = initialization / initialization.sum(
                -2, keepdim=True)
        initialization = torch.as_tensor(initialization, device=y.device)
        if saliency is None:
            saliency = torch.ones_like(initialization[..., 0, :])
        if isinstance(weight_constant_axis, list):
            weight_constant_axis = tuple(weight_constant_axis)
        if fixed_covariance is not None:
            fixed_covariance = torch.as_tensor(fixed_covariance,
                                               device=y.device)

        def m_step(affiliation):
            weight = estimate_mixture_weight(
                affiliation=affiliation, saliency=saliency,
                weight_constant_axis=weight_constant_axis)
            gaussian = GaussianTrainer()._fit(
                y=y[..., None, :, :],
                saliency=affiliation * saliency[..., None, :],
                covariance_type=covariance_type)
            if fixed_covariance is not None:
                assert fixed_covariance.shape == gaussian.covariance.shape, (
                    f'{fixed_covariance.shape} != '
                    f'{gaussian.covariance.shape}')
                gaussian = gaussian.__class__(
                    mean=gaussian.mean, covariance=fixed_covariance)
            return GMM(weight=weight, gaussian=gaussian)

        return run_em(affiliation=initialization,
                      iterations=int(iterations), m_step=m_step,
                      e_step=lambda model: model.predict(y))

    def fit_predict(self, y, initialization=None, num_classes=None,
                    iterations=100, *, generator=None, saliency=None,
                    weight_constant_axis=(-2,), covariance_type='full',
                    fixed_covariance=None):
        """Fit a model, then return its posterior affiliations for
        ``y`` (the JAX package's default ``weight_constant_axis`` here
        is ``(-2,)``, fixed 1/K weights)."""
        model = self.fit(
            y=y, initialization=initialization, num_classes=num_classes,
            iterations=iterations, generator=generator, saliency=saliency,
            weight_constant_axis=weight_constant_axis,
            covariance_type=covariance_type,
            fixed_covariance=fixed_covariance)
        return model.predict(torch.as_tensor(y))


def kmeans(x, num_classes, *, generator=None, iterations=25):
    """Lloyd k-means with farthest-point (k-means++-style) seeding.

    The first center is a random point; each further center is the
    point farthest from the centers so far. Each Lloyd step assigns the
    points to their nearest center (the first of equal distances) and
    moves each center to its points' mean; an empty cluster keeps its
    center.

    Args:
        x: (N, D) real points.
        num_classes: K.
        generator: ``torch.Generator`` of the first center (default:
            one seeded 0 on x's device).
        iterations: Lloyd iterations.
    Returns:
        (K, D) cluster centers.
    """
    x = torch.as_tensor(x)
    N, D = x.shape
    first = torch.randint(0, N, (), generator=_generator(generator, x.device),
                          device=x.device)
    centers = torch.zeros((num_classes, D), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    min_d2 = torch.full((N,), torch.inf, dtype=x.dtype, device=x.device)
    for k in range(1, num_classes):
        d2 = ((x - centers[k - 1]) ** 2).sum(-1)
        min_d2 = torch.minimum(min_d2, d2)
        centers[k] = x[torch.argmax(min_d2)]

    classes = torch.arange(num_classes, device=x.device)
    for _ in range(iterations):
        d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)  # (N, K)
        onehot = (torch.argmin(d2, dim=-1)[:, None] == classes).to(x.dtype)
        counts = onehot.sum(0)
        new_centers = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
        centers = torch.where((counts > 0)[:, None], new_centers, centers)
    return centers


@modelclass
class BinaryGMM(Model):
    """Hard-assignment clustering model for DC embeddings: the k-means
    centers."""

    means: torch.Tensor = None  # (K, D)

    def predict(self, x):
        """x: (N, D) -> one-hot affiliations (K, N)."""
        x = torch.as_tensor(x)
        assert x.ndim == 2, x.shape
        assert not x.is_complex(), x.dtype
        K = self.means.shape[0]
        d2 = ((x[:, None, :] - self.means[None, :, :]) ** 2).sum(-1)
        labels = torch.argmin(d2, dim=-1)  # (N,)
        return (labels[None, :] == torch.arange(
            K, device=x.device)[:, None]).to(x.dtype)


class BinaryGMMTrainer:
    """k-means trainer for Deep Clustering embeddings."""

    def fit(self, x, num_classes, saliency=None, *, generator=None,
            iterations=25):
        """
        Args:
            x: (N, D) embeddings.
            num_classes: K.
            saliency: optional boolean (N,): excluded points do not
                influence the centers.
        """
        x = torch.as_tensor(x)
        N, D = x.shape
        if saliency is not None:
            saliency = np.asarray(saliency)
            assert saliency.dtype == bool, (
                'Only boolean saliency supported. '
                f'Current dtype: {saliency.dtype}.')
            assert saliency.shape == (N,)
            x = x[torch.as_tensor(saliency, device=x.device)]
        return BinaryGMM(means=kmeans(x, num_classes, generator=generator,
                                      iterations=iterations))
