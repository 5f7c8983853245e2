"""von Mises-Fisher mixture model (counterpart of
``pb_bss_tpu.models.vmfmm``): the posterior of unit-normalized real
observations and the EM trainer on the port's
:mod:`~pb_bss_tpu_torch.models.von_mises_fisher`, through the shared
loop of :mod:`pb_bss_tpu_torch.models._em`."""
from __future__ import annotations

from operator import xor

import torch

from ._em import run_em
from .base import Model, modelclass
from .mixture_model_utils import (
    estimate_mixture_weight,
    log_pdf_to_affiliation,
)
from .von_mises_fisher import VonMisesFisher, VonMisesFisherTrainer

__all__ = ['VMFMM', 'VMFMMTrainer']


def _unit(y):
    return y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True),
                           min=torch.finfo(y.dtype).tiny)


@modelclass
class VMFMM(Model):
    vmf: VonMisesFisher = None
    weight: torch.Tensor = None  # (..., K, 1)

    def predict(self, y):
        """y: (..., N, D) -> affiliations (..., K, N)."""
        y = torch.as_tensor(y)
        assert not y.is_complex(), y.dtype
        return self._predict(_unit(y))

    def _predict(self, y):
        log_pdf = self.vmf.log_pdf(y[..., None, :, :])
        return log_pdf_to_affiliation(self.weight, log_pdf)


class VMFMMTrainer:
    """EM for vMF mixtures (clusters e.g. DC embeddings)."""

    def fit(self, y, initialization=None, num_classes=None, iterations=100,
            *, generator=None, saliency=None, weight_constant_axis=(-1,),
            min_concentration=1e-10, max_concentration=500) -> VMFMM:
        """EM for vMFMMs with any number of independent dimensions.

        Args:
            y: (..., N, D) real observations (normalized here).
            initialization: affiliations (..., K, N) or None.
            num_classes: K (exclusive with initialization).
            generator: ``torch.Generator`` of the random initialization
                (default: one seeded 0 on y's device).
        """
        assert xor(initialization is None, num_classes is None), (
            'Provide either `initialization` or `num_classes` — not '
            'both and not neither. Got initialization is None: '
            f'{initialization is None}, num_classes is None: '
            f'{num_classes is None}.')
        y = torch.as_tensor(y)
        assert not y.is_complex(), y.dtype
        y = _unit(y)
        if initialization is None:
            *independent, num_observations, _ = y.shape
            if generator is None:
                generator = torch.Generator(y.device).manual_seed(0)
            initialization = torch.rand(
                (*independent, num_classes, num_observations),
                generator=generator, dtype=y.dtype, device=y.device)
            initialization = initialization / initialization.sum(
                -2, keepdim=True)
        initialization = torch.as_tensor(initialization, device=y.device)
        if saliency is None:
            saliency = torch.ones_like(initialization[..., 0, :])
        if isinstance(weight_constant_axis, list):
            weight_constant_axis = tuple(weight_constant_axis)

        def m_step(affiliation):
            weight = estimate_mixture_weight(
                affiliation, saliency=saliency,
                weight_constant_axis=weight_constant_axis)
            vmf = VonMisesFisherTrainer()._fit(
                y[..., None, :, :],
                saliency=affiliation * saliency[..., None, :],
                min_concentration=float(min_concentration),
                max_concentration=float(max_concentration))
            return VMFMM(weight=weight, vmf=vmf)

        return run_em(affiliation=initialization,
                      iterations=int(iterations), m_step=m_step,
                      e_step=lambda model: model._predict(y))

    def fit_predict(self, y, initialization=None, num_classes=None,
                    iterations=100, **kwargs):
        """Fit a model, then return its posterior affiliations for
        ``y`` (keyword knobs are those of :meth:`fit`)."""
        model = self.fit(y=y, initialization=initialization,
                         num_classes=num_classes, iterations=iterations,
                         **kwargs)
        return model.predict(y)
