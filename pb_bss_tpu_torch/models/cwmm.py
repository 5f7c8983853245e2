"""Complex Watson mixture model (CWMM).

Counterpart of ``pb_bss_tpu.models.cwmm``: the model (predict) and the
EM trainer with inline permutation alignment, with the JAX package's
routing between the plain EM loop (:func:`~pb_bss_tpu_torch.models._em.
run_em`) and the Watson EM kernels, decision for decision
(``pb_bss_tpu/models/cwmm.py:145-227``):

1. **whole fit** (:func:`pb_bss_tpu_torch.ops.cwmm_loop.cwmm_em_full`,
   one launch, K6): per-bin weights, T inside the kernel's gate
   (:func:`~pb_bss_tpu_torch.ops.cwmm_loop.fits`, saliency included).
2. **streamed** (:func:`pb_bss_tpu_torch.ops.mm_stream.cwmm_em_long`,
   one statistics launch per iteration, K7, with the M-step finish in
   PyTorch and the batched Jacobi K1): frequency-constant weights at any
   T, and per-bin weights past route 1's gate.
3. **scan**: the plain EM loop, with the inline aligner after each
   E-step when one is given.

``use_fused_em='auto'`` takes routes 1-2 only on the accelerator (CUDA
tensors, :func:`_on_accelerator`), for complex64 (F, N, D) /
(B, F, N, D) input with D <= 16, per-bin or frequency-constant weights
and no inline aligner. ``use_fused_em=True`` forces them on any device
(the kernels' plain twins on the CPU) and asserts on knobs they do not
take; ``False`` skips them. The gates are the port's own, from shared
memory; the JAX package's are its VMEM budgets.

The whole-fit kernel inverts the eigenvalue ratio through a uniform
512-point table, the scan path and the streamed route through the
log-spaced ``hyp1f1`` table: the concentrations differ by ~1e-3
relative, the quality not.
"""
from __future__ import annotations

from operator import xor

import torch

from .._dtypes import real_dtype as _real_dtype
from ..ops import cwmm_loop, mm_stream
from ._em import run_em
from .base import Model, modelclass
from .complex_watson import (
    ComplexWatson,
    ComplexWatsonTrainer,
    normalize_observation,
)
from .mixture_model_utils import (
    estimate_mixture_weight,
    log_pdf_to_affiliation,
)

__all__ = ['CWMM', 'CWMMTrainer']


@modelclass
class CWMM(Model):
    weight: torch.Tensor = None  # (..., K, 1)
    complex_watson: ComplexWatson = None

    def predict(self, y):
        """y: (..., N, D) complex -> affiliations (..., K, N)."""
        assert y.is_complex(), y.dtype
        return self._predict(normalize_observation(y))

    def _predict(self, y):
        """E-step on unit-norm (..., N, D) observations."""
        return log_pdf_to_affiliation(
            self.weight, self.complex_watson.log_pdf(y[..., None, :, :]),
            source_activity_mask=None, affiliation_eps=0.)


def _on_accelerator(y):
    """Do the Watson EM kernels run for ``y``? (CUDA tensors; the JAX
    package asks ``jax.default_backend() != 'cpu'``.)"""
    return y.device.type == 'cuda'


class CWMMTrainer:
    def __init__(self, dimension=None, max_concentration=500,
                 spline_markers=1000):
        """
        Args:
            dimension: feature dimension (inferred at fit if None).
            max_concentration: 500 is stable for dimension <= 60.
            spline_markers: concentration lookup-table resolution.
        """
        self.dimension = dimension
        self.max_concentration = max_concentration
        self.spline_markers = spline_markers
        self._watson_trainer = None

    @property
    def complex_watson_trainer(self):
        if self._watson_trainer is None:
            self._watson_trainer = ComplexWatsonTrainer(
                self.dimension, max_concentration=self.max_concentration,
                spline_markers=self.spline_markers)
        return self._watson_trainer

    def fit(self, y, initialization=None, num_classes=None, iterations=100,
            *, generator=None, saliency=None, weight_constant_axis=(-1,),
            affiliation_eps=0, inline_permutation_aligner=None,
            use_fused_em='auto', _return_affiliation=False) -> CWMM:
        """EM for CWMMs with any number of independent dimensions.

        Args:
            y: (..., N, D) complex observations.
            initialization: affiliations (..., K, N), or None (then
                ``num_classes`` and ``generator`` draw a random one).
            num_classes: K (exclusive with initialization).
            iterations: number of M-steps.
            generator: ``torch.Generator`` for the random init (default:
                one seeded 0 on y's device).
            saliency: (..., N) importance weights.
            weight_constant_axis: axis/axes averaged for the weight.
            affiliation_eps: must be 0.
            inline_permutation_aligner: an aligner run on each E-step's
                posterior (frequency-constant weights; scan path only).
            use_fused_em: ``'auto'``, True or False — see the module
                docstring.
        """
        assert xor(initialization is None, num_classes is None), (
            'Provide either `initialization` or `num_classes` — not both '
            f'and not neither. Got initialization is None: '
            f'{initialization is None}, num_classes is None: '
            f'{num_classes is None}.')
        assert y.is_complex(), y.dtype
        assert y.shape[-1] > 1
        assert y.shape[-1] < 35, f'Channels: {y.shape[-1]}, sure?'
        y = normalize_observation(y)

        if initialization is None:
            *independent, num_observations, _ = y.shape
            if generator is None:
                generator = torch.Generator(device=y.device).manual_seed(0)
            initialization = torch.rand(
                (*independent, num_classes, num_observations),
                generator=generator, dtype=_real_dtype(y), device=y.device)
            initialization = initialization / initialization.sum(
                -2, keepdim=True)
        initialization = torch.as_tensor(initialization, device=y.device)

        if self.dimension is None:
            self.dimension = y.shape[-1]
        else:
            assert self.dimension == y.shape[-1], (
                'You initialized the trainer with a different dimension '
                'than you are using to fit a model. Use a new trainer, '
                'when you change the dimension.')
        if isinstance(weight_constant_axis, list):
            weight_constant_axis = tuple(weight_constant_axis)
        assert affiliation_eps == 0, affiliation_eps

        D, T = y.shape[-1], y.shape[-2]
        K = initialization.shape[-2]
        has_sal = saliency is not None
        aligner = inline_permutation_aligner
        per_bin = weight_constant_axis in ((-1,), -1)
        fc = weight_constant_axis in ((-3, -1), (-1, -3))
        whole_fit = per_bin and cwmm_loop.fits(D, K, T, has_sal)
        if use_fused_em == 'auto':
            use_fused_em = (
                _on_accelerator(y) and y.ndim in (3, 4)
                and y.dtype == torch.complex64 and D <= 16
                and aligner is None and (per_bin or fc)
                and (whole_fit or mm_stream.fits(D, K, has_sal)))
        if use_fused_em:
            assert y.ndim in (3, 4), y.shape
            assert aligner is None, 'the Watson EM kernels host no aligner'
            assert per_bin or fc, weight_constant_axis
            y_dt = y.transpose(-2, -1)  # (..., F, D, T)
            if saliency is not None:
                saliency = torch.broadcast_to(
                    torch.as_tensor(saliency, dtype=_real_dtype(y),
                                    device=y.device), (*y.shape[:-2], T))
            init = initialization.to(torch.float32)
            affiliation = None
            if whole_fit:
                weight, mode, concentration, affiliation = \
                    cwmm_loop.cwmm_em_full(
                        y_dt, init, iterations=int(iterations),
                        # warm-started Jacobi: 2 sweeps from the previous
                        # eigenbasis, the first iteration cold
                        warm_sweeps=2,
                        max_concentration=float(self.max_concentration),
                        saliency=saliency)
                weight = weight[..., None]
            else:
                weight, mode, concentration = mm_stream.cwmm_em_long(
                    y_dt, init, iterations=int(iterations),
                    max_concentration=float(self.max_concentration),
                    spline_markers=int(self.spline_markers),
                    weight_mode='per_bin' if per_bin else 'fc',
                    saliency=saliency)
                # estimate_mixture_weight's keepdims shapes
                weight = weight[..., None] if per_bin \
                    else weight[..., None, :, None]
            model = CWMM(weight=weight, complex_watson=ComplexWatson(
                mode=mode, concentration=concentration))
            if _return_affiliation:
                if affiliation is None:
                    affiliation = model._predict(y)
                return model, affiliation
            return model

        if saliency is None:
            saliency = torch.ones_like(initialization[..., 0, :])
        else:
            saliency = torch.as_tensor(saliency, device=y.device)
        model = _cwmm_fit_em(
            y, initialization, saliency,
            watson_trainer=self.complex_watson_trainer,
            iterations=int(iterations),
            weight_constant_axis=weight_constant_axis, aligner=aligner)
        if _return_affiliation:
            return model, model._predict(y)
        return model

    def fit_predict(self, y, initialization=None, num_classes=None,
                    iterations=100, **kwargs):
        """Fit a model, then return the posterior affiliations (from the
        whole-fit kernel's final E-step when it runs)."""
        _, affiliation = self.fit(
            y, initialization, num_classes, iterations,
            _return_affiliation=True, **kwargs)
        return affiliation


def _cwmm_fit_em(y, affiliation, saliency, *, watson_trainer, iterations,
                 weight_constant_axis, aligner):
    """The scan path: :func:`run_em` with the Watson M-step and E-step."""
    def m_step(affiliation):
        weight = estimate_mixture_weight(
            affiliation=affiliation, saliency=saliency,
            weight_constant_axis=weight_constant_axis)
        complex_watson = watson_trainer._fit(
            y=y[..., None, :, :],
            saliency=affiliation * saliency[..., None, :])
        return CWMM(weight=weight, complex_watson=complex_watson)

    return run_em(
        affiliation=affiliation, iterations=iterations, m_step=m_step,
        e_step=lambda model: model._predict(y), aligner=aligner,
        weight_constant_axis=weight_constant_axis)
