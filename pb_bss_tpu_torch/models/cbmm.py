"""Complex Bingham mixture model (CBMM).

Counterpart of ``pb_bss_tpu.models.cbmm``: the model (predict with
``affiliation_eps``) and the EM trainer with inline permutation
alignment, with the JAX package's routing between the plain EM loop
(:func:`~pb_bss_tpu_torch.models._em.run_em`) and the Bingham EM kernels,
decision for decision (``pb_bss_tpu/models/cbmm.py:109-319``):

1. **whole fit** (:func:`pb_bss_tpu_torch.ops.cbmm_loop.cbmm_em_full`,
   one launch, K9): per-bin weights, T inside the kernel's gate
   (:func:`~pb_bss_tpu_torch.ops.cbmm_loop.fits`, saliency included).
2. **streamed** (:func:`pb_bss_tpu_torch.ops.mm_stream.cbmm_em_long`, one
   statistics launch per iteration, K7, with the M-step finish in PyTorch:
   the batched Jacobi K1 and the chord solve K8): frequency-constant
   weights at any T, and per-bin weights past route 1's gate.
3. **scan**: the plain EM loop, with the inline aligner after each
   E-step when one is given. Its M-step warm-starts the moment inversion
   from the previous model (a cold 50-step solve first, warm 16-step
   solves after it); on the card that solve is K8 and the eigh K1.

``use_fused_em='auto'`` takes routes 1-2 only on the accelerator (CUDA
tensors, :func:`_on_accelerator`), for complex64 (F, N, D) /
(B, F, N, D) input with 2 <= D <= 8, per-bin or frequency-constant
weights and no inline aligner. ``use_fused_em=True`` forces them on any
device (the kernels' plain twins on the CPU) and asserts on knobs they do
not take; ``False`` skips them. The gates are the port's own, from shared
memory; the JAX package's are its VMEM budgets.
"""
from __future__ import annotations

from operator import xor

import numpy as np
import torch

from .._dtypes import real_dtype as _real_dtype
from .._shard import dtensor_entry, dtensor_predict
from ..ops import cbmm_loop, mm_stream
from ..utils import profiling
from ._em import run_em
from .base import Model, modelclass
from .complex_bingham import (
    ComplexBingham,
    ComplexBinghamTrainer,
    normalize_observation,
)
from .mixture_model_utils import (
    estimate_mixture_weight,
    log_pdf_to_affiliation,
    mixture_weight_axis,
)

__all__ = ['CBMM', 'CBMMTrainer']


@modelclass
class CBMM(Model):
    weight: torch.Tensor = None  # (..., K, 1)
    complex_bingham: ComplexBingham = None

    @dtensor_predict()
    def predict(self, y, affiliation_eps=0):
        """y: (..., N, D) complex -> affiliations (..., K, N); a DTensor
        y is predicted block by block (``_shard.dtensor_predict``)."""
        assert y.is_complex(), y.dtype
        return self._predict(normalize_observation(y),
                             affiliation_eps=float(affiliation_eps))

    def _predict(self, y, affiliation_eps=0.):
        """E-step on unit-norm (..., N, D) observations."""
        return log_pdf_to_affiliation(
            self.weight, self.complex_bingham.log_pdf(y[..., None, :, :]),
            source_activity_mask=None, affiliation_eps=affiliation_eps)


def _on_accelerator(y):
    """Do the Bingham EM kernels run for ``y``? (CUDA tensors; the JAX
    package asks ``jax.default_backend() != 'cpu'``.)"""
    return y.device.type == 'cuda'


class CBMMTrainer:
    def __init__(self, dimension=None, max_concentration=np.inf,
                 eigenvalue_eps=1e-8):
        """
        Args:
            dimension: feature dimension (inferred at fit if None).
            max_concentration: bound on the eigenvalue spread.
            eigenvalue_eps: minimum eigenvalue spacing of the scan path
                (the whole-fit kernel takes at least 1e-3, the f32 guard).
        """
        self.dimension = dimension
        self.max_concentration = max_concentration
        self.eigenvalue_eps = eigenvalue_eps

    @profiling.span('em')
    @dtensor_entry(mixture_weight_axis, {'saliency': -2})
    def fit(self, y, initialization=None, num_classes=None, iterations=100,
            *, generator=None, saliency=None, weight_constant_axis=(-1,),
            affiliation_eps=0, inline_permutation_aligner=None,
            use_fused_em='auto', _return_affiliation=False) -> CBMM:
        """EM for CBMMs with any number of independent dimensions.

        Args:
            y: (..., N, D) complex observations; a DTensor with its
                frequency axis (-3) split over a mesh's ``'f'`` axis and
                / or an utterance axis left of it over ``'b'`` (from
                ``parallel.shard_frequencies``,
                ``shard_batch_and_frequencies`` or
                ``shard_batch_from_process_local``) fits each rank's
                block and returns the global model on every rank
                (``_shard.dtensor_entry``).
            initialization: affiliations (..., K, N), or None (then
                ``num_classes`` and ``generator`` draw a random one).
            num_classes: K (exclusive with initialization).
            iterations: number of M-steps.
            generator: ``torch.Generator`` for the random init (default:
                one seeded 0 on y's device).
            saliency: (..., N) importance weights.
            weight_constant_axis: axis/axes averaged for the weight.
            affiliation_eps: clip of the E-step posteriors inside the fit.
            inline_permutation_aligner: an aligner run on each E-step's
                posterior (frequency-constant weights; scan path only).
            use_fused_em: ``'auto'``, True or False — see the module
                docstring.
        """
        profiling.count('em.route.cbmm')
        assert xor(initialization is None, num_classes is None), (
            'Provide either `initialization` or `num_classes` — not both '
            f'and not neither. Got initialization is None: '
            f'{initialization is None}, num_classes is None: '
            f'{num_classes is None}.')
        assert y.is_complex(), y.dtype
        assert y.shape[-1] > 1
        # a (F, D, T) layout mistake puts T in the channel slot
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

        D, T = y.shape[-1], y.shape[-2]
        K = initialization.shape[-2]
        has_sal = saliency is not None
        aligner = inline_permutation_aligner
        per_bin = weight_constant_axis in ((-1,), -1)
        fc = weight_constant_axis in ((-3, -1), (-1, -3))
        whole_fit = per_bin and cbmm_loop.fits(D, K, T, has_sal)
        if use_fused_em == 'auto':
            use_fused_em = (
                _on_accelerator(y) and y.ndim in (3, 4)
                and y.dtype == torch.complex64 and 2 <= D <= 8
                and aligner is None and (per_bin or fc)
                and (whole_fit or mm_stream.fits(D, K, has_sal,
                                                 family='bingham')))
        mc = float(self.max_concentration)
        if use_fused_em:
            # the kernels take only these knobs: anything else would
            # silently fit another model
            assert aligner is None and (per_bin or fc), (
                'use_fused_em=True requires inline_permutation_aligner=None '
                'and weight_constant_axis=(-1,) or (-3, -1); got '
                f'{aligner=}, {weight_constant_axis=}')
            assert y.ndim in (3, 4), y.shape
            y_dt = y.transpose(-2, -1)  # (..., F, D, T)
            if saliency is not None:
                saliency = torch.broadcast_to(
                    torch.as_tensor(saliency, dtype=_real_dtype(y),
                                    device=y.device), (*y.shape[:-2], T))
            init = initialization.to(torch.float32)
            affiliation = None
            if whole_fit:
                weight, eigenvalues, eigenvectors, _, affiliation = \
                    cbmm_loop.cbmm_em_full(
                        y_dt, init, iterations=int(iterations),
                        affiliation_eps=float(affiliation_eps),
                        # 1e-8 is sub-ulp at f32 concentration scale: the
                        # kernel takes at least 1e-3
                        spacing_eps=max(float(self.eigenvalue_eps), 1e-3),
                        saliency=saliency, max_concentration=mc)
                weight = weight[..., None]
            else:
                weight, eigenvalues, eigenvectors = mm_stream.cbmm_em_long(
                    y_dt, init, iterations=int(iterations),
                    max_concentration=mc,
                    spacing_eps=(None if self.eigenvalue_eps is None
                                 else float(self.eigenvalue_eps)),
                    affiliation_eps=float(affiliation_eps),
                    weight_mode='per_bin' if per_bin else 'fc',
                    saliency=saliency)
                # estimate_mixture_weight's keepdims shapes
                weight = weight[..., None] if per_bin \
                    else weight[..., None, :, None]
            model = CBMM(weight=weight, complex_bingham=ComplexBingham(
                covariance_eigenvectors=eigenvectors,
                covariance_eigenvalues=eigenvalues))
            if _return_affiliation:
                if affiliation is None:
                    affiliation = model._predict(y)
                return model, affiliation
            return model

        if saliency is None:
            saliency = torch.ones_like(initialization[..., 0, :])
        else:
            saliency = torch.as_tensor(saliency, device=y.device)
        model = _cbmm_fit_em(
            y, initialization, saliency, iterations=int(iterations),
            weight_constant_axis=weight_constant_axis,
            affiliation_eps=float(affiliation_eps), max_concentration=mc,
            eigenvalue_eps=float(self.eigenvalue_eps), aligner=aligner)
        if _return_affiliation:
            return model, model._predict(y)
        return model

    def fit_predict(self, y, initialization=None, num_classes=None,
                    iterations=100, **kwargs):
        """Fit a model, then return the posterior affiliations (from the
        whole-fit kernel's final unclipped E-step when it runs)."""
        _, affiliation = self.fit(
            y, initialization, num_classes, iterations,
            _return_affiliation=True, **kwargs)
        return affiliation


def _cbmm_fit_em(y, affiliation, saliency, *, iterations,
                 weight_constant_axis, affiliation_eps, max_concentration,
                 eigenvalue_eps, aligner):
    """The scan path: :func:`run_em` with the Bingham M-step (warm-started
    from the previous model) and E-step."""
    trainer = ComplexBinghamTrainer(
        dimension=y.shape[-1], max_concentration=max_concentration,
        eignevalue_eps=eigenvalue_eps)

    def m_step(affiliation, previous_model):
        weight = estimate_mixture_weight(
            affiliation=affiliation, saliency=saliency,
            weight_constant_axis=weight_constant_axis)
        # the moments move little between iterations: 16 warm chord steps
        # from the previous eigenvalues after the first, cold M-step
        complex_bingham = trainer._fit(
            y=y[..., None, :, :],
            saliency=affiliation * saliency[..., None, :],
            warm_start=(None if previous_model is None else
                        previous_model.complex_bingham
                        .covariance_eigenvalues),
            solver_iterations=None if previous_model is None else 16)
        return CBMM(weight=weight, complex_bingham=complex_bingham)

    return run_em(
        affiliation=affiliation, iterations=iterations, m_step=m_step,
        e_step=lambda model: model._predict(
            y, affiliation_eps=affiliation_eps),
        aligner=aligner, weight_constant_axis=weight_constant_axis)
