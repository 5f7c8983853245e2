"""cACGMM — the flagship spatial mixture model.

Counterpart of ``pb_bss_tpu.models.cacgmm`` for the separation slice:
the model (predict), the plain EM loop (``_m_step`` /
``_fit_em``, a Python loop over iterations) and the trainer with the
JAX package's routing between the plain loop and the whole-fit kernel
(:func:`pb_bss_tpu_torch.ops.em_loop.cacgmm_em_full`).

Routing of ``CACGMMTrainer.fit`` (mirrors the JAX package):

* CPU tensors, ``use_fused_em='auto'``: the plain loop.
* CUDA tensors, ``'auto'``: the whole-fit kernel for complex64
  (F, N, D) / (B, F, N, D) input with per-bin weights, the standard
  knobs, D <= 16 and T inside the kernel's gate
  (:func:`~pb_bss_tpu_torch.ops.em_loop.fits`). Shapes the JAX package
  sends to its other EM kernels (frequency-constant weights: K5, T past
  the gate: K4) raise ``NotImplementedError`` until those are ported.
* ``use_fused_em=False``: the plain loop (on CUDA its eigh then meets
  the K1 guard of :func:`pb_bss_tpu_torch.ops.linalg.eigh`).
* ``use_fused_em=True``: the whole-fit route on any device (its plain
  twin on the CPU).
"""
from __future__ import annotations

from operator import xor

import numpy as np
import torch

from .._dtypes import real_dtype as _real_dtype
from ..ops import em_loop
from .base import Model, modelclass
from .complex_angular_central_gaussian import (
    ComplexAngularCentralGaussian,
    ComplexAngularCentralGaussianTrainer,
    normalize_observation,
)
from .mixture_model_utils import (
    estimate_mixture_weight,
    log_pdf_to_affiliation,
)

__all__ = ['CACGMM', 'CACGMMTrainer']

_ROADMAP = 'ROADMAP queue 2'


@modelclass
class CACGMM(Model):
    weight: torch.Tensor = None  # (..., K, 1)
    cacg: ComplexAngularCentralGaussian = None

    def predict(self, y, return_quadratic_form=False,
                source_activity_mask=None):
        """y: (..., N, D) complex observations -> affiliation
        (..., K, N)."""
        assert y.is_complex(), y.dtype
        affiliation, quadratic_form, _ = self._predict(
            normalize_observation(y),
            source_activity_mask=source_activity_mask)
        if return_quadratic_form:
            return affiliation, quadratic_form
        return affiliation

    def _predict(self, y, source_activity_mask=None, affiliation_eps=0.):
        """E-step; y in time-last layout (..., D, N). Returns
        (affiliation (..., K, N), quadratic_form, log_pdf)."""
        log_pdf, quadratic_form = self.cacg._log_pdf(y[..., None, :, :])
        affiliation = log_pdf_to_affiliation(
            self.weight, log_pdf,
            source_activity_mask=source_activity_mask,
            affiliation_eps=affiliation_eps)
        return affiliation, quadratic_form, log_pdf


def _m_step(y, quadratic_form, affiliation, saliency, *, hermitize,
            covariance_norm, eigenvalue_floor, weight_constant_axis,
            eigh_sweeps=None, eigh_method='auto'):
    weight = estimate_mixture_weight(
        affiliation=affiliation, saliency=saliency,
        weight_constant_axis=weight_constant_axis)
    if saliency is None:
        masked_affiliation = affiliation
    else:
        masked_affiliation = affiliation * saliency[..., None, :]
    cacg = ComplexAngularCentralGaussianTrainer()._fit(
        y=y[..., None, :, :], saliency=masked_affiliation,
        quadratic_form=quadratic_form, hermitize=hermitize,
        covariance_norm=covariance_norm, eigenvalue_floor=eigenvalue_floor,
        eigh_sweeps=eigh_sweeps, eigh_method=eigh_method)
    return CACGMM(weight=weight, cacg=cacg)


def _fit_em(y, model, affiliation, quadratic_form, saliency,
            source_activity_mask, *, iterations, weight_constant_axis,
            hermitize, covariance_norm, eigenvalue_floor, affiliation_eps,
            first_e_step, eigh_sweeps=None):
    """The plain EM loop. Without ``first_e_step`` it starts from the
    given affiliations with one M-step; otherwise from ``model`` with
    an E-step."""
    def m_step(aff, qf):
        return _m_step(
            y, qf, aff, saliency, hermitize=hermitize,
            covariance_norm=covariance_norm,
            eigenvalue_floor=eigenvalue_floor,
            weight_constant_axis=weight_constant_axis,
            eigh_sweeps=eigh_sweeps)

    if not first_e_step:
        model = m_step(affiliation, quadratic_form)
        n_steps = iterations - 1
    else:
        n_steps = iterations
    for _ in range(n_steps):
        affiliation, quadratic_form, _ = model._predict(
            y, source_activity_mask=source_activity_mask,
            affiliation_eps=affiliation_eps)
        model = m_step(affiliation, quadratic_form)
    return model


def _per_bin_knobs(aligner, weight_constant_axis, hermitize,
                   covariance_norm):
    """Knobs the whole-fit kernel implements."""
    return (aligner is None and weight_constant_axis in ((-1,), -1)
            and hermitize and covariance_norm == 'eigenvalue')


def _fc_knobs(aligner, weight_constant_axis, hermitize, covariance_norm):
    """Knobs of the JAX package's frequency-constant-weight EM kernel
    (K5, not ported yet)."""
    return (weight_constant_axis in ((-3, -1), (-1, -3))
            and hermitize and covariance_norm == 'eigenvalue')


def _fit_fused(y, model, affiliation, quadratic_form, *, iterations,
               eigenvalue_floor, affiliation_eps, eigh_sweeps,
               saliency=None, source_activity_mask=None,
               return_affiliation=False):
    """Whole-fit route: ONE kernel launch runs every EM iteration; its
    final (unclipped) E-step equals ``model.predict(y)``."""
    if model is not None:
        affiliation, quadratic_form, _ = model._predict(
            y, source_activity_mask=source_activity_mask,
            affiliation_eps=affiliation_eps)
    D = y.shape[-2]
    sweeps = eigh_sweeps if eigh_sweeps is not None else (
        6 if D <= 8 else 8)
    weight, eigenvalues, eigenvectors, affiliation = em_loop.cacgmm_em_full(
        y, affiliation, quadratic_form, iterations=iterations,
        sweeps=sweeps,
        # warm-started Jacobi: the scatter changes slowly, 2 sweeps from
        # the previous eigenbasis suffice (iteration 0 stays cold)
        warm_sweeps=2, eigenvalue_floor=eigenvalue_floor,
        affiliation_eps=affiliation_eps, saliency=saliency,
        source_activity_mask=source_activity_mask)
    fitted = CACGMM(
        weight=weight[..., None],
        cacg=ComplexAngularCentralGaussian(
            covariance_eigenvectors=eigenvectors,
            covariance_eigenvalues=eigenvalues))
    if return_affiliation:
        return fitted, affiliation
    return fitted


class CACGMMTrainer:
    def fit(self, y, initialization=None, num_classes=None, iterations=100,
            *, generator=None, saliency=None, source_activity_mask=None,
            weight_constant_axis=(-1,), hermitize=True,
            covariance_norm='eigenvalue', affiliation_eps=1e-10,
            eigenvalue_floor=1e-10, inline_permutation_aligner=None,
            use_pallas_em=False, use_fused_em='auto', eigh_sweeps=None,
            t_block='auto', _return_affiliation=False) -> CACGMM:
        """Fit a cACGMM with EM.

        Args:
            y: (..., N, D) complex observations.
            initialization: affiliations (..., K, N), a CACGMM, or None
                (then ``num_classes`` + ``generator`` drive a random
                init).
            num_classes: K (exclusive with initialization).
            iterations: number of M-steps.
            generator: ``torch.Generator`` for the random init (default:
                one seeded 0 on y's device).
            saliency: (..., N) importance weights.
            source_activity_mask: bool (..., K, N).
            weight_constant_axis: axis/axes averaged for the weight.
            use_fused_em: ``'auto'``, True or False — see the module
                docstring for the routing.
            eigh_sweeps: Jacobi sweeps of the EM eigendecomposition.
            use_pallas_em / inline_permutation_aligner / t_block: JAX
                knobs whose code paths are not ported yet; a non-default
                value raises ``NotImplementedError``.
        """
        assert xor(initialization is None, num_classes is None), (
            'Provide either `initialization` or `num_classes` — not '
            'both and not neither.')
        if use_pallas_em:
            raise NotImplementedError(
                'use_pallas_em (the JAX E-step kernels pallas_em.'
                f'cacgmm_e_step / cacgmm_em_scatter, {_ROADMAP} K11) is '
                'not ported yet')
        if inline_permutation_aligner is not None:
            raise NotImplementedError(
                'the inline permutation aligner is not ported yet '
                '(ROADMAP queue 1, the cACGMM slice)')
        if t_block not in ('auto', None):
            raise NotImplementedError(
                'the time-blocked EM is not ported yet (ROADMAP queue 1, '
                'the cACGMM slice)')
        assert y.is_complex(), y.dtype
        assert y.shape[-1] > 1, y.shape
        assert iterations > 0, iterations
        y = normalize_observation(y)  # (..., D, N)
        *independent, D, num_observations = y.shape
        rdtype = _real_dtype(y)

        model = None
        affiliation = None
        quadratic_form = None
        if initialization is None:
            if generator is None:
                generator = torch.Generator(device=y.device).manual_seed(0)
            shape = (*independent, num_classes, num_observations)
            affiliation = torch.rand(
                shape, generator=generator, dtype=rdtype, device=y.device)
            affiliation = affiliation / affiliation.sum(-2, keepdim=True)
            quadratic_form = torch.ones(shape, dtype=rdtype, device=y.device)
        elif isinstance(initialization, CACGMM):
            num_classes = \
                initialization.cacg.covariance_eigenvectors.shape[-3]
            model = initialization
        elif isinstance(initialization, (np.ndarray, torch.Tensor)):
            initialization = torch.as_tensor(initialization, device=y.device)
            num_classes = initialization.shape[-2]
            assert num_classes > 1, num_classes
            shape = (*independent, num_classes, num_observations)
            assert initialization.ndim == len(shape), (
                initialization.shape, shape)
            affiliation = torch.broadcast_to(
                initialization.to(rdtype), shape)
            quadratic_form = torch.ones(shape, dtype=rdtype, device=y.device)
        else:
            raise TypeError('No sufficient initialization.')

        if isinstance(weight_constant_axis, list):
            weight_constant_axis = tuple(weight_constant_axis)
        if source_activity_mask is not None:
            source_activity_mask = torch.as_tensor(
                source_activity_mask, device=y.device)
            assert source_activity_mask.dtype == torch.bool, \
                source_activity_mask.dtype
        assert num_classes < 20, f'num_classes: {num_classes}, sure?'
        assert D < 35, f'Channels: {D}, sure?'

        per_bin = _per_bin_knobs(
            inline_permutation_aligner, weight_constant_axis, hermitize,
            covariance_norm)
        fc = _fc_knobs(
            inline_permutation_aligner, weight_constant_axis, hermitize,
            covariance_norm)
        if use_fused_em == 'auto':
            use_fused_em = (
                y.device.type == 'cuda' and y.dtype == torch.complex64
                and y.ndim in (3, 4) and D <= 16 and (per_bin or fc))
        if use_fused_em:
            assert y.ndim in (3, 4), (
                'use_fused_em requires (F, N, D) or (B, F, N, D) '
                'observations', y.shape)
            if per_bin and em_loop.fits(D, num_classes, num_observations):
                return _fit_fused(
                    y, model, affiliation, quadratic_form,
                    iterations=int(iterations),
                    eigenvalue_floor=float(eigenvalue_floor),
                    affiliation_eps=float(affiliation_eps),
                    eigh_sweeps=eigh_sweeps, saliency=saliency,
                    source_activity_mask=source_activity_mask,
                    return_affiliation=_return_affiliation)
            if fc:
                raise NotImplementedError(
                    'frequency-constant mixture weights run on the JAX '
                    'per-iteration EM kernel pallas_em_step.cacgmm_em_fc '
                    f'({_ROADMAP} K5), which is not ported to CUDA yet')
            if per_bin:
                raise NotImplementedError(
                    f'T={num_observations} is past the whole-fit kernel '
                    f'gate (T <= {em_loop.max_frames(D, num_classes)} at '
                    f'D={D}, K={num_classes}); the JAX package streams '
                    'such signals through pallas_em_stream.cacgmm_em_long '
                    f'({_ROADMAP} K4), which is not ported to CUDA yet')
            raise AssertionError(
                'use_fused_em=True requires weight_constant_axis=(-1,), '
                "hermitize=True and covariance_norm='eigenvalue'")

        fitted = _fit_em(
            y, model, affiliation, quadratic_form, saliency,
            source_activity_mask, iterations=int(iterations),
            weight_constant_axis=weight_constant_axis,
            hermitize=bool(hermitize), covariance_norm=covariance_norm,
            eigenvalue_floor=float(eigenvalue_floor),
            affiliation_eps=float(affiliation_eps),
            first_e_step=model is not None, eigh_sweeps=eigh_sweeps)
        if _return_affiliation:
            affiliation, _, _ = fitted._predict(
                y, source_activity_mask=source_activity_mask)
            return fitted, affiliation
        return fitted

    def fit_predict(self, y, initialization=None, num_classes=None,
                    iterations=100, **kwargs):
        """Fit, then return the posterior affiliations for ``y`` (from
        the kernel's final E-step on the whole-fit route)."""
        _, affiliation = self.fit(
            y, initialization, num_classes, iterations,
            _return_affiliation=True, **kwargs)
        return affiliation

    def fit_predict_model(self, *args, **kwargs):
        """Like :meth:`fit_predict` but returns ``(model,
        affiliation)``."""
        return self.fit(*args, _return_affiliation=True, **kwargs)
