"""cACGMM — the flagship spatial mixture model.

Counterpart of ``pb_bss_tpu.models.cacgmm``: the model (predict), the
plain EM loop (``_m_step`` / ``_fit_em``, a Python loop over
iterations), the time-blocked EM for long signals
(``_fit_em_t_blocked``) and the trainer with the JAX package's routing
between them and the EM kernels.

Routing of ``CACGMMTrainer.fit`` (decision for decision the JAX
package's, ``pb_bss_tpu/models/cacgmm.py:894-1036``):

1. **whole fit** (:func:`pb_bss_tpu_torch.ops.em_loop.cacgmm_em_full`,
   one launch): per-bin weights and the standard knobs, saliency and
   source-activity masks included, T inside the kernel's gate
   (:func:`~pb_bss_tpu_torch.ops.em_loop.fits`, which those two extras
   shrink).
2. **frequency-constant weights** (``weight_constant_axis=(-3, -1)``,
   :func:`pb_bss_tpu_torch.ops.em_step.cacgmm_em_fc`, one launch per
   iteration) inside its own gate
   (:func:`~pb_bss_tpu_torch.ops.em_step.fits`); it hosts the inline
   permutation aligner between launches for unbatched input.
3. **streamed** (:func:`pb_bss_tpu_torch.ops.em_stream.cacgmm_em_long`,
   one statistics launch per iteration, no T limit): either weight mode
   past the gates, saliency and source-activity masks included, no
   aligner.
4. **time-blocked** (``_fit_em_t_blocked``): standard knobs with
   ``t_block`` an int, or ``'auto'`` past ``T_BLOCK_AUTO_THRESHOLD``
   frames when no kernel route is taken.
5. **scan**: the plain loop (its eigh launches the batched Jacobi
   kernel on CUDA, :mod:`pb_bss_tpu_torch.ops.eigh`), with the inline
   aligner after each E-step when one is given. Under
   ``use_pallas_em=True`` each E-step and scatter after the first
   M-step is one launch of the scatter kernel
   (:func:`pb_bss_tpu_torch.ops.em_estep.em_scatter_model`, which reads
   the complex observations and eigenvectors as they are).

``use_fused_em='auto'`` takes routes 1-3 only on the accelerator (CUDA
tensors, :func:`_on_accelerator`), for complex64 (F, N, D) /
(B, F, N, D) input with D <= 16, under the JAX eligibility predicates,
and never with ``use_pallas_em``; a frequency-constant fit resumed from
a model with per-bin weights stays on the scan path, and so does a fit
with an aligner past route 2's gate. ``use_fused_em=True`` forces
routes 1-3 on any device (the kernels' plain twins on the CPU);
``False`` skips them.
"""
from __future__ import annotations

from operator import xor

import numpy as np
import torch

from .._dtypes import real_dtype as _real_dtype, tiny as _tiny
from ..ops import em_estep, em_loop, em_step, em_stream
from .base import Model, force_hermitian, modelclass
from .complex_angular_central_gaussian import (
    ComplexAngularCentralGaussian,
    ComplexAngularCentralGaussianTrainer,
    normalize_observation,
    sample_complex_angular_central_gaussian,
)
from .mixture_model_utils import (
    apply_inline_permutation_alignment,
    estimate_mixture_weight,
    log_pdf_to_affiliation,
)
from ._precision import full_fp32

__all__ = ['CACGMM', 'CACGMMTrainer', 'sample_cacgmm']

T_BLOCK_AUTO_THRESHOLD = 8192
T_BLOCK_AUTO = 2048


def sample_cacgmm(size, weight, covariance, return_label=False,
                  generator=None):
    """Draw ``size`` samples of a cACG mixture.

    Args:
        size: int, the number of samples.
        weight: (K,) class probabilities.
        covariance: (K, D, D) class covariances.
        return_label: also return the (size,) class labels.
        generator: ``torch.Generator`` (default: one seeded 0 on the
            covariance's device); it draws the labels, then each class's
            samples in class order.
    Returns:
        (size, D) complex samples (and the labels).
    """
    weight = np.asarray(weight)
    assert weight.ndim == 1, weight
    assert isinstance(size, int), size
    covariance = torch.as_tensor(covariance)
    assert covariance.ndim == 3, covariance.shape
    num_classes, = weight.shape
    D = covariance.shape[-1]
    assert covariance.shape == (num_classes, D, D), (
        covariance.shape, num_classes, D)
    device = covariance.device
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    labels = torch.multinomial(
        torch.as_tensor(weight, dtype=torch.float64, device=device), size,
        replacement=True, generator=generator)
    # every class for every slot, selected by label (as the JAX package)
    samples = torch.stack([
        sample_complex_angular_central_gaussian(
            (size,),
            ComplexAngularCentralGaussian.from_covariance(
                covariance=covariance[k]).covariance,
            generator=generator)
        for k in range(num_classes)])  # (K, size, D)
    x = samples[labels, torch.arange(size, device=device)]
    if return_label:
        return x, labels
    return x


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

    def log_likelihood(self, y):
        """Sum over all leading dims and samples of the log-sum-exp of
        the class log-pdfs (the weights do not enter, as in the JAX
        package). y: (..., N, D) complex."""
        assert y.is_complex(), y.dtype
        _, _, log_pdf = self._predict(normalize_observation(y))
        return torch.logsumexp(log_pdf, dim=-2).sum()

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
            first_e_step, aligner=None, use_pallas_em=False,
            eigh_sweeps=None):
    """The plain EM loop. Without ``first_e_step`` it starts from the
    given affiliations with one M-step; otherwise from ``model`` with
    an E-step. An inline ``aligner`` permutes each E-step's posterior
    and quadratic forms before the M-step. ``use_pallas_em`` runs each
    E-step and scatter as one launch of
    :func:`pb_bss_tpu_torch.ops.em_estep.em_scatter_model` (unbatched
    input, no saliency, mask or aligner, per-bin weights; checked by
    the caller)."""
    def m_step(aff, qf):
        return _m_step(
            y, qf, aff, saliency, hermitize=hermitize,
            covariance_norm=covariance_norm,
            eigenvalue_floor=eigenvalue_floor,
            weight_constant_axis=weight_constant_axis,
            eigh_sweeps=eigh_sweeps)

    def e_then_m(model):
        aff, qf, _ = model._predict(
            y, source_activity_mask=source_activity_mask,
            affiliation_eps=affiliation_eps)
        if aligner is not None:
            aff, qf = apply_inline_permutation_alignment(
                aff, quadratic_form=qf,
                weight_constant_axis=weight_constant_axis, aligner=aligner)
        return m_step(aff, qf)

    def e_then_m_fused(model):
        # the E-step and scatter in one launch; the (F, K, T) posterior
        # never reaches device memory, and the kernel reads y and the
        # complex eigenvectors as they are
        cacg = model.cacg
        weight = torch.broadcast_to(
            model.weight[..., 0], (F, model.weight.shape[-2]))
        s_re, s_im, aff_sum = em_estep.em_scatter_model(
            y_c, cacg.covariance_eigenvectors,
            1.0 / cacg.covariance_eigenvalues, cacg.log_determinant, weight)
        covariance = torch.complex(s_re, s_im) / torch.clamp(
            aff_sum, min=_tiny(s_re))[..., None, None]
        if hermitize:
            covariance = force_hermitian(covariance)
        return CACGMM(
            weight=(aff_sum / T)[..., None],
            cacg=ComplexAngularCentralGaussian.from_covariance(
                covariance, eigenvalue_floor=eigenvalue_floor,
                covariance_norm=covariance_norm, eigh_sweeps=eigh_sweeps))

    step = e_then_m
    if use_pallas_em:
        F, D, T = y.shape
        y_c = y.contiguous()
        step = e_then_m_fused

    if not first_e_step:
        model = m_step(affiliation, quadratic_form)
        n_steps = iterations - 1
    else:
        n_steps = iterations
    for _ in range(n_steps):
        model = step(model)
    return model


def _t_blocks(x, t_block, pad_value=0.0):
    """(..., C, T) -> (nb, ..., C, t_block) leading-block layout, the
    tail padded with ``pad_value``."""
    T = x.shape[-1]
    nb = -(-T // t_block)
    x = torch.nn.functional.pad(x, (0, nb * t_block - T), value=pad_value)
    x = x.reshape(*x.shape[:-1], nb, t_block)
    return x.movedim(-2, 0)


def _fit_em_t_blocked(y, model, affiliation, quadratic_form, *, iterations,
                      eigenvalue_floor, affiliation_eps, first_e_step,
                      eigh_sweeps, t_block):
    """EM with the time axis processed in blocks.

    The scan path's E-step materializes the projection ``V^H y`` of
    shape (..., K, D, T). Here each EM iteration is a loop over
    T-blocks whose body computes the block's posterior from the current
    parameters and folds it straight into the M-step accumulators
    (scatter (..., K, D, D) and affiliation sums (..., K)): neither the
    (..., K, T) posterior nor the (..., K, D, T) projection exists at
    full length, so the working set is O(F K D^2 + F D t_block)
    whatever T. The scan path's operations in its order; only the
    summation order differs.

    Standard knobs only (no saliency, mask or aligner,
    ``weight_constant_axis=-1``, hermitize, eigenvalue norm); the
    caller checks them.
    """
    D, T = y.shape[-2:]
    rdtype = _real_dtype(y)
    y_blocks = _t_blocks(y, t_block)  # (nb, ..., D, tb)
    nb = y_blocks.shape[0]
    # zero weight for the padded tail frames
    valid_blocks = (torch.arange(nb * t_block, device=y.device) < T).to(
        rdtype).reshape(nb, t_block)

    def block_stats(aff, qf, y_block):
        """M-step contribution of one block (the cACG trainer's
        weighting w = affiliation / quadratic_form)."""
        w = aff / torch.clamp(qf, min=10 * _tiny(qf))
        yw = y_block[..., None, :, :] * w[..., None, :].to(y.dtype)
        with full_fp32():
            scatter = yw @ y_block[..., None, :, :].conj().transpose(-1, -2)
        return scatter, aff.sum(-1)

    def m_from_stats(scatter, aff_sum):
        covariance = D * scatter / torch.clamp(
            aff_sum, min=_tiny(aff_sum))[..., None, None].to(scatter.dtype)
        cacg = ComplexAngularCentralGaussian.from_covariance(
            force_hermitian(covariance), eigenvalue_floor=eigenvalue_floor,
            covariance_norm='eigenvalue', eigh_sweeps=eigh_sweeps)
        return CACGMM(weight=(aff_sum / T)[..., None], cacg=cacg)

    if not first_e_step:
        # first M-step from the initialization; padded affiliations are
        # zero and padded quadratic forms one, so the tail adds nothing
        aff_blocks = _t_blocks(affiliation, t_block)
        qf_blocks = _t_blocks(quadratic_form, t_block, pad_value=1.0)
        scatter = aff_sum = 0
        for i in range(nb):
            s, n = block_stats(aff_blocks[i], qf_blocks[i], y_blocks[i])
            scatter, aff_sum = scatter + s, aff_sum + n
        model = m_from_stats(scatter, aff_sum)
        n_steps = iterations - 1
    else:
        n_steps = iterations

    for _ in range(n_steps):
        scatter = aff_sum = 0
        for i in range(nb):
            aff, qf, _ = model._predict(
                y_blocks[i], affiliation_eps=affiliation_eps)
            aff = aff * valid_blocks[i]  # zero the padded tail columns
            s, n = block_stats(aff, qf, y_blocks[i])
            scatter, aff_sum = scatter + s, aff_sum + n
        model = m_from_stats(scatter, aff_sum)
    return model


def _predict_time_last_blocked(model, y, *, t_block):
    """Blocked final E-step (predict semantics): the (..., K, D, T)
    projection only ever exists per block; returns the full (..., K, T)
    affiliation."""
    T = y.shape[-1]
    blocks = [model._predict(y_block)[0]
              for y_block in _t_blocks(y, t_block)]
    return torch.cat(blocks, dim=-1)[..., :T]


def _on_accelerator(y):
    """Do the EM kernels run for ``y``? (CUDA tensors; the JAX package
    asks ``jax.default_backend() != 'cpu'``.)"""
    return y.device.type == 'cuda'


def _per_bin_knobs(aligner, weight_constant_axis, hermitize,
                   covariance_norm):
    """Knobs the whole-fit and the per-bin streamed kernels implement."""
    return (aligner is None and weight_constant_axis in ((-1,), -1)
            and hermitize and covariance_norm == 'eigenvalue')


def _fc_knobs(aligner, weight_constant_axis, hermitize, covariance_norm,
              *, allow_aligner=False):
    """Knobs of the frequency-constant-weight kernels (the per-iteration
    kernels of :mod:`~pb_bss_tpu_torch.ops.em_step` and the streamed
    kernel's 'fc' mode). Only the per-iteration route hosts an inline
    aligner (``allow_aligner``, unbatched input); the streamed one does
    not."""
    return ((aligner is None or allow_aligner)
            and weight_constant_axis in ((-3, -1), (-1, -3))
            and hermitize and covariance_norm == 'eigenvalue')


def _fc_init_weight(model, y_ndim):
    """The global per-class weight of a model for a frequency-constant
    resume: (K,) (or (B, K) / (1, K) for batched input) when the
    model's weight is frequency-constant, else None (per-bin weights
    stay on the scan path)."""
    w = torch.as_tensor(model.weight)
    if w.ndim < 2 or w.shape[-1] != 1:
        return None
    squeezed = w[..., 0]  # drop the T axis
    lead = squeezed.shape[:-1]
    if y_ndim == 4:
        if all(n == 1 for n in lead):  # (K,), (1, K), (1, 1, K)
            return squeezed.reshape(1, -1)  # broadcast over B
        if len(lead) == 2 and lead[-1] == 1:
            return squeezed[:, 0, :]  # (B, 1, K) -> (B, K)
        return None
    if all(n == 1 for n in lead):
        return squeezed.reshape(-1)  # (K,)
    return None


def _fused_em_eligible(y, num_classes, aligner, weight_constant_axis,
                       hermitize, covariance_norm, has_sal=False,
                       has_mask=False):
    """Route the fit to the whole-fit kernel? Saliency and the
    source-activity mask live in its shared memory, so they shrink its
    gate (the JAX package's ``choose_tile_f(has_sal, has_mask)``)."""
    return (_on_accelerator(y) and y.ndim in (3, 4)
            and y.dtype == torch.complex64
            and _per_bin_knobs(aligner, weight_constant_axis, hermitize,
                               covariance_norm)
            and em_loop.fits(y.shape[-2], num_classes, y.shape[-1],
                             has_sal, has_mask))


def _fused_em_fc_eligible(y, num_classes, aligner, weight_constant_axis,
                          hermitize, covariance_norm, model):
    """Route the fit to the frequency-constant per-iteration kernels?
    A model init must carry a frequency-constant weight; an inline
    aligner is hosted for unbatched input."""
    return (_on_accelerator(y) and y.ndim in (3, 4)
            and y.dtype == torch.complex64
            and _fc_knobs(aligner, weight_constant_axis, hermitize,
                          covariance_norm, allow_aligner=y.ndim == 3)
            and (model is None or _fc_init_weight(model, y.ndim) is not None)
            and em_step.fits(y.shape[-2], num_classes, y.shape[-1]))


def _stream_feasible(y, num_classes):
    """Shape feasibility of the streamed kernel (saliency and the mask
    do not change its budget)."""
    return y.ndim in (3, 4) and em_stream.fits(y.shape[-2], num_classes)


def _fused_em_stream_eligible(y, num_classes, aligner, weight_constant_axis,
                              hermitize, covariance_norm, model):
    """Route long signals to the streamed kernel when the whole-fit
    kernels cannot take them?"""
    per_bin = _per_bin_knobs(
        aligner, weight_constant_axis, hermitize, covariance_norm)
    fc = _fc_knobs(aligner, weight_constant_axis, hermitize,
                   covariance_norm)
    return (_on_accelerator(y) and y.dtype == torch.complex64
            and (per_bin or fc)
            and (not fc or model is None
                 or _fc_init_weight(model, y.ndim) is not None)
            and _stream_feasible(y, num_classes))


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


def _fit_fused_fc(y, model, affiliation, quadratic_form, *, iterations,
                  eigenvalue_floor, affiliation_eps, eigh_sweeps,
                  saliency=None, source_activity_mask=None,
                  return_affiliation=False, aligner=None):
    """Frequency-constant-weight route: one kernel launch per EM
    iteration (E-step, M-statistics, warm Jacobi), the global weight
    reduced over bins between launches, and the inline aligner there
    too (:func:`pb_bss_tpu_torch.ops.em_step.cacgmm_em_fc`)."""
    rdtype = _real_dtype(y)
    *independent, D, T = y.shape
    K = (affiliation.shape[-2] if affiliation is not None
         else model.weight.shape[-2])
    if saliency is not None:
        saliency = torch.broadcast_to(
            torch.as_tensor(saliency, dtype=rdtype, device=y.device),
            (*independent, T))
    if source_activity_mask is not None:
        source_activity_mask = torch.broadcast_to(
            source_activity_mask.to(rdtype), (*independent, K, T))
    common = dict(
        iterations=int(iterations),
        sweeps=eigh_sweeps if eigh_sweeps is not None else (
            6 if D <= 8 else 8),
        warm_sweeps=2, eigenvalue_floor=float(eigenvalue_floor),
        affiliation_eps=float(affiliation_eps), saliency=saliency,
        source_activity_mask=source_activity_mask, aligner=aligner)
    if model is not None:
        w, eigenvalues, eigenvectors = em_step.cacgmm_em_fc(
            y, None, None, first_e_step=True,
            init_weight=_fc_init_weight(model, y.ndim),
            init_eigenvalues=model.cacg.covariance_eigenvalues,
            init_eigenvectors=model.cacg.covariance_eigenvectors, **common)
    else:
        w, eigenvalues, eigenvectors = em_step.cacgmm_em_fc(
            y, affiliation, quadratic_form, **common)
    fitted = CACGMM(
        weight=w[..., None, :, None],  # estimate_mixture_weight's shape
        cacg=ComplexAngularCentralGaussian(
            covariance_eigenvectors=eigenvectors,
            covariance_eigenvalues=eigenvalues))
    if return_affiliation:
        affiliation, _, _ = fitted._predict(
            y, source_activity_mask=source_activity_mask)
        return fitted, affiliation
    return fitted


def _fit_fused_stream(y, model, affiliation, quadratic_form, *,
                      iterations, eigenvalue_floor, affiliation_eps,
                      eigh_sweeps, weight_mode, saliency=None,
                      source_activity_mask=None,
                      return_affiliation=False):
    """Long-T route: one streamed statistics launch per EM iteration
    (the posterior never materialized), M-step finish in PyTorch
    (:func:`pb_bss_tpu_torch.ops.em_stream.cacgmm_em_long`)."""
    rdtype = _real_dtype(y)
    *independent, D, T = y.shape
    K = (affiliation.shape[-2] if affiliation is not None
         else model.weight.shape[-2])
    if saliency is not None:
        saliency = torch.broadcast_to(
            torch.as_tensor(saliency, dtype=rdtype, device=y.device),
            (*independent, T))
    if source_activity_mask is not None:
        source_activity_mask = torch.broadcast_to(
            source_activity_mask.to(rdtype), (*independent, K, T))
    common = dict(
        iterations=int(iterations), sweeps=eigh_sweeps,
        eigenvalue_floor=float(eigenvalue_floor),
        affiliation_eps=float(affiliation_eps), weight_mode=weight_mode,
        saliency=saliency, source_activity_mask=source_activity_mask)
    if model is not None:
        if weight_mode == 'per_bin':
            init_weight = torch.broadcast_to(
                torch.as_tensor(model.weight)[..., 0], (*independent, K))
        else:
            init_weight = _fc_init_weight(model, y.ndim)
        w, eigenvalues, eigenvectors = em_stream.cacgmm_em_long(
            y, None, None, first_e_step=True, init_weight=init_weight,
            init_eigenvalues=model.cacg.covariance_eigenvalues,
            init_eigenvectors=model.cacg.covariance_eigenvectors, **common)
    else:
        w, eigenvalues, eigenvectors = em_stream.cacgmm_em_long(
            y, affiliation, quadratic_form, **common)
    if weight_mode == 'per_bin':
        weight = w[..., None]  # (..., F, K, 1)
    else:
        weight = w[..., None, :, None]  # estimate_mixture_weight's shape
    fitted = CACGMM(
        weight=weight,
        cacg=ComplexAngularCentralGaussian(
            covariance_eigenvectors=eigenvectors,
            covariance_eigenvalues=eigenvalues))
    if return_affiliation:
        if source_activity_mask is None and T > T_BLOCK_AUTO:
            affiliation = _predict_time_last_blocked(
                fitted, y, t_block=T_BLOCK_AUTO)
        else:
            affiliation, _, _ = fitted._predict(
                y, source_activity_mask=source_activity_mask)
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
            t_block: time-blocked EM for long signals: each iteration
                loops over T-blocks and folds posteriors straight into
                the M-step accumulators. ``'auto'`` (default) enables it
                with block ``T_BLOCK_AUTO`` for T >
                ``T_BLOCK_AUTO_THRESHOLD`` when no kernel route is taken
                and the knobs are standard; an int forces that block
                length; ``None`` disables.
            inline_permutation_aligner: an aligner of
                :mod:`pb_bss_tpu_torch.permutation_alignment` run on each
                E-step's posterior before the M-step (frequency-constant
                weights only).
            use_pallas_em: run each E-step and M-step scatter as one
                launch of the E-step kernel
                (:func:`pb_bss_tpu_torch.ops.em_estep.cacgmm_em_scatter`);
                requires (F, N, D) input without saliency, mask or
                aligner, per-bin weights and ``affiliation_eps <= 1e-9``.
        """
        assert xor(initialization is None, num_classes is None), (
            'Provide either `initialization` or `num_classes` — not '
            'both and not neither.')
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
            assert tuple(initialization.shape[-2:]) == shape[-2:], (
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
            assert tuple(source_activity_mask.shape[-2:]) == (
                num_classes, num_observations), (
                source_activity_mask.shape, independent, num_classes,
                num_observations)
        assert num_classes < 20, f'num_classes: {num_classes}, sure?'
        assert D < 35, f'Channels: {D}, sure?'

        aligner = inline_permutation_aligner
        knobs = (aligner, weight_constant_axis, hermitize, covariance_norm)
        per_bin = _per_bin_knobs(*knobs)
        fc = _fc_knobs(*knobs, allow_aligner=y.ndim == 3)
        extras = dict(has_sal=saliency is not None,
                      has_mask=source_activity_mask is not None)
        if use_fused_em == 'auto':
            use_fused_em = not use_pallas_em and (
                _fused_em_eligible(y, num_classes, *knobs, **extras)
                or _fused_em_fc_eligible(y, num_classes, *knobs, model)
                or _fused_em_stream_eligible(y, num_classes, *knobs, model))
        if use_fused_em:
            assert y.ndim in (3, 4), (
                'use_fused_em requires (F, N, D) or (B, F, N, D) '
                'observations', y.shape)
            assert per_bin or fc, (
                'use_fused_em=True requires weight_constant_axis=(-1,) or '
                "(-3, -1), hermitize=True and covariance_norm='eigenvalue' "
                '(an inline aligner is supported only with (-3, -1) and '
                f'unbatched (F, N, D) input); got {aligner=}, '
                f'{weight_constant_axis=}, {hermitize=}, {covariance_norm=}')
            fused_kwargs = dict(
                iterations=int(iterations),
                eigenvalue_floor=float(eigenvalue_floor),
                affiliation_eps=float(affiliation_eps),
                eigh_sweeps=None if eigh_sweeps is None else int(eigh_sweeps),
                saliency=saliency,
                source_activity_mask=source_activity_mask,
                return_affiliation=_return_affiliation)
            fc_init_ok = (model is None
                          or _fc_init_weight(model, y.ndim) is not None)
            if per_bin and em_loop.fits(D, num_classes, num_observations,
                                        **extras):
                # short T: the whole fit in one kernel launch
                return _fit_fused(y, model, affiliation, quadratic_form,
                                  **fused_kwargs)
            if (fc and fc_init_ok
                    and em_step.fits(D, num_classes, num_observations)):
                # frequency-constant weights: one launch per iteration,
                # the weight (and the inline aligner) between launches
                return _fit_fused_fc(y, model, affiliation, quadratic_form,
                                     aligner=aligner, **fused_kwargs)
            assert (_stream_feasible(y, num_classes)
                    and (per_bin or fc_init_ok) and aligner is None), (
                'no fused-kernel variant feasible for this shape', y.shape)
            # long T: one streamed statistics launch per iteration
            return _fit_fused_stream(
                y, model, affiliation, quadratic_form,
                weight_mode='per_bin' if per_bin else 'fc', **fused_kwargs)

        standard = (saliency is None and source_activity_mask is None
                    and per_bin)
        if t_block == 'auto':
            t_block = (T_BLOCK_AUTO
                       if standard and not use_pallas_em
                       and num_observations > T_BLOCK_AUTO_THRESHOLD
                       else None)
        if t_block is not None:
            assert standard, (
                't_block requires standard knobs (no saliency/mask/'
                'aligner, weight_constant_axis=-1, hermitize, '
                'eigenvalue covariance norm)')
            fitted = _fit_em_t_blocked(
                y, model, affiliation, quadratic_form,
                iterations=int(iterations),
                eigenvalue_floor=float(eigenvalue_floor),
                affiliation_eps=float(affiliation_eps),
                first_e_step=model is not None,
                eigh_sweeps=None if eigh_sweeps is None else int(eigh_sweeps),
                t_block=int(t_block))
            if _return_affiliation:
                return fitted, _predict_time_last_blocked(
                    fitted, y, t_block=int(t_block))
            return fitted

        if use_pallas_em:
            assert y.ndim == 3, (
                'use_pallas_em requires (F, N, D) observations', y.shape)
            assert saliency is None and source_activity_mask is None
            assert aligner is None
            assert weight_constant_axis in ((-1,), -1), weight_constant_axis
            assert affiliation_eps == 0 or affiliation_eps <= 1e-9, (
                'the fused kernel does not clip affiliations',
                affiliation_eps)
            weight_constant_axis = (-1,)

        fitted = _fit_em(
            y, model, affiliation, quadratic_form, saliency,
            source_activity_mask, iterations=int(iterations),
            weight_constant_axis=weight_constant_axis,
            hermitize=bool(hermitize), covariance_norm=covariance_norm,
            eigenvalue_floor=float(eigenvalue_floor),
            affiliation_eps=float(affiliation_eps),
            first_e_step=model is not None, aligner=aligner,
            use_pallas_em=bool(use_pallas_em), eigh_sweeps=eigh_sweeps)
        if _return_affiliation:
            affiliation, _, _ = fitted._predict(
                y, source_activity_mask=source_activity_mask)
            return fitted, affiliation
        return fitted

    def fit_predict(self, y, initialization=None, num_classes=None,
                    iterations=100, **kwargs):
        """Fit, then return the posterior affiliations for ``y`` (from
        the kernel's final E-step on the whole-fit route, from the
        fitted model on the others)."""
        _, affiliation = self.fit(
            y, initialization, num_classes, iterations,
            _return_affiliation=True, **kwargs)
        return affiliation

    def fit_predict_model(self, *args, **kwargs):
        """Like :meth:`fit_predict` but returns ``(model,
        affiliation)``."""
        return self.fit(*args, _return_affiliation=True, **kwargs)
