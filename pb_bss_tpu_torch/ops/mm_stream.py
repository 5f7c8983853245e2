"""Streamed complex Watson and complex Bingham mixture EM (kernel
``csrc/mm_stream.cu``, K7).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_mm_stream.py`` (``_stream_machinery``, launched by
``cwmm_em_long`` and ``cbmm_em_long``). Each EM iteration is ONE
statistics pass (:func:`mm_stats`) over the observations: the E-step
posterior of every frame (Watson ``kappa |<y, m>|^2 - log Z``, or Bingham
``y^H V diag(lambda) V^H y - log c`` with the ``affiliation_eps`` clip) is
folded straight into the affiliation-weighted scatter sum_t a y y^H and
the affiliation sums of each (bin, class), so the (..., K, T) posterior
never exists in device memory. The first pass reads the initial
affiliations instead (from-init mode). The M-step finish runs in PyTorch
between launches, as the JAX package runs it in XLA: the scatter divided
by max(asum, tiny), ``ops.linalg.eigh`` (the batched Jacobi kernel K1 on
the card for 64 matrices or more), then for Watson the dominant
eigenpair and the concentration from the scan path's *log-spaced*
``hyp1f1`` table, for Bingham the moments floored at 0 and
``find_eigenvalues`` (the chord kernel K8 on the card: a cold solve at
the first M-step, warm 16-step solves after it), and the mixture weight
per bin or frequency-constant (``weight_mode='fc'``), saliency-aware. A
fit of ``iterations`` M-steps launches the kernel ``iterations`` times.

The kernel has no T limit: it runs the streamed cACGMM kernel's pass
(``csrc/stream.cuh``), y streamed through a ring of frame tiles in shared
memory by a grid of whole waves, each CTA over an equal span of the bins'
frames laid end to end (the plan of :mod:`._plan`, shared with
:mod:`.em_stream`); each piece of a bin that a CTA covers writes its
partial sums (each scatter's upper triangle) to its own slot, and the
wrapper adds a bin's slots in a fixed order (deterministic, no atomics)
and mirrors the triangle. It is instantiated for every D
in 1..16 (:data:`DIMS`), each family on its own. :func:`fits` is its
shape gate (D <= 16 and the first design's shared-memory budget); the
kernel's own needs (:func:`kernel_smem_bytes`) stay within the card's
limit wherever the gate admits a shape.

On a CPU tensor :func:`mm_stats` runs its plain PyTorch twin
(:func:`mm_stats_reference`). On a CUDA tensor it launches the kernel or
raises; it never falls back. :func:`cwmm_em_long_reference` and
:func:`cbmm_em_long_reference` are the whole fits with the twins (and
the plain Jacobi), on any device.
"""
from __future__ import annotations

import functools
import math

import torch

from .._dtypes import tiny as _tiny
from . import _plan
from ._build import SMEM_LIMIT, counted, launch
from .em_stream import mixture_weight
from .linalg import eigh

__all__ = ['cwmm_em_long', 'cwmm_em_long_reference', 'cbmm_em_long',
           'cbmm_em_long_reference', 'mm_stats', 'mm_stats_reference',
           'smem_bytes', 'kernel_smem_bytes', 'fits', 'DIMS']

DIMS = tuple(range(1, 17))  # the D the kernel is instantiated for
TILE = _plan.TILE  # frames per shared-memory tile
# the gate's budget: the first streamed kernel's shared memory (512-frame
# tiles holding the posterior of every class), kept so that the gate
# admits the same shapes as before
_GATE_TILE = 512


def smem_bytes(D, K, family='watson'):
    """The gate's shared-memory budget at (D, K): what the first design
    of the kernel held per CTA (the Bingham step mode adds the K forms V
    diag(lambda) V^H). The kernel needs less (:func:`kernel_smem_bytes`)."""
    P = D * (D + 1) // 2
    forms = K * D * D if family == 'bingham' else 0
    return 8 * (D * _GATE_TILE + K * P + K * D + forms) \
        + 4 * (K * _GATE_TILE + 4 * K)


def kernel_smem_bytes(D, K, family='watson'):
    """Shared memory one CTA of the kernel takes (mm_smem_bytes in
    csrc/mm_stream.cu): the pass's own (:func:`._plan.pass_words`), the
    tile's posteriors, the model (the K modes, or the K forms in the
    Bingham step mode) and the per-class scalars."""
    model = K * D * D if family == 'bingham' else K * D
    return 4 * (_plan.pass_words(D) + K * TILE + 2 * model + 3 * K)


def fits(D, K, has_sal=False, family='watson'):
    """Does the streamed kernel take (D, K) for ``family``? Saliency is read
    from device memory frame by frame, so it does not change the budget;
    neither does T."""
    return D <= 16 and smem_bytes(D, K, family) <= SMEM_LIMIT


@functools.lru_cache(maxsize=None)
def _mirror_index(D, device):
    """(index into the row-major upper triangle, lower-triangle mask) of
    each entry of a D x D matrix."""
    rows, cols = torch.triu_indices(D, D)
    position = torch.empty((D, D), dtype=torch.long)
    position[rows, cols] = torch.arange(rows.numel())
    position[cols, rows] = torch.arange(rows.numel())
    lower = torch.ones(D, D, dtype=torch.bool).tril(-1)
    return position.to(device), lower.to(device)


def _mirror(upper, D):
    """(..., D(D+1)/2) row-major upper triangles -> (..., D, D)
    Hermitian matrices."""
    position, lower = _mirror_index(D, upper.device)
    full = upper[..., position]
    return torch.where(lower, full.conj(), full)


def mm_stats_reference(y, *, affiliation=None, mode=None, concentration=None,
                       log_norm=None, weight=None, bins_per_weight=1,
                       saliency=None, eigenvectors=None, eigenvalues=None,
                       affiliation_eps=0.):
    """Plain PyTorch twin of one statistics pass: the scan path's Watson or
    Bingham E-step and its M-step sums.

    Args: as :func:`mm_stats`.
    """
    from ..models._precision import full_fp32
    from ..models.mixture_model_utils import log_pdf_to_affiliation

    if affiliation is None:
        if eigenvectors is not None:
            with full_fp32():
                forms = (eigenvectors * eigenvalues[..., None, :].to(
                    eigenvectors.dtype)) @ eigenvectors.conj().transpose(
                        -1, -2)  # (N, K, D, D)
                by = torch.einsum('nkde,net->nkdt', forms, y)
                quad = torch.einsum('ndt,nkdt->nkt', y.conj(), by).real
            log_pdf = quad - log_norm[..., None]
        else:
            with full_fp32():
                z = torch.einsum('nkd,ndt->nkt', mode.conj(), y)
            log_pdf = concentration[..., None] \
                * (z.real ** 2 + z.imag ** 2) - log_norm[..., None]
        w = weight.repeat_interleave(bins_per_weight, 0)
        affiliation = log_pdf_to_affiliation(
            w[..., None], log_pdf, affiliation_eps=affiliation_eps)
    if saliency is not None:
        affiliation = affiliation * saliency[:, None, :]
    with full_fp32():
        scatter = (y[:, None] * affiliation[:, :, None, :].to(y.dtype)) \
            @ y[:, None].conj().transpose(-1, -2)
    return scatter, affiliation.sum(-1)


@counted
def mm_stats(y, *, affiliation=None, mode=None, concentration=None,
             log_norm=None, weight=None, bins_per_weight=1, saliency=None,
             eigenvectors=None, eigenvalues=None, affiliation_eps=0.):
    """One streamed statistics pass.

    Three modes: **from-init** (``affiliation`` given) sums the given
    posteriors; **Watson step** (``mode``, ``concentration``, ``log_norm``,
    ``weight`` given) runs the E-step ``kappa |<y, m>|^2 - log Z``;
    **Bingham step** (``eigenvectors``, ``eigenvalues``, ``log_norm`` =
    log c, ``weight`` given) runs ``y^H V diag(lambda) V^H y - log c`` and
    clips the posteriors to ``[affiliation_eps, 1 - affiliation_eps]``
    when that is not 0. Both step modes take a max-shift softmax first. In
    every mode, saliency multiplies the posteriors before both sums.

    Args:
        y: (N, D, T) complex64 unit-norm, time-last observations.
        affiliation: (N, K, T) (from-init mode).
        mode: (N, K, D) complex; concentration / log_norm (N, K);
        eigenvectors: (N, K, D, D) complex (in columns); eigenvalues
            (N, K, D) Bingham eigenvalues (Bingham step mode);
            weight (N / bins_per_weight, K): bin n takes row
            n // bins_per_weight (1 per bin; F for frequency-constant
            weights of B utterances of F bins) (step mode).
        saliency: optional (N, T).
    Returns:
        (scatter (N, K, D, D) Hermitian sum_t a y y^H, affiliation sums
        (N, K)).
    """
    if y.device.type == 'cpu':
        return mm_stats_reference(
            y, affiliation=affiliation, mode=mode,
            concentration=concentration, log_norm=log_norm, weight=weight,
            bins_per_weight=bins_per_weight, saliency=saliency,
            eigenvectors=eigenvectors, eigenvalues=eigenvalues,
            affiliation_eps=affiliation_eps)
    if y.device.type != 'cuda':
        raise ValueError(f'unsupported device {y.device}')
    if y.dtype != torch.complex64 or y.ndim != 3:
        raise ValueError(
            f'y must be complex64 (N, D, T), got {y.dtype} '
            f'{tuple(y.shape)}')
    N, D, T = y.shape
    from_init = affiliation is not None
    K = (affiliation if from_init else log_norm).shape[1]
    step_bingham = not from_init and eigenvectors is not None
    if not fits(D, K, family='bingham' if step_bingham else 'watson'):
        raise ValueError(
            f'(D={D}, K={K}) is outside the streamed kernel gate '
            '(D <= 16, shared memory)')
    if N % bins_per_weight:
        raise ValueError(f'{N} bins do not split into groups of '
                         f'{bins_per_weight}')

    def operand(x, shape, dtype):
        if x is None:
            return None
        if tuple(x.shape) != shape or x.device != y.device:
            raise ValueError(
                f'expected {shape} on {y.device}, got {tuple(x.shape)} '
                f'on {x.device}')
        return x.resolve_conj().to(dtype).contiguous()

    y_ = y.resolve_conj().contiguous()
    # the kernel's operand order: aff0, mode, kappa, logz, weight, sal,
    # vec, lam
    operands = [None] * 8
    if from_init:
        operands[0] = operand(affiliation, (N, K, T), torch.float32)
    else:
        if step_bingham:
            operands[6] = operand(eigenvectors, (N, K, D, D),
                                  torch.complex64)
            operands[7] = operand(eigenvalues, (N, K, D), torch.float32)
        else:
            operands[1] = operand(mode, (N, K, D), torch.complex64)
            operands[2] = operand(concentration, (N, K), torch.float32)
        operands[3] = operand(log_norm, (N, K), torch.float32)
        operands[4] = operand(weight, (N // bins_per_weight, K),
                              torch.float32)
    operands[5] = operand(saliency, (N, T), torch.float32)
    if not (N and T):
        return (torch.zeros((N, K, D, D), dtype=torch.complex64,
                            device=y.device),
                torch.zeros((N, K), dtype=torch.float32, device=y.device))
    ctas, span, slots = _plan.partition(N, T, _plan.capacity(
        'mm_stream', y.device.index or 0, D, K, int(step_bingham)))
    # a bin covered by fewer CTAs leaves its last slots 0
    upper = torch.zeros((slots, N, K, D * (D + 1) // 2),
                        dtype=torch.complex64, device=y.device)
    asum = torch.zeros((slots, N, K), dtype=torch.float32, device=y.device)
    launch(mm_stats, 'mm_stream', 'mm_stream_launch', y_.data_ptr(),
           *[0 if x is None else x.data_ptr() for x in operands],
           upper.data_ptr(), asum.data_ptr(), N, D, K, T, ctas, span,
           int(bins_per_weight),
           float(affiliation_eps) if step_bingham else 0.,
           torch.cuda.current_stream(y.device).cuda_stream)
    # the second pass of the reduction: each bin's slots, in order; then
    # the lower triangle from the upper
    return _mirror(upper.sum(0), D), asum.sum(0)


def _cwmm_em_long(stats, eigh_method, y, affiliation, *, iterations,
                  max_concentration=500.0, spline_markers=1000,
                  weight_mode='per_bin', sweeps=None, saliency=None):
    """The EM loop of :func:`cwmm_em_long` with a given statistics pass
    and eigh method."""
    from ..models.complex_watson import ComplexWatson, ComplexWatsonTrainer

    if weight_mode not in ('per_bin', 'fc'):
        raise ValueError(weight_mode)
    if y.ndim not in (3, 4):
        raise ValueError(
            f'y must be (F, D, T) or (B, F, D, T), got {tuple(y.shape)}')
    *lead, D, T = y.shape
    F = lead[-1]
    N = F * (lead[0] if len(lead) == 2 else 1)
    K = affiliation.shape[-2]
    trainer = ComplexWatsonTrainer(D, max_concentration=max_concentration,
                                   spline_markers=spline_markers)
    y_f = y.reshape(N, D, T)
    if saliency is not None:
        saliency = torch.broadcast_to(saliency, (*lead, T)).reshape(N, T)

    def finish_m(scatter, asum):
        covariance = scatter / torch.clamp(
            asum, min=_tiny(asum))[..., None, None].to(scatter.dtype)
        eigenvalues, eigenvectors = eigh(covariance, method=eigh_method,
                                         sweeps=sweeps)
        mode = eigenvectors[..., :, -1]
        kappa = trainer.hypergeometric_ratio_inverse(
            eigenvalues[..., -1]).to(torch.float32)
        weight = mixture_weight(asum, weight_mode=weight_mode, lead=lead,
                                frames=T, saliency=saliency is not None)
        return mode, kappa, weight

    mode, kappa, weight = finish_m(*stats(
        y_f, affiliation=torch.broadcast_to(affiliation, (*lead, K, T))
        .reshape(N, K, T), saliency=saliency))
    for _ in range(iterations - 1):
        log_norm = ComplexWatson.log_norm_tran_vu(kappa, D).to(torch.float32)
        mode, kappa, weight = finish_m(*stats(
            y_f, mode=mode, concentration=kappa, log_norm=log_norm,
            weight=weight.reshape(-1, K),
            bins_per_weight=1 if weight_mode == 'per_bin' else F,
            saliency=saliency))
    if weight_mode == 'per_bin':
        weight = weight.reshape(*lead, K)
    return (weight, mode.reshape(*lead, K, D), kappa.reshape(*lead, K))


def cwmm_em_long(y, affiliation, *, iterations, max_concentration=500.0,
                 spline_markers=1000, weight_mode='per_bin', sweeps=None,
                 saliency=None):
    """Streamed complex Watson mixture EM: one :func:`mm_stats` pass per
    iteration, M-step finish in PyTorch.

    Args:
        y: (F, D, T) or (B, F, D, T) complex64 unit-norm, time-last
            observations (a leading batch folds into the bin axis; for
            ``weight_mode='fc'`` the weight stays per utterance).
        affiliation: (..., F, K, T) initial posteriors.
        iterations: M-steps (the kernel launches once per M-step).
        weight_mode: ``'per_bin'`` (``weight_constant_axis=(-1,)``) or
            ``'fc'`` (``(-3, -1)``, frequency-constant).
        sweeps: Jacobi sweeps of the M-step eigh (default from D).
        saliency: optional (..., F, T) frame weights.
    Returns:
        (weight — (..., F, K) per bin, (K,) or (B, K) for 'fc' — mode
        (..., F, K, D) complex64, concentration (..., F, K)).
    """
    return _cwmm_em_long(
        mm_stats, 'auto', y, affiliation, iterations=iterations,
        max_concentration=max_concentration, spline_markers=spline_markers,
        weight_mode=weight_mode, sweeps=sweeps, saliency=saliency)


def cwmm_em_long_reference(y, affiliation, **kwargs):
    """Plain PyTorch twin of :func:`cwmm_em_long`: the same loop with
    :func:`mm_stats_reference` and the plain batched Jacobi, on any
    device."""
    return _cwmm_em_long(mm_stats_reference, 'jacobi', y, affiliation,
                         **kwargs)


def _cbmm_em_long(stats, eigh_method, chord, y, affiliation, *, iterations,
                  max_concentration=math.inf, spacing_eps=None,
                  affiliation_eps=0., weight_mode='per_bin', sweeps=None,
                  saliency=None):
    """The EM loop of :func:`cbmm_em_long` with a given statistics pass,
    eigh method and chord solver (None: ``find_eigenvalues``' own
    routing)."""
    from ..models.complex_bingham import ComplexBingham, find_eigenvalues

    if weight_mode not in ('per_bin', 'fc'):
        raise ValueError(weight_mode)
    if y.ndim not in (3, 4):
        raise ValueError(
            f'y must be (F, D, T) or (B, F, D, T), got {tuple(y.shape)}')
    *lead, D, T = y.shape
    F = lead[-1]
    N = F * (lead[0] if len(lead) == 2 else 1)
    K = affiliation.shape[-2]
    y_f = y.reshape(N, D, T)
    if saliency is not None:
        saliency = torch.broadcast_to(saliency, (*lead, T)).reshape(N, T)

    def finish_m(scatter, asum, warm_start=None):
        covariance = scatter / torch.clamp(
            asum, min=_tiny(asum))[..., None, None].to(scatter.dtype)
        moments, eigenvectors = eigh(covariance, method=eigh_method,
                                     sweeps=sweeps)
        lam = find_eigenvalues(
            torch.clamp(moments, min=0.0),
            max_concentration=max_concentration, eps=spacing_eps,
            iterations=50 if warm_start is None else 16,
            warm_start=warm_start, _chord=chord)
        weight = mixture_weight(asum, weight_mode=weight_mode, lead=lead,
                                frames=T, saliency=saliency is not None)
        return lam, eigenvectors, weight

    lam, vec, weight = finish_m(*stats(
        y_f, affiliation=torch.broadcast_to(affiliation, (*lead, K, T))
        .reshape(N, K, T), saliency=saliency))
    for _ in range(iterations - 1):
        log_norm = ComplexBingham(
            covariance_eigenvectors=vec, covariance_eigenvalues=lam,
        ).log_norm().to(torch.float32)
        lam, vec, weight = finish_m(*stats(
            y_f, eigenvectors=vec, eigenvalues=lam, log_norm=log_norm,
            weight=weight.reshape(-1, K),
            bins_per_weight=1 if weight_mode == 'per_bin' else F,
            saliency=saliency, affiliation_eps=affiliation_eps),
        warm_start=lam)
    if weight_mode == 'per_bin':
        weight = weight.reshape(*lead, K)
    return (weight, lam.reshape(*lead, K, D),
            vec.reshape(*lead, K, D, D))


def cbmm_em_long(y, affiliation, *, iterations, max_concentration=math.inf,
                 spacing_eps=None, affiliation_eps=0., weight_mode='per_bin',
                 sweeps=None, saliency=None):
    """Streamed complex Bingham mixture EM: one :func:`mm_stats` pass per
    iteration, M-step finish in PyTorch (eigh, then ``find_eigenvalues``:
    the chord kernel K8 on a CUDA tensor, the scan path's solver on a CPU
    tensor), as the JAX package's ``cbmm_em_long``.

    Args:
        y: (F, D, T) or (B, F, D, T) complex64 unit-norm, time-last
            observations (a leading batch folds into the bin axis; for
            ``weight_mode='fc'`` the weight stays per utterance).
        affiliation: (..., F, K, T) initial posteriors.
        iterations: M-steps (the kernel launches once per M-step).
        max_concentration / spacing_eps: the moment inversion's bound
            and minimum spacing (None: 1e-3 at f32).
        affiliation_eps: the E-step's posterior clip.
        weight_mode: ``'per_bin'`` or ``'fc'`` (frequency-constant).
        sweeps: Jacobi sweeps of the M-step eigh (default from D).
        saliency: optional (..., F, T) frame weights.
    Returns:
        (weight — (..., F, K) per bin, (K,) or (B, K) for 'fc' —
        eigenvalues (..., F, K, D), ascending with the maximum pinned to
        0, eigenvectors (..., F, K, D, D) complex64).
    """
    return _cbmm_em_long(
        mm_stats, 'auto', None, y, affiliation, iterations=iterations,
        max_concentration=max_concentration, spacing_eps=spacing_eps,
        affiliation_eps=affiliation_eps, weight_mode=weight_mode,
        sweeps=sweeps, saliency=saliency)


def cbmm_em_long_reference(y, affiliation, **kwargs):
    """Plain PyTorch twin of :func:`cbmm_em_long` on the card's route: the
    same loop with :func:`mm_stats_reference`, the plain batched Jacobi
    and the chord solver's twin
    (:func:`pb_bss_tpu_torch.ops.bingham.bingham_chord_solve_reference`:
    three 10-step rounds cold, one 16-step round warm), on any device."""
    from .bingham import bingham_chord_solve_reference
    return _cbmm_em_long(mm_stats_reference, 'jacobi',
                         bingham_chord_solve_reference, y, affiliation,
                         **kwargs)
