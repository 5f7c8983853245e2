"""Streamed cACGMM EM for long signals (kernel ``csrc/em_stream.cu``).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_em_stream.py:cacgmm_em_long``. Each EM iteration
is ONE statistics pass (:func:`e_stats`) over the observations: the
E-step posterior of every frame is folded straight into the Hermitian
scatter sum_t aff / max(qf, 10 tiny) y y^H and the affiliation sums of
each (bin, class), so neither the (..., K, T) posterior nor the
(..., K, D, T) projection ever exists in device memory. The M-step
finish runs in PyTorch, as the JAX package runs it in XLA: covariance
D scatter / max(asum, tiny), the batched Jacobi (:mod:`.eigh`, K1 on
the card), eigenvalue max-normalization and floor, and the mixture
weight, per bin (``weight_mode='per_bin'``) or frequency-constant per
utterance (``'fc'``).

The kernel has no T limit: it streams y through a ring of frame tiles
in shared memory. Its grid is four whole waves: four times as many CTAs
as the card holds at once, each over an equal span of the bins' frames
laid end to end (:func:`_partition`, the plan of :mod:`._plan`, which
the streamed Watson / Bingham kernel shares), so no wave runs nearly
empty. Each piece of a bin that a CTA covers writes its partial sums to
its own slot, and the wrapper adds a bin's slots in a fixed order
(deterministic, no atomics).
The kernel is instantiated for every D in 1..16 (:data:`DIMS`).
:func:`fits` is its shape gate (D <= 16 and the first design's
shared-memory budget, which every K < 20 meets); the kernel's own needs
(:func:`kernel_smem_bytes`) stay within the card's limit wherever the
gate admits a shape.

On a CPU tensor the wrappers run their plain PyTorch twins
(:func:`e_stats_reference`, and :mod:`.eigh`'s twin in the finish). On
a CUDA tensor :func:`e_stats` launches the kernel or raises; it never
falls back. :func:`cacgmm_em_long_reference` is the whole fit with both
twins, for comparisons on the card.
"""
from __future__ import annotations

import torch

from .._dtypes import tiny as _tiny
from .._shard import frequency_bins, frequency_sum
from . import _plan
from ._build import SMEM_LIMIT
from .eigh import default_sweeps, eigh_jacobi, eigh_jacobi_reference

__all__ = ['cacgmm_em_long', 'cacgmm_em_long_reference', 'e_stats',
           'e_stats_reference', 'mixture_weight', 'smem_bytes',
           'kernel_smem_bytes', 'fits', 'DIMS']

DIMS = tuple(range(1, 17))  # the D the kernel is instantiated for
TILE = _plan.TILE  # frames per shared-memory tile
_WAVES = _plan.WAVES  # waves of the grid
# the gate's budget: the first streamed kernel's shared memory (512-frame
# tiles holding the posterior of every class), kept so that the gate
# admits the same shapes as before
_GATE_TILE = 512


def smem_bytes(D, K):
    """The gate's shared-memory budget at (D, K): what the first design
    of the kernel held per CTA. The kernel needs less
    (:func:`kernel_smem_bytes`)."""
    P = D * (D + 1) // 2
    return 8 * (D * _GATE_TILE + K * D * D + K * P) \
        + 4 * (2 * K * _GATE_TILE + 3 * K)


def kernel_smem_bytes(D, K):
    """Shared memory one CTA of the kernel takes (stream_smem_bytes in
    csrc/em_stream.cu): the pass's own (:func:`._plan.pass_words`), the
    tile's log-pdfs and quadratic forms, the scaled eigenbases and the
    per-class scalars."""
    return 4 * (_plan.pass_words(D) + K * D * D * 2 + 2 * K * TILE + 2 * K)


def fits(D, K):
    """Does the streamed kernel take (D, K)? Saliency and the
    source-activity mask are read from device memory frame by frame, so
    they do not change the budget; neither does T."""
    return D <= 16 and smem_bytes(D, K) <= SMEM_LIMIT


def _partition(N, T, capacity):
    """(ctas, span, slots) of one pass over N bins of T frames on a card
    that holds ``capacity`` CTAs at once: :func:`._plan.partition` with
    _WAVES whole waves of tiles of TILE frames."""
    return _plan.partition(N, T, capacity, TILE, _WAVES)


_segments = _plan.segments


def e_stats_reference(y, *, affiliation=None, quadratic_form=None,
                      eigenvalues=None, eigenvectors=None, weight=None,
                      affiliation_eps=0., saliency=None,
                      source_activity_mask=None):
    """Plain PyTorch twin of one statistics pass: the scan path's
    E-step (projection ``V^H y``, quadratic form, log-pdf, posterior)
    and its M-step sums.

    Args: as :func:`e_stats`.
    """
    from ..models._precision import full_fp32
    from ..models.mixture_model_utils import log_pdf_to_affiliation

    D = y.shape[-2]
    if affiliation is None:
        with full_fp32():
            z = torch.einsum('nkde,ndt->nket', eigenvectors.conj(), y)
            qf = torch.einsum('nket,nke->nkt', z.real ** 2 + z.imag ** 2,
                              1. / eigenvalues)
        qf = torch.clamp(qf, min=_tiny(y))
        log_pdf = -D * torch.log(qf) \
            - torch.log(eigenvalues).sum(-1)[..., None]
        aff = log_pdf_to_affiliation(
            weight[..., None], log_pdf,
            source_activity_mask=source_activity_mask,
            affiliation_eps=affiliation_eps)
    else:
        aff, qf = affiliation, quadratic_form
    if saliency is not None:
        aff = aff * saliency[:, None, :]
    w = aff / torch.clamp(qf, min=10 * _tiny(qf))
    yw = y[:, None] * w[:, :, None, :].to(y.dtype)  # (N, K, D, T)
    with full_fp32():
        scatter = yw @ y[:, None].conj().transpose(-1, -2)
    return scatter, aff.sum(-1)


def e_stats(y, *, affiliation=None, quadratic_form=None, eigenvalues=None,
            eigenvectors=None, weight=None, affiliation_eps=0.,
            saliency=None, source_activity_mask=None):
    """One streamed statistics pass: E-step (or the given posteriors)
    folded into the M-step sums.

    Two modes: **from_init** (``affiliation`` and ``quadratic_form``
    given) sums the given posteriors; **model** (``eigenvalues``,
    ``eigenvectors``, ``weight`` given) runs the E-step first, with the
    source-activity mask on the softmax numerators and the clip to
    ``[affiliation_eps, 1 - affiliation_eps]``. In both, saliency
    multiplies the posteriors before both sums.

    Args:
        y: (N, D, T) complex64 unit-norm, time-last observations.
        affiliation / quadratic_form: (N, K, T) (from_init mode).
        eigenvalues: (N, K, D); eigenvectors (N, K, D, D) in columns;
            weight (N, K) (model mode).
        saliency: optional (N, T); source_activity_mask: optional
            (N, K, T), 0/1 floats.
    Returns:
        (scatter (N, K, D, D) Hermitian sum_t aff / max(qf, 10 tiny)
        y y^H, affiliation sums (N, K)).
    """
    if y.device.type == 'cpu':
        return e_stats_reference(
            y, affiliation=affiliation, quadratic_form=quadratic_form,
            eigenvalues=eigenvalues, eigenvectors=eigenvectors,
            weight=weight, affiliation_eps=affiliation_eps,
            saliency=saliency, source_activity_mask=source_activity_mask)
    if y.device.type != 'cuda':
        raise ValueError(f'unsupported device {y.device}')
    if y.dtype != torch.complex64 or y.ndim != 3:
        raise ValueError(
            f'y must be complex64 (N, D, T), got {y.dtype} '
            f'{tuple(y.shape)}')
    N, D, T = y.shape
    from_init = affiliation is not None
    K = (affiliation if from_init else eigenvalues).shape[-2]
    if not fits(D, K):
        raise ValueError(
            f'(D={D}, K={K}) is outside the streamed kernel gate '
            '(D <= 16)')

    def operand(x, shape, dtype):
        if x is None:
            return None
        if tuple(x.shape) != shape or x.device != y.device:
            raise ValueError(
                f'expected {shape} on {y.device}, got {tuple(x.shape)} '
                f'on {x.device}')
        return x.resolve_conj().to(dtype).contiguous()

    y_ = y.resolve_conj().contiguous()
    if from_init:
        operands = [operand(affiliation, (N, K, T), torch.float32),
                    operand(quadratic_form, (N, K, T), torch.float32),
                    None, None, None]
    else:
        operands = [None, None,
                    operand(eigenvalues, (N, K, D), torch.float32),
                    operand(eigenvectors, (N, K, D, D), torch.complex64),
                    operand(weight, (N, K), torch.float32)]
    operands += [operand(saliency, (N, T), torch.float32),
                 operand(source_activity_mask, (N, K, T), torch.float32)]
    if not (N and T):
        return (torch.zeros((N, K, D, D), dtype=torch.complex64,
                            device=y.device),
                torch.zeros((N, K), dtype=torch.float32, device=y.device))
    ctas, span, slots = _partition(
        N, T, _plan.capacity('em_stream', y.device.index or 0, D, K))
    # a bin covered by fewer CTAs leaves its last slots 0
    scatter = torch.zeros((slots, N, K, D, D), dtype=torch.complex64,
                          device=y.device)
    asum = torch.zeros((slots, N, K), dtype=torch.float32, device=y.device)
    from ._build import load
    err = load('em_stream').em_stream_launch(
        y_.data_ptr(), *[0 if x is None else x.data_ptr() for x in operands],
        scatter.data_ptr(), asum.data_ptr(), N, D, K, T, ctas, span,
        float(affiliation_eps),
        torch.cuda.current_stream(y.device).cuda_stream)
    if err:
        raise RuntimeError(f'em_stream kernel launch failed: CUDA error {err}')
    e_stats.launches += 1
    # the second pass of the reduction: each bin's slots, in order
    return scatter.sum(0), asum.sum(0)


e_stats.launches = 0


def mixture_weight(asum, *, weight_mode, lead, frames, saliency):
    """The mixture weight from the (N, K) affiliation sums of the N bins
    of ``lead`` = (F,) or (B, F), each of ``frames`` frames: (N, K) per
    bin, or (K,) / (B, K) frequency-constant (``weight_mode='fc'``).
    With ``saliency`` the sums are L1-normalized over classes ('where'
    eps style of estimate_mixture_weight), else averaged."""
    F = lead[-1]
    if weight_mode == 'per_bin':
        sums, count = asum, frames
    else:
        # over every bin of a sharded fit
        sums = frequency_sum(asum.reshape(-1, F, asum.shape[-1]).sum(1))
        sums = sums if len(lead) == 2 else sums[0]
        count = frequency_bins(F) * frames
    if saliency:
        denom = sums.sum(-1, keepdim=True)
        denom = torch.where(denom == 0, torch.full_like(denom, 1e-10), denom)
        return sums / denom
    return sums / count


def _em_long(stats, eigh, y, affiliation, quadratic_form, *, iterations,
             sweeps=None, eigenvalue_floor=1e-10, affiliation_eps=1e-10,
             weight_mode='per_bin', saliency=None,
             source_activity_mask=None, first_e_step=False,
             init_weight=None, init_eigenvalues=None,
             init_eigenvectors=None):
    """The EM loop of :func:`cacgmm_em_long` with a given statistics
    pass and eigendecomposition."""
    if weight_mode not in ('per_bin', 'fc'):
        raise ValueError(weight_mode)
    if y.ndim not in (3, 4):
        raise ValueError(
            f'y must be (F, D, T) or (B, F, D, T), got {tuple(y.shape)}')
    *lead, D, T = y.shape
    B = lead[0] if len(lead) == 2 else 1
    F = lead[-1]
    N = B * F
    K = (affiliation.shape[-2] if affiliation is not None
         else init_eigenvalues.shape[-2])
    if sweeps is None:
        sweeps = default_sweeps(D)
    tiny = _tiny(y)

    def fold(x, *trailing):
        """Broadcast to (*lead, *trailing) and fold the leading axes."""
        if x is None:
            return None
        return torch.broadcast_to(x, (*lead, *trailing)).reshape(
            N, *trailing)

    y_f = fold(y, D, T)
    stats_kwargs = dict(saliency=fold(saliency, T),
                        source_activity_mask=fold(source_activity_mask, K, T))

    def finish_m(scatter, asum):
        covariance = D * scatter / torch.clamp(
            asum, min=tiny)[..., None, None].to(scatter.dtype)
        eigenvalues, eigenvectors = eigh(covariance, sweeps=sweeps)
        lam_max = torch.clamp(
            eigenvalues.max(-1, keepdim=True).values, min=tiny)
        eigenvalues = torch.clamp(eigenvalues / lam_max, min=eigenvalue_floor)
        return eigenvalues, eigenvectors

    def weight_of(asum):
        return mixture_weight(asum, weight_mode=weight_mode, lead=lead,
                              frames=T, saliency=saliency is not None)

    def per_bin(weight):
        if weight_mode == 'per_bin':
            return weight
        if len(lead) == 2:
            return weight[:, None, :].expand(B, F, K).reshape(N, K)
        return weight[None, :].expand(N, K)

    if not first_e_step:
        scatter, asum = stats(
            y_f, affiliation=fold(affiliation, K, T),
            quadratic_form=fold(quadratic_form, K, T), **stats_kwargs)
        eigenvalues, eigenvectors = finish_m(scatter, asum)
        weight = weight_of(asum)
        n_steps = iterations - 1
    else:
        eigenvalues = fold(init_eigenvalues, K, D)
        eigenvectors = fold(init_eigenvectors, K, D, D)
        if weight_mode == 'per_bin':
            weight = fold(init_weight, K)
        else:
            # a (1, K) weight broadcasts over the batch
            weight = torch.broadcast_to(
                init_weight, (B, K) if len(lead) == 2 else (K,))
        n_steps = iterations
    for _ in range(n_steps):
        scatter, asum = stats(
            y_f, eigenvalues=eigenvalues, eigenvectors=eigenvectors,
            weight=per_bin(weight), affiliation_eps=affiliation_eps,
            **stats_kwargs)
        eigenvalues, eigenvectors = finish_m(scatter, asum)
        weight = weight_of(asum)

    if weight_mode == 'per_bin':
        weight = weight.reshape(*lead, K)
    return (weight, eigenvalues.reshape(*lead, K, D),
            eigenvectors.reshape(*lead, K, D, D))


def cacgmm_em_long(y, affiliation, quadratic_form, *, iterations,
                   sweeps=None, eigenvalue_floor=1e-10,
                   affiliation_eps=1e-10, weight_mode='per_bin',
                   saliency=None, source_activity_mask=None,
                   first_e_step=False, init_weight=None,
                   init_eigenvalues=None, init_eigenvectors=None):
    """Streamed cACGMM EM for signals too long for the whole-fit kernel:
    one :func:`e_stats` pass per iteration, M-step finish in PyTorch.

    Args:
        y: (F, D, T) or (B, F, D, T) complex64 unit-norm, time-last
            observations (a leading batch folds into the bin axis; for
            ``weight_mode='fc'`` the weight stays per utterance).
        affiliation / quadratic_form: (..., F, K, T) initial posteriors
            and quadratic forms (None with ``first_e_step``).
        iterations: M-steps.
        sweeps: Jacobi sweeps of the M-step eigh (default 6 for D <= 8,
            else 8).
        weight_mode: ``'per_bin'`` (``weight_constant_axis=(-1,)``) or
            ``'fc'`` (``(-3, -1)``, frequency-constant).
        saliency: optional (..., F, T) frame weights.
        source_activity_mask: optional (..., F, K, T) 0/1 floats.
        first_e_step: resume from ``init_weight`` (per bin (..., F, K)
            for 'per_bin'; (K,) or (B, K) for 'fc'),
            ``init_eigenvalues`` and ``init_eigenvectors``.
    Returns:
        (weight, eigenvalues (..., F, K, D) ascending, eigenvectors
        (..., F, K, D, D)); weight (..., F, K) for 'per_bin' and (K,)
        or (B, K) for 'fc'.
    """
    return _em_long(
        e_stats, eigh_jacobi, y, affiliation, quadratic_form,
        iterations=iterations, sweeps=sweeps,
        eigenvalue_floor=eigenvalue_floor, affiliation_eps=affiliation_eps,
        weight_mode=weight_mode, saliency=saliency,
        source_activity_mask=source_activity_mask,
        first_e_step=first_e_step, init_weight=init_weight,
        init_eigenvalues=init_eigenvalues,
        init_eigenvectors=init_eigenvectors)


def cacgmm_em_long_reference(y, affiliation, quadratic_form, **kwargs):
    """Plain PyTorch twin of :func:`cacgmm_em_long`: the same loop
    with :func:`e_stats_reference` and the plain batched Jacobi, on any
    device."""
    return _em_long(e_stats_reference, eigh_jacobi_reference, y,
                    affiliation, quadratic_form, **kwargs)
