"""Integration-model EM statistics, one pass per EM iteration (kernel
``csrc/integration_em.cu``, K10).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_integration_em.py:e_stats_staged`` (with its
one-shot wrapper ``vmfcacgmm_e_stats``). One pass over the observations
and the embedding runs the E-step of ``VMFCACGMM`` / ``GCACGMM`` (the
spatial cACG of each bin and the global spectral model of its utterance)
and folds the posterior straight into every sum the M-step needs: the
Hermitian scatter ``sum_t a / max(q, 10 tiny) y y^H``, ``sum_t a``, the
resultants ``sum_t a e`` on the raw embedding and, for the Gaussian,
``sum_t a e^2``. The posterior never exists in device memory. The M-step
finish runs in PyTorch (``models/vmfcacgmm.py``, ``models/gcacgmm.py``).

The work plan is the streamed passes' (:mod:`._plan`): whole waves of
CTAs over equal spans of the bins' frames laid end to end. A bin that
one CTA covers gets its sums written straight out; a bin split over CTAs
gets a partial sum a segment, and the CTA that finishes it last adds
them in slot order inside the same launch (a ticket on the bin's counter
in a per-stream workspace, which the kernel leaves at 0), so the call is
one launch and runs repeat bit for bit. What bounds it on the H100: the
bytes of y and the embedding, read once per pass (~20 MB at F=513,
T=300, D=6, E=20: ~6 us at 3.35 TB/s), against ~1 kFLOP a frame.

Gate (:func:`fits`): D <= 16 (the JAX package's bound) and the CTA's
working set within the 227 KB of shared memory a block may opt into,
with a ring of one tile (two where they fit); the working set holds
tiles of frames, so T is unlimited (the JAX package's VMEM budget,
``choose_tile_f``, had a T limit).

On a CPU tensor the wrapper runs the plain PyTorch twin,
:func:`e_stats_reference`. On a CUDA tensor it launches the kernel or
raises; it never falls back.
"""
from __future__ import annotations

import functools

import torch

from .._dtypes import tiny as _tiny
from . import _plan
from ._build import SMEM_LIMIT, counted, launch

__all__ = ['e_stats', 'e_stats_reference', 'smem_bytes', 'fits', 'plan',
           'MODES']

MODES = {'vmf': 0, 'gaussian': 1}
_GROUP = 4  # classes summed in registers at once
# a CTA's threads, one a frame of a tile (128 or 256), and the whole waves
# of the grid (ops/_plan.py): six CTAs of 128 an SM in one wave ran a pass
# 20-24% faster than three of 256 in four waves on an H100 (PERF.md)
TILE = 128
_WAVES = 1


def _ring_words(D, E, stages, tile):
    """Words of the tile ring, or of the reduction's scratch that reuses
    it (ring_words in csrc/integration_em.cu)."""
    item_sets = -(-(D * (D + 1) // 2) // 32) + 1
    words = max(stages * (tile + 1) * (2 * D + E),
                tile // 32 * _GROUP * item_sets * 64)
    return -(-words // 4) * 4


@functools.lru_cache(maxsize=None)
def smem_bytes(D, K, E, stages, tile):
    """Shared memory one CTA of ``tile`` threads needs with ``stages``
    tiles in its ring (csrc/integration_em.cu)."""
    return 4 * (_ring_words(D, E, stages, tile) + 2 * K * D * D
                + 2 * K * tile + K * D + 4 * K + 2 * K * E + 1)


def fits(D, K, E):
    """Does the statistics kernel take (D, K, E)? Saliency is read from
    device memory frame by frame and T is walked in tiles, so neither
    changes the budget."""
    return D <= 16 and smem_bytes(D, K, E, 1, TILE) <= SMEM_LIMIT


def _stages(D, K, E, tile):
    """Tiles in the ring: two (the next tile's copy overlaps this one's
    work) where they fit the shared memory, else one."""
    return 2 if smem_bytes(D, K, E, 2, tile) <= SMEM_LIMIT else 1


def plan(N, T, capacity, tile):
    """(ctas, span, slots) of one pass over N bins of T frames on a card
    that holds ``capacity`` CTAs of ``tile`` threads at once:
    :func:`._plan.partition`. The frames of bin n fall to CTAs
    floor(n T / span) .. floor(((n + 1) T - 1) / span); where they are
    more than one, each writes its partial sums to its slot (< slots)."""
    return _plan.partition(N, T, capacity, tile=tile, waves=_WAVES)


def _check_mode(spectral_mode):
    if spectral_mode not in MODES:
        raise ValueError(
            f"spectral_mode must be 'vmf' or 'gaussian', got {spectral_mode!r}")


def spectral_log_pdf(emb, mu, kappa, log_c, spectral_mode):
    """The spectral log-pdf of the kernel, (N, K, T), from the per-bin
    spectral state (N, K, E) / (N, K[, E]) / (N, K) and the (N, E, T)
    embedding: vMF ``kappa mu.e / sqrt(max(|e|^2, tiny)) - log C``;
    Gaussian ``(P m).e - 0.5 e.diag(P).e - const``."""
    if spectral_mode == 'vmf':
        inv_norm = torch.rsqrt(torch.clamp(
            (emb * emb).sum(-2, keepdim=True), min=_tiny(emb)))
        return kappa[..., None] * torch.einsum(
            'nke,net->nkt', mu, emb) * inv_norm - log_c[..., None]
    return (torch.einsum('nke,net->nkt', mu, emb)
            - 0.5 * torch.einsum('nke,net->nkt', kappa, emb * emb)
            - log_c[..., None])


def e_step_reference(y, emb, *, eigenvalues, eigenvectors, weight, mu,
                     kappa, log_c, spectral_mode='vmf', spatial_weight=1.,
                     spectral_weight=1., affiliation_eps=0.):
    """The kernel's E-step in plain PyTorch on per-bin state: (posterior
    (N, K, T), quadratic form floored at tiny (N, K, T))."""
    from ..models._precision import full_fp32
    from ..models.mixture_model_utils import log_pdf_to_affiliation

    D = y.shape[-2]
    with full_fp32():
        z = torch.einsum('nkde,ndt->nket', eigenvectors.conj(), y)
        qf = torch.einsum('nket,nke->nkt', z.real ** 2 + z.imag ** 2,
                          1. / eigenvalues)
    qf = torch.clamp(qf, min=_tiny(y))
    spatial = -D * torch.log(qf) \
        - torch.log(eigenvalues).sum(-1)[..., None]
    log_pdf = spatial_weight * spatial + spectral_weight * spectral_log_pdf(
        emb, mu, kappa, log_c, spectral_mode)
    aff = log_pdf_to_affiliation(weight[..., None], log_pdf,
                                 affiliation_eps=affiliation_eps)
    return aff, qf


def _per_bin(x, bins_per_utt):
    """(U, ...) spectral state -> (U * bins_per_utt, ...)."""
    return x.repeat_interleave(bins_per_utt, dim=0)


def e_stats_reference(y, emb, *, eigenvalues, eigenvectors, weight, mu,
                      kappa, log_c, bins_per_utt=None, spectral_mode='vmf',
                      spatial_weight=1., spectral_weight=1.,
                      affiliation_eps=1e-10, saliency=None):
    """Plain PyTorch twin of one statistics pass: the scan path's E-step
    and the sums of its M-step.

    Args and returns: as :func:`e_stats`.
    """
    from ..models._precision import full_fp32

    _check_mode(spectral_mode)
    N = y.shape[0]
    bins_per_utt = N if bins_per_utt is None else bins_per_utt
    spec = [_per_bin(x, bins_per_utt) for x in (mu, kappa, log_c)]
    aff, qf = e_step_reference(
        y, emb, eigenvalues=eigenvalues, eigenvectors=eigenvectors,
        weight=weight, mu=spec[0], kappa=spec[1], log_c=spec[2],
        spectral_mode=spectral_mode, spatial_weight=spatial_weight,
        spectral_weight=spectral_weight, affiliation_eps=affiliation_eps)
    if saliency is not None:
        aff = aff * saliency[:, None, :]
    w = aff / torch.clamp(qf, min=10 * _tiny(qf))
    with full_fp32():
        scatter = (y[:, None] * w[:, :, None, :].to(y.dtype)) \
            @ y[:, None].conj().transpose(-1, -2)
        res = torch.einsum('nkt,net->nke', aff, emb)
        m2 = (torch.einsum('nkt,net->nke', aff, emb * emb)
              if spectral_mode == 'gaussian' else None)
    return scatter, aff.sum(-1), res, m2


@counted
def e_stats(y, emb, *, eigenvalues, eigenvectors, weight, mu, kappa, log_c,
            bins_per_utt=None, spectral_mode='vmf', spatial_weight=1.,
            spectral_weight=1., affiliation_eps=1e-10, saliency=None):
    """One integration-model statistics pass: E-step folded into the
    M-step sums.

    Args:
        y: (N, D, T) complex64 unit-norm, time-last observations, N =
            U * bins_per_utt (utterances folded into the bin axis).
        emb: (N, E, T) float32 raw embedding, time-last.
        eigenvalues: (N, K, D); eigenvectors (N, K, D, D) in columns;
            weight (N, K): each bin's cACG model and mixture weight.
        mu / kappa / log_c: the spectral state of each of the U
            utterances, by mode: 'vmf' mean (U, K, E), concentration
            (U, K), log normalizer (U, K); 'gaussian' precision-scaled
            mean ``P m`` (U, K, E), per-dimension precision (U, K, E),
            constant ``E/2 log 2pi - log|P|/2 + m.P.m / 2`` (U, K).
        bins_per_utt: bins of one utterance (default N: one utterance).
        saliency: optional (N, T) frame weights of every sum.
    Returns:
        (scatter (N, K, D, D) Hermitian complex64, affiliation sums
        (N, K), resultants (N, K, E), second moments (N, K, E) for
        'gaussian', else None). The caller sums the resultants and
        moments over each utterance's bins.
    """
    _check_mode(spectral_mode)
    if y.device.type == 'cpu':
        return e_stats_reference(
            y, emb, eigenvalues=eigenvalues, eigenvectors=eigenvectors,
            weight=weight, mu=mu, kappa=kappa, log_c=log_c,
            bins_per_utt=bins_per_utt, spectral_mode=spectral_mode,
            spatial_weight=spatial_weight, spectral_weight=spectral_weight,
            affiliation_eps=affiliation_eps, saliency=saliency)
    if y.device.type != 'cuda':
        raise ValueError(f'unsupported device {y.device}')
    if y.dtype != torch.complex64 or y.ndim != 3:
        raise ValueError(
            f'y must be complex64 (N, D, T), got {y.dtype} {tuple(y.shape)}')
    N, D, T = y.shape
    K = weight.shape[-1]
    E = emb.shape[-2]
    bins_per_utt = N if bins_per_utt is None else int(bins_per_utt)
    if bins_per_utt < 1 or N % bins_per_utt:
        raise ValueError(f'{N} bins do not fold into utterances of '
                         f'{bins_per_utt} bins')
    U = N // bins_per_utt
    if not fits(D, K, E):
        raise ValueError(
            f'(D={D}, K={K}, E={E}) is outside the integration statistics '
            'kernel gate (D <= 16 and the shared-memory budget)')
    gaussian = spectral_mode == 'gaussian'

    def operand(x, shape, dtype):
        if x is None:
            return None
        if tuple(x.shape) != shape or x.device != y.device:
            raise ValueError(
                f'expected {shape} on {y.device}, got {tuple(x.shape)} '
                f'on {x.device}')
        if x.dtype != dtype or x.is_conj() or not x.is_contiguous():
            x = x.resolve_conj().to(dtype).contiguous()
        return x

    operands = [
        operand(emb, (N, E, T), torch.float32),
        operand(saliency, (N, T), torch.float32),
        operand(eigenvalues, (N, K, D), torch.float32),
        operand(eigenvectors, (N, K, D, D), torch.complex64),
        operand(weight, (N, K), torch.float32),
        operand(mu, (U, K, E), torch.float32),
        operand(kappa, (U, K, E) if gaussian else (U, K), torch.float32),
        operand(log_c, (U, K), torch.float32),
    ]
    y_ = y if not y.is_conj() and y.is_contiguous() \
        else y.resolve_conj().contiguous()
    f32 = dict(dtype=torch.float32, device=y.device)
    scatter = torch.empty((N, K, D, D), dtype=torch.complex64,
                          device=y.device)
    asum = torch.empty((N, K), **f32)
    res = torch.empty((N, K, E), **f32)
    m2 = torch.empty((N, K, E), **f32) if gaussian else None
    if not (N and T):
        for x in (scatter, asum, res, m2):
            if x is not None:
                x.zero_()
        return scatter, asum, res, m2
    index = y.device.index or 0
    tile = TILE
    stages = _stages(D, K, E, tile)
    ctas, span, slots = plan(N, T, _plan.capacity(
        'integration_em', index, D, K, E, MODES[spectral_mode], stages,
        tile), tile)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    counters, work = _plan.workspace(
        y.device, stream, N,
        2 * slots * N * K * (D * (D + 1) // 2 + 1 + E) if slots > 1 else 0)
    launch(e_stats, 'integration_em', 'integration_stats_launch',
           y_.data_ptr(),
           *[0 if x is None else x.data_ptr() for x in operands],
           scatter.data_ptr(), asum.data_ptr(), res.data_ptr(),
           0 if m2 is None else m2.data_ptr(), work.data_ptr(),
           counters.data_ptr(), N, D, K, T, E, bins_per_utt, ctas, span,
           stages, tile, MODES[spectral_mode], float(spatial_weight),
           float(spectral_weight), float(affiliation_eps), stream)
    return scatter, asum, res, m2
