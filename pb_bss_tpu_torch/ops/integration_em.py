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

A CTA owns one (bin, time chunk) and writes its own partial sums, which
the wrapper adds in a fixed order. What bounds it on the H100: the bytes
of y and the embedding, read once per pass (~20 MB at F=513, T=300, D=6,
E=20: ~6 us at 3.35 TB/s), against ~1 kFLOP a frame.

Gate (:func:`fits`): D <= 16 (the JAX package's bound) and the CTA's
working set within the 227 KB of
shared memory a block may opt into; the working set holds one tile of
frames, so T is unlimited (the JAX package's VMEM budget,
``choose_tile_f``, had a T limit). E <= 1024 passes the budget at D=6.

On a CPU tensor the wrapper runs the plain PyTorch twin,
:func:`e_stats_reference`. On a CUDA tensor it launches the kernel or
raises; it never falls back.
"""
from __future__ import annotations

import torch

from .._dtypes import tiny as _tiny
from ._build import SMEM_LIMIT

__all__ = ['e_stats', 'e_stats_reference', 'smem_bytes', 'fits', 'MODES']

TILE = 256  # frames per shared-memory tile (integration::kTile)
MODES = {'vmf': 0, 'gaussian': 1}
# CTAs a pass aims for: 132 SMs x a few resident CTAs
_TARGET_CTAS = 2048


def smem_bytes(D, K, E):
    """Shared memory one CTA needs (csrc/integration_em.cu)."""
    P = D * (D + 1) // 2
    return 8 * (D * TILE + K * D * D + K * P) + 4 * (
        E * TILE + 2 * K * TILE + 4 * K * E + 5 * K + K * D)


def fits(D, K, E):
    """Does the statistics kernel take (D, K, E)? Saliency is read from
    device memory frame by frame and T is walked in tiles, so neither
    changes the budget."""
    return D <= 16 and smem_bytes(D, K, E) <= SMEM_LIMIT


def _chunking(N, T):
    """(splits, chunk): each bin's frames cut into ``splits`` chunks of
    ``chunk`` frames (a multiple of the tile; every chunk holds at least
    one frame)."""
    tiles = max(1, -(-T // TILE))
    splits = min(tiles, max(1, -(-_TARGET_CTAS // max(N, 1))))
    chunk_tiles = -(-tiles // splits)
    return -(-tiles // chunk_tiles), chunk_tiles * TILE


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
        return x.resolve_conj().to(dtype).contiguous()

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
    y_ = y.resolve_conj().contiguous()
    splits, chunk = _chunking(N, T)
    f32 = dict(dtype=torch.float32, device=y.device)
    scatter = torch.empty((splits, N, K, D, D), dtype=torch.complex64,
                          device=y.device)
    asum = torch.empty((splits, N, K), **f32)
    res = torch.empty((splits, N, K, E), **f32)
    m2 = torch.empty((splits, N, K, E), **f32) if gaussian else None
    if N and T:
        from ._build import load
        err = load('integration_em').integration_stats_launch(
            y_.data_ptr(),
            *[0 if x is None else x.data_ptr() for x in operands],
            scatter.data_ptr(), asum.data_ptr(), res.data_ptr(),
            0 if m2 is None else m2.data_ptr(), N, D, K, T, E, bins_per_utt,
            splits, chunk, MODES[spectral_mode], float(spatial_weight),
            float(spectral_weight), float(affiliation_eps),
            torch.cuda.current_stream(y.device).cuda_stream)
        if err:
            raise RuntimeError(
                f'integration e_stats kernel launch failed: CUDA error {err}')
        e_stats.launches += 1
    else:
        for x in (scatter, asum, res, m2):
            if x is not None:
                x.zero_()
    # the second pass of the reduction: the split partials, in order
    return (scatter.sum(0), asum.sum(0), res.sum(0),
            None if m2 is None else m2.sum(0))


e_stats.launches = 0
