"""Device BSS-Eval v3 "sources" in torch ops.

Counterpart of ``pb_bss_tpu.evaluation.module_bss_eval_device``: the
algorithm of the float64 host oracle (:mod:`.module_bss_eval`, the
[Vincent2006] decomposition against 512-tap least-squares FIR
projections) as batched tensor programs, so that a batch of utterances
is scored on the card where it was separated.

- The block-Toeplitz Gram of the delayed references is assembled from
  FFT circular correlations with a constant diagonal-offset index map
  (:func:`_toeplitz_last`), factorized once per utterance and shared by
  every (estimate, reference) pair; the single-reference Grams are its
  diagonal blocks.
- The Cholesky runs at the input dtype on a relatively loaded copy
  (``_JITTER_F32`` of the mean diagonal at float32, ``_JITTER_F64`` at
  float64), and two iterative-refinement steps against the *unloaded*
  Gram remove the loading bias (:func:`_refined_solve`): a speech Gram
  is ill-conditioned at float32. The same loading keeps a duplicate
  reference finite, where the host falls back to lstsq.
- ``torch.linalg.cholesky_ex`` / ``solve_triangular`` do the
  factorization and solves without a host sync; a Gram that is not
  positive definite even when loaded gives NaN, as in the JAX package.
- The permutation search scores the static table
  ``permutations(range(M), K)`` by an index gather and takes the first
  maximum of the mean SIR, as the host does. M = K + 1 estimates route
  the extra (noise) estimate like the host ``mir_eval_sources``.
- The Gram products and the refinement run inside
  ``models._precision.full_fp32``: TF32 would corrupt the refinement.

:func:`bss_eval_sources_batch` scores (..., K, T) batches in one pass
and one device-to-host copy; :func:`bss_eval_sources_device` is the
single-utterance drop-in for the host ``bss_eval_sources``.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from .._device import as_real_tensor, real_float, resolve_device
from ..models._precision import full_fp32

__all__ = [
    'bss_eval_sources_device',
    'bss_eval_sources_batch',
    'mir_eval_sources_batch',
]

# Relative diagonal loading of the Gram factorization per dtype. The
# refinement steps solve against the unloaded Gram, so this only needs
# to make the Cholesky finite and a good preconditioner.
_JITTER_F32 = 1e-5
_JITTER_F64 = 1e-12
_REFINEMENT_STEPS = 2


def _next_pow2(n):
    return int(2 ** np.ceil(np.log2(n)))


@functools.lru_cache(maxsize=8)
def _toeplitz_index(flen, device):
    a = torch.arange(flen, device=device)
    return flen - 1 + (a[None, :] - a[:, None])


def _toeplitz_last(ssf, flen):
    """Toeplitz matrices ``T[..., a, b] = ssf[..., (b - a) % n]`` from
    circular correlations ``ssf`` (..., n), n >= 2 * flen - 1."""
    ext = torch.cat([ssf[..., -(flen - 1):], ssf[..., :flen]], -1)
    return ext[..., _toeplitz_index(flen, ssf.device)]


def _loaded_cholesky(gram, jitter_rel):
    d = gram.shape[-1]
    load = jitter_rel * (
        gram.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] / d)
    eye = torch.eye(d, dtype=gram.dtype, device=gram.device)
    chol, info = torch.linalg.cholesky_ex(gram + load * eye)
    # not positive definite even when loaded: NaN, as jnp's cholesky
    return torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, float('nan')))


def _cho_solve(chol, rhs):
    """Solve ``G x = rhs`` given ``G = L L^T``; rhs (..., d, m)."""
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def _refined_solve(gram, chol, rhs, steps):
    """Cholesky solve + ``steps`` iterative-refinement sweeps against
    the (unloaded) ``gram``."""
    x = _cho_solve(chol, rhs)
    for _ in range(steps):
        x = x + _cho_solve(chol, rhs - gram @ x)
    return x


def _db(num, den):
    # den == 0 -> inf (host _safe_db); num == 0 -> -inf via log10
    return 10 * torch.log10(torch.where(
        den == 0, torch.full_like(num, float('inf')), num / den))


def _criteria(refs, ests, flen, diagonal_only):
    """SDR/SIR/SAR of every (estimate, reference) pairing.

    Args:
        refs: (B, K, T) real references.
        ests: (B, M, T) real estimates (M == K or K + 1).
        flen: distortion-filter length.
        diagonal_only: score only the aligned pairing; requires M == K.
    Returns:
        (sdr, sir, sar) of shape (B, M, K), or (B, M) when
        diagonal_only.
    """
    B, K, ns = refs.shape
    M = ests.shape[1]
    trunc = ns + flen - 1
    n_fft = _next_pow2(trunc)
    jitter = _JITTER_F64 if refs.dtype == torch.float64 else _JITTER_F32

    sf = torch.fft.rfft(refs, n=n_fft)                    # (B, K, nf)
    sef = torch.fft.rfft(ests, n=n_fft)                   # (B, M, nf)

    # Gram of all 0..flen-1 delays of the references: circular
    # correlations -> block Toeplitz (B, K, K, flen, flen).
    ssf = torch.fft.irfft(sf[:, :, None] * sf[:, None].conj(), n=n_fft)
    blocks = _toeplitz_last(ssf, flen)
    gram = blocks.permute(0, 1, 3, 2, 4).reshape(B, K * flen, K * flen)
    diag = torch.arange(K, device=refs.device)
    diag_blocks = blocks[:, diag, diag]                   # (B, K, fl, fl)

    # rhs[b, m, i, a] = <est_m, ref_i(. - a)>: (B, M, K, flen)
    ssef = torch.fft.irfft(sf[:, None] * sef[:, :, None].conj(),
                           n=n_fft)
    rhs = torch.cat([ssef[..., :1],
                     ssef[..., -(flen - 1):].flip(-1)], -1)

    # full-subspace projections, one shared factorization
    chol_full = _loaded_cholesky(gram, jitter)
    c_full = _refined_solve(
        gram, chol_full, rhs.reshape(B, M, K * flen).mT,
        _REFINEMENT_STEPS)                                # (B, K*fl, M)
    c_full = c_full.mT.reshape(B, M, K, flen)
    pall = torch.fft.irfft(
        (torch.fft.rfft(c_full, n=n_fft) * sf[:, None]).sum(2),
        n=n_fft)[..., :trunc]                             # (B, M, trunc)

    chol_single = _loaded_cholesky(diag_blocks, jitter)   # (B, K, fl, fl)
    ests_pad = torch.nn.functional.pad(ests, (0, flen - 1))

    if diagonal_only:
        # p1[b, m]: projection of estimate m onto reference m's delays
        r = rhs[:, diag, diag][..., None]                 # (B, K, fl, 1)
        c = _refined_solve(diag_blocks, chol_single, r,
                           _REFINEMENT_STEPS)[..., 0]
        p1 = torch.fft.irfft(torch.fft.rfft(c, n=n_fft) * sf,
                             n=n_fft)[..., :trunc]        # (B, M, trunc)
        s_filt = (p1 ** 2).sum(-1)
        e_sum = ((ests_pad - p1) ** 2).sum(-1)
        e_interf = ((pall - p1) ** 2).sum(-1)
        e_artif = ((ests_pad - pall) ** 2).sum(-1)
        pall_e = (pall ** 2).sum(-1)
        return (_db(s_filt, e_sum), _db(s_filt, e_interf),
                _db(pall_e, e_artif))

    # p1[b, m, j]: projection of estimate m onto reference j's delays
    c = _refined_solve(diag_blocks, chol_single, rhs.permute(0, 2, 3, 1),
                       _REFINEMENT_STEPS)                 # (B, K, fl, M)
    p1 = torch.fft.irfft(
        torch.fft.rfft(c.permute(0, 3, 1, 2), n=n_fft) * sf[:, None],
        n=n_fft)[..., :trunc]                             # (B, M, K, trunc)
    s_filt = (p1 ** 2).sum(-1)                            # (B, M, K)
    e_sum = ((ests_pad[:, :, None] - p1) ** 2).sum(-1)
    e_interf = ((pall[:, :, None] - p1) ** 2).sum(-1)
    e_artif = ((ests_pad - pall) ** 2).sum(-1)            # (B, M)
    pall_e = (pall ** 2).sum(-1)
    sar = _db(pall_e, e_artif)[..., None].expand(B, M, K)
    return _db(s_filt, e_sum), _db(s_filt, e_interf), sar


@functools.lru_cache(maxsize=16)
def _permutation_table(m, k, device):
    return torch.tensor(list(itertools.permutations(range(m), k)),
                        device=device)


def _select_permutation(sdr, sir, sar):
    """Max-mean-SIR selection over ``permutations(range(M), K)`` (the
    first maximum, as the host's ``np.argmax``); (B, M, K) matrices ->
    (B, K) metric vectors and the (B, K) selection."""
    B, M, K = sir.shape
    table = _permutation_table(M, K, sir.device)          # (P, K)
    columns = torch.arange(K, device=sir.device)
    best = sir[:, table, columns].mean(-1).argmax(-1)     # (B,)
    selection = table[best]                               # (B, K)
    index = selection[:, None, :]

    def pick(mat):
        return mat.gather(1, index)[:, 0]

    return pick(sdr), pick(sir), pick(sar), selection


def _bss_eval_core(refs, ests, *, flen, compute_permutation):
    """(B, K, T), (B, M, T) -> (sdr, sir, sar, selection), each (B, K);
    the diagonal pairing alone (M == K) when ``compute_permutation`` is
    False."""
    with full_fp32():
        if compute_permutation:
            return _select_permutation(*_criteria(
                refs, ests, flen, diagonal_only=False))
        sdr, sir, sar = _criteria(refs, ests, flen, diagonal_only=True)
    B, K = sdr.shape
    selection = torch.arange(K, device=refs.device).expand(B, K)
    return sdr, sir, sar, selection


def _check_shapes(refs, ests, compute_permutation):
    assert refs.ndim >= 2 and ests.ndim == refs.ndim, (
        refs.shape, ests.shape)
    K, T = refs.shape[-2:]
    M = ests.shape[-2]
    assert ests.shape[-1] == T, (refs.shape, ests.shape)
    assert ests.shape[:-2] == refs.shape[:-2], (refs.shape, ests.shape)
    assert M in (K, K + 1), (refs.shape, ests.shape)
    if compute_permutation:
        assert K < 8, (refs.shape, 'K! permutation search')
    elif M != K:
        raise NotImplementedError(compute_permutation, 'with K + 1')
    return K, M, T


def _inputs(reference, estimation, device):
    device = resolve_device(device)
    dtype = real_float(reference, estimation)
    return (as_real_tensor(reference, device, dtype),
            as_real_tensor(estimation, device, dtype))


def bss_eval_sources_batch(reference, estimation,
                           compute_permutation=True,
                           filter_length=512, device='cuda'):
    """Batched BSS-Eval: one pass over the whole batch on ``device``
    and one device-to-host copy of the results.

    Args:
        reference: (..., K, T) real references (tensor or array).
        estimation: (..., M, T) with M in {K, K+1}; when M == K + 1 the
            permutation search routes the extra (noise) estimate like
            the host ``mir_eval_sources``.
        device: where to compute ('cuda' by default; raises without
            CUDA). float64 inputs compute in float64, others in float32.
    Returns:
        dict with 'sdr', 'sir', 'sar' (..., K) and 'selection' (..., K)
        numpy arrays.
    """
    refs, ests = _inputs(reference, estimation, device)
    K, M, T = _check_shapes(refs, ests, compute_permutation)
    lead = tuple(refs.shape[:-2])
    sdr, sir, sar, sel = _bss_eval_core(
        refs.reshape(-1, K, T), ests.reshape(-1, M, T),
        flen=filter_length, compute_permutation=compute_permutation)
    packed = torch.stack([sdr, sir, sar, sel.to(sdr.dtype)], 1)
    packed = packed.cpu().numpy()                         # (B, 4, K)
    out = {name: packed[:, i].reshape(lead + (K,))
           for i, name in enumerate(('sdr', 'sir', 'sar'))}
    out['selection'] = np.rint(packed[:, 3]).astype(np.int64).reshape(
        lead + (K,))
    return out


def bss_eval_sources_device(reference_sources, estimated_sources,
                            compute_permutation=True,
                            filter_length=512, device='cuda'):
    """Drop-in for the host ``bss_eval_sources`` on ``device``.

    Args:
        reference_sources: (K, T) real.
        estimated_sources: (K, T) real (use
            :func:`mir_eval_sources_batch` for K+1 estimates).
    Returns:
        (sdr, sir, sar, perm) numpy arrays of shape (K,).
    """
    refs = torch.as_tensor(reference_sources)
    ests = torch.as_tensor(estimated_sources)
    refs, ests = (x if x.ndim > 1 else x[None] for x in (refs, ests))
    assert refs.shape == ests.shape, (refs.shape, ests.shape)
    out = bss_eval_sources_batch(
        refs[None], ests[None], compute_permutation=compute_permutation,
        filter_length=filter_length, device=device)
    return tuple(out[key][0] for key in ('sdr', 'sir', 'sar', 'selection'))


def mir_eval_sources_batch(reference, estimation, return_dict=True,
                           compute_permutation=True, device='cuda'):
    """Device analog of ``mir_eval_sources`` for batched inputs (same
    K-vs-K and K+1-vs-K semantics, one pass)."""
    out = bss_eval_sources_batch(
        reference, estimation, compute_permutation=compute_permutation,
        device=device)
    if return_dict:
        if not compute_permutation:
            out.pop('selection')
        return out
    if compute_permutation:
        return out['sdr'], out['sir'], out['sar'], out['selection']
    return out['sdr'], out['sir'], out['sar']
