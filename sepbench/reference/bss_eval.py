"""BSS-Eval (v3 "sources" variant) in float64 NumPy (Vincent, Gribonval,
Fevotte 2006): each estimate is decomposed against 512-tap
least-squares FIR projections onto the delayed references, ``s_target
+ e_interf + e_artif``, and SDR / SIR / SAR are energy ratios of the
decomposition; the permutation maximizes the mean SIR. With one more
estimate than references (the noise class), every (estimate,
reference) pair is scored and the K of the K+1 estimates with the
largest mean SIR are selected.

A copy of the system's float64 host oracle (its results match
mir_eval's to float64 rounding), kept here so that the yardstick cannot
move with the program.
"""
from __future__ import annotations

import itertools

import numpy as np
from scipy.linalg import cho_factor, cho_solve, toeplitz
from scipy.signal import fftconvolve

__all__ = ['bss_eval_sources', 'bss_eval_sources_and_noise', 'criteria']


class _ProjectionContext:
    """Shared correlation/factorization state for all (estimate,
    reference) pairs of one bss_eval call.

    Builds the block-Toeplitz Gram of all 0..flen-1 sample delays of
    the references once (mir_eval's ``G`` inside ``_project``,
    rebuilt there per pair), Cholesky-factorizes it and its diagonal
    blocks, and serves least-squares projections of any estimate onto
    the full subspace or a single reference's delay subspace.
    """

    def __init__(self, reference_sources, flen):
        nsrc, nsampl = reference_sources.shape
        self.flen = flen
        self.nsampl = nsampl
        refs_padded = np.hstack(
            (reference_sources, np.zeros((nsrc, flen - 1))))
        self.n_fft = int(2 ** np.ceil(np.log2(nsampl + flen - 1.0)))
        self.sf = np.fft.rfft(refs_padded, n=self.n_fft, axis=1)
        self.refs = reference_sources

        G = np.zeros((nsrc * flen, nsrc * flen))
        for i in range(nsrc):
            for j in range(i, nsrc):
                ssf = np.fft.irfft(
                    self.sf[i] * np.conj(self.sf[j]), n=self.n_fft)
                ss = toeplitz(
                    np.hstack((ssf[0], ssf[-1:-flen:-1])), r=ssf[:flen])
                G[i * flen:(i + 1) * flen, j * flen:(j + 1) * flen] = ss
                G[j * flen:(j + 1) * flen, i * flen:(i + 1) * flen] = \
                    ss.T
        self.G = G
        self._full = self._try_cho(G)
        self._single = [
            self._try_cho(G[j * flen:(j + 1) * flen,
                            j * flen:(j + 1) * flen])
            for j in range(nsrc)
        ]

    @staticmethod
    def _try_cho(mat):
        try:
            return cho_factor(mat, check_finite=False)
        except np.linalg.LinAlgError:
            return None

    @staticmethod
    def _solve(factor, mat, rhs):
        if factor is not None:
            return cho_solve(factor, rhs, check_finite=False)
        return np.linalg.lstsq(mat, rhs, rcond=None)[0]

    def rhs(self, estimated_source):
        """Cross-correlations of the estimate with every delayed
        reference: (nsrc * flen,)."""
        flen = self.flen
        est_padded = np.hstack((estimated_source, np.zeros(flen - 1)))
        sef = np.fft.rfft(est_padded, n=self.n_fft)
        D = np.empty(self.sf.shape[0] * flen)
        for i in range(self.sf.shape[0]):
            ssef = np.fft.irfft(self.sf[i] * np.conj(sef), n=self.n_fft)
            D[i * flen:(i + 1) * flen] = np.hstack(
                (ssef[0], ssef[-1:-flen:-1]))
        return D

    def _reconstruct(self, coeffs, sources):
        """sproj = sum_i conv(C_i, ref_i), first nsampl+flen-1 samples
        (linear convolution via the already-computed reference FFTs)."""
        flen = self.flen
        cf = np.fft.rfft(coeffs.T, n=self.n_fft, axis=1)
        sproj = np.fft.irfft(
            np.sum(cf * sources, axis=0), n=self.n_fft)
        return sproj[:self.nsampl + flen - 1]

    def project_all(self, D):
        """Projection onto all references' delay subspaces."""
        flen = self.flen
        C = self._solve(self._full, self.G, D).reshape(
            flen, len(self._single), order='F')
        return self._reconstruct(C, self.sf)

    def project_single(self, D, j):
        """Projection onto reference ``j``'s delay subspace."""
        flen = self.flen
        block = slice(j * flen, (j + 1) * flen)
        C = self._solve(
            self._single[j], self.G[block, block], D[block])
        return self._reconstruct(C[:, None], self.sf[j][None])


def _project(reference_sources, estimated_source, flen):
    """Least-squares projection of ``estimated_source`` on the subspace
    spanned by all 0..flen-1 sample delays of ``reference_sources``.

    Args:
        reference_sources: (J, T).
        estimated_source: (T,).
    Returns:
        (T + flen - 1,) projected signal.
    """
    nsrc, nsampl = reference_sources.shape
    reference_sources = np.hstack(
        (reference_sources, np.zeros((nsrc, flen - 1))))
    estimated_source = np.hstack((estimated_source, np.zeros(flen - 1)))
    n_fft = int(2 ** np.ceil(np.log2(nsampl + flen - 1.0)))
    sf = np.fft.fft(reference_sources, n=n_fft, axis=1)
    sef = np.fft.fft(estimated_source, n=n_fft)

    # Gram matrix of the delayed references (block Toeplitz from
    # circular correlations).
    G = np.zeros((nsrc * flen, nsrc * flen))
    for i in range(nsrc):
        for j in range(i, nsrc):
            ssf = np.real(np.fft.ifft(sf[i] * np.conj(sf[j])))
            ss = toeplitz(
                np.hstack((ssf[0], ssf[-1:-flen:-1])), r=ssf[:flen])
            G[i * flen:(i + 1) * flen, j * flen:(j + 1) * flen] = ss
            G[j * flen:(j + 1) * flen, i * flen:(i + 1) * flen] = ss.T

    # cross-correlations between the estimate and delayed references
    D = np.zeros(nsrc * flen)
    for i in range(nsrc):
        ssef = np.real(np.fft.ifft(sf[i] * np.conj(sef)))
        D[i * flen:(i + 1) * flen] = np.hstack(
            (ssef[0], ssef[-1:-flen:-1]))

    try:
        C = np.linalg.solve(G, D).reshape(flen, nsrc, order='F')
    except np.linalg.LinAlgError:
        C = np.linalg.lstsq(G, D, rcond=None)[0].reshape(
            flen, nsrc, order='F')

    sproj = np.zeros(nsampl + flen - 1)
    for i in range(nsrc):
        sproj += fftconvolve(
            C[:, i], reference_sources[i])[:nsampl + flen - 1]
    return sproj


def _bss_decomp_mtifilt(reference_sources, estimated_source, j, flen):
    """Decompose an estimate into
    ``s_true + e_spat + e_interf + e_artif`` w.r.t. reference ``j``."""
    nsampl = estimated_source.size
    s_true = np.hstack((reference_sources[j], np.zeros(flen - 1)))
    e_spat = _project(
        reference_sources[j, np.newaxis, :], estimated_source, flen
    ) - s_true
    e_interf = _project(
        reference_sources, estimated_source, flen) - s_true - e_spat
    e_artif = -s_true - e_spat - e_interf
    e_artif[:nsampl] += estimated_source
    return s_true, e_spat, e_interf, e_artif


def _safe_db(num, den):
    if den == 0:
        return np.inf
    with np.errstate(divide='ignore'):
        return 10 * np.log10(num / den)


def _bss_source_crit(s_true, e_spat, e_interf, e_artif):
    """Energy-ratio criteria of the decomposition."""
    s_filt = s_true + e_spat
    sdr = _safe_db(np.sum(s_filt ** 2),
                   np.sum((e_interf + e_artif) ** 2))
    sir = _safe_db(np.sum(s_filt ** 2), np.sum(e_interf ** 2))
    sar = _safe_db(np.sum((s_filt + e_interf) ** 2),
                   np.sum(e_artif ** 2))
    return sdr, sir, sar


def _criteria_matrix(reference_sources, estimated_sources, flen,
                     diagonal_only=False):
    """SDR/SIR/SAR of every (estimate, reference) pairing with the
    Gram factorizations shared across pairs; (M, K) matrices, or
    (K,) vectors of the diagonal pairing when ``diagonal_only``."""
    ctx = _ProjectionContext(reference_sources, flen)
    M = estimated_sources.shape[0]
    K = reference_sources.shape[0]
    shape = (M,) if diagonal_only else (M, K)
    sdr = np.empty(shape)
    sir = np.empty(shape)
    sar = np.empty(shape)
    zeros = np.zeros(flen - 1)
    for m in range(M):
        D = ctx.rhs(estimated_sources[m])
        pall = ctx.project_all(D)
        est_pad = np.hstack((estimated_sources[m], zeros))
        e_artif = est_pad - pall
        for j in ((m,) if diagonal_only else range(K)):
            p1 = ctx.project_single(D, j)
            s_true = np.hstack((reference_sources[j], zeros))
            e_spat = p1 - s_true
            e_interf = pall - p1
            out = (m,) if diagonal_only else (m, j)
            sdr[out], sir[out], sar[out] = _bss_source_crit(
                s_true, e_spat, e_interf, e_artif)
    return sdr, sir, sar


def bss_eval_sources(reference_sources, estimated_sources,
                     compute_permutation=True, filter_length=512):
    """BSS-Eval SDR/SIR/SAR with time-invariant 512-tap distortion
    filters (algorithm of ``mir_eval.separation.bss_eval_sources``).

    Args:
        reference_sources: (K, T).
        estimated_sources: (K, T).
        compute_permutation: search the K! orderings for the maximum
            mean SIR; otherwise score the diagonal pairing.
    Returns:
        (sdr, sir, sar, perm) arrays of shape (K,); ``perm[j]`` is the
        estimate index assigned to reference j.
    """
    reference_sources = np.atleast_2d(
        np.asarray(reference_sources, np.float64))
    estimated_sources = np.atleast_2d(
        np.asarray(estimated_sources, np.float64))
    assert reference_sources.shape == estimated_sources.shape, (
        reference_sources.shape, estimated_sources.shape)
    nsrc = reference_sources.shape[0]
    assert nsrc < 8, (nsrc, 'K! permutation search')
    assert not np.allclose(reference_sources, 0), \
        'all-silent reference sources'
    assert not np.allclose(estimated_sources, 0), \
        'all-silent estimated sources'

    if compute_permutation:
        sdr, sir, sar = _criteria_matrix(
            reference_sources, estimated_sources, filter_length)
        perms = list(itertools.permutations(range(nsrc)))
        dum = np.arange(nsrc)
        mean_sir = np.array([
            np.mean(sir[list(perm), dum]) for perm in perms])
        popt = np.asarray(perms[np.argmax(mean_sir)])
        idx = (popt, dum)
        return sdr[idx], sir[idx], sar[idx], popt
    else:
        sdr, sir, sar = _criteria_matrix(
            reference_sources, estimated_sources, filter_length,
            diagonal_only=True)
        return sdr, sir, sar, np.arange(nsrc)


def bss_eval_sources_and_noise(reference_sources, estimated_sources):
    """K references vs K+1 estimates: score every (estimate, reference)
    pair, then pick the K-selection of estimates maximizing the mean
    SIR (reference module_mir_eval.py:94-141)."""
    K, T = reference_sources.shape
    assert estimated_sources.shape == (K + 1, T), estimated_sources.shape

    sdr, sir, sar = _criteria_matrix(
        reference_sources, estimated_sources, 512)

    permutations = list(itertools.permutations(range(K + 1), K))
    dum = np.arange(K)
    mean_sir = np.array([
        np.mean(sir[list(p), dum]) for p in permutations])
    optimal_selection = permutations[np.argmax(mean_sir)]
    idx = (list(optimal_selection), dum)
    return sdr[idx], sir[idx], sar[idx], np.asarray(optimal_selection)



def criteria(reference_sources, estimated_sources):
    """(sdr, sir, sar, selection): the (M, K) criteria of every
    (estimate, reference) pair with 512-tap filters, and the K of the M
    estimates (M = K or K + 1) with the largest mean SIR."""
    reference_sources = np.asarray(reference_sources, np.float64)
    estimated_sources = np.asarray(estimated_sources, np.float64)
    sdr, sir, sar = _criteria_matrix(
        reference_sources, estimated_sources, 512)
    K = reference_sources.shape[0]
    permutations = list(itertools.permutations(
        range(estimated_sources.shape[0]), K))
    mean_sir = [np.mean(sir[list(p), np.arange(K)]) for p in permutations]
    return sdr, sir, sar, np.asarray(permutations[int(np.argmax(mean_sir))])
