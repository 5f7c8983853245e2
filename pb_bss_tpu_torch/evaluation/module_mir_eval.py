"""mir_eval-compatible BSS evaluation entry.

Capability parity with ``pb_bss/evaluation/module_mir_eval.py``: the
``mir_eval_sources`` wrapper with K-vs-K and **K+1-estimates-vs-K-
references** handling (a custom decomposition over all (est, ref)
pairs plus permutation search maximizing mean SIR, reference :94-141)
and recursion over a channel dimension (:57-78). The core solver is
the native :mod:`.module_bss_eval` (the reference imports mir_eval
here). The port's own copy of ``pb_bss_tpu.evaluation.module_mir_eval``.
"""
from __future__ import annotations

import itertools

import numpy as np

from .module_bss_eval import (
    _criteria_matrix,
    bss_eval_sources,
)

__all__ = ['mir_eval_sources']


def mir_eval_sources(reference, estimation, return_dict=False,
                     compute_permutation=True):
    """BSS-Eval with optional extra (noise) estimate.

    Args:
        reference: (K, ..., T) time signals.
        estimation: (K, ..., T) or (K+1, ..., T) time signals; the
            extra channel lets the permutation search route noise
            correctly even when it is confused with a speaker.
    Returns:
        (sdr, sir, sar, selection); ``selection`` (length K) picks the
        estimated channels corresponding to the references.
    """
    reference = np.asarray(reference)
    estimation = np.asarray(estimation)

    if reference.ndim == 2:
        assert estimation.ndim == 2, estimation.shape
        assert reference.shape[1] == estimation.shape[1], (
            reference.shape, estimation.shape)

        if reference.shape == estimation.shape:
            sdr, sir, sar, selection = bss_eval_sources(
                reference, estimation,
                compute_permutation=compute_permutation)
        elif reference.shape[0] == estimation.shape[0] - 1:
            if not compute_permutation:
                raise NotImplementedError(
                    compute_permutation, 'with K + 1')
            sdr, sir, sar, selection = _bss_eval_sources_and_noise(
                reference, estimation)
        else:
            raise ValueError(
                f'Shapes do not fit: {reference.shape} vs. '
                f'{estimation.shape}')

    elif reference.ndim >= 3:
        assert reference.shape[1:] == estimation.shape[1:], (
            reference.shape, estimation.shape)
        results = np.moveaxis(np.array([
            mir_eval_sources(
                reference[:, d, ..., :],
                estimation[:, d, ..., :],
                compute_permutation=compute_permutation,
            )
            for d in range(reference.shape[1])
        ]), source=0, destination=2)
        if compute_permutation:
            sdr, sir, sar, selection = results
            selection = selection.astype(int)
        else:
            sdr, sir, sar = results[:3]
            selection = None
    else:
        raise ValueError(f'Strange input shape: {reference.shape}')

    if return_dict:
        out = {'sdr': sdr, 'sir': sir, 'sar': sar}
        if compute_permutation:
            out['selection'] = selection
        return out
    if compute_permutation:
        return sdr, sir, sar, selection
    return sdr, sir, sar


def _bss_eval_sources_and_noise(reference_sources, estimated_sources):
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
