"""Invasive SXR measures (power-based SDR/SIR/SNR from per-source
contribution signals), after Tran Vu's procedure.

Capability parity with ``pb_bss/evaluation/sxr_module.py``:
``get_snr``/``set_snr`` (:26-79), ``input_sxr`` (:94-165) and
``output_sxr`` with the mutual-power selection search (:168-274).
The port's own copy of ``pb_bss_tpu.evaluation.sxr_module`` (host
NumPy: cheap power ratios).
"""
from __future__ import annotations

import collections
import itertools

import numpy as np

__all__ = ['get_snr', 'set_snr', 'input_sxr', 'output_sxr']

ResultTuple = collections.namedtuple('SXR', ['sdr', 'sir', 'snr'])


def get_variance_for_zero_mean_signal(X, axis=None, keepdims=False):
    X = np.asarray(X)
    if np.iscomplexobj(X):
        return np.mean(
            X.real ** 2 + X.imag ** 2, axis=axis, keepdims=keepdims)
    return np.mean(X ** 2, axis=axis, keepdims=keepdims)


def _package(sdr, sir, snr, *, average_sources, return_dict):
    """Shared result shaping: optional speaker average, then either
    the namedtuple or a (possibly prefixed) dict."""
    if average_sources:
        sdr, sir, snr = (np.mean(v, axis=0) for v in (sdr, sir, snr))
    if return_dict:
        prefix = return_dict if isinstance(return_dict, str) else ''
        return {prefix + 'sdr': sdr, prefix + 'sir': sir,
                prefix + 'snr': snr}
    return ResultTuple(sdr, sir, snr)


def get_snr(X, N, *, axis=None, keepdims=False):
    """SNR of time or STFT signals in dB (mean over all given dims).

    >>> print(get_snr([1, 2, 3], [1, 2, 3]))
    0.0
    """
    power_X = get_variance_for_zero_mean_signal(
        X, axis=axis, keepdims=keepdims)
    power_N = get_variance_for_zero_mean_signal(
        N, axis=axis, keepdims=keepdims)
    return 10 * np.log10(power_X / power_N)


def set_snr(X, N, snr, current_snr=None, *, axis=None, inplace=True):
    """Rescale the noise image so the pair has the given SNR
    (reference :52-79). ``inplace`` requires a mutable numpy array."""
    if current_snr is None:
        current_snr = get_snr(X, N, axis=axis, keepdims=True)
    factor = 10 ** (-(snr - current_snr) / 20)
    if inplace:
        N *= factor
        return None
    return X, N * factor


def _sxr(S, X):
    with np.errstate(divide='ignore'):
        return 10 * np.log10(S / X)


def input_sxr(images, noise, average_sources=True, average_channels=True,
              *, return_dict=False):
    """Input SXR from unmixed reverberated images + ground-truth noise.

    Args:
        images: (K, D, T) per-speaker sensor images.
        noise: (D, T) noise image.
    Returns:
        (SDR, SIR, SNR) namedtuple or dict.
    """
    images = np.asarray(images)
    noise = np.asarray(noise)
    K, D, T = images.shape
    assert (D, T) == noise.shape, ((D, T), images.shape, noise.shape)
    assert K < 10, images.shape
    assert D < 30, images.shape

    S = get_variance_for_zero_mean_signal(images, axis=-1)  # (K, D)
    N = get_variance_for_zero_mean_signal(noise, axis=-1)  # (D,)
    # interference for speaker k = sum of the other speakers' power
    I = np.sum(S, axis=0, keepdims=True) - S  # (K, D)

    if average_channels:
        S, I, N = [np.mean(power, axis=-1) for power in (S, I, N)]

    return _package(
        _sxr(S, I + N), _sxr(S, I), _sxr(S, N),
        average_sources=average_sources, return_dict=return_dict)


def output_sxr(image_contribution, noise_contribution,
               average_sources=True, return_dict=False):
    """Output SXR from per-source contribution signals.

    Run the separation system once per clean input (images, noise) with
    fixed parameters; the outputs are the contributions.

    Args:
        image_contribution: (K_source, K_target, T).
        noise_contribution: (K_target, T).
    Returns:
        (SDR, SIR, SNR) per source (or averaged); the target selection
        maximizes the mutual power over all K_target-pick-K_source
        selections (reference :224-242).
    """
    image_contribution = np.asarray(image_contribution)
    noise_contribution = np.asarray(noise_contribution)
    K_source, K_target, samples = image_contribution.shape
    assert noise_contribution.shape == (K_target, samples), (
        image_contribution.shape, noise_contribution.shape)
    assert K_source < 10, image_contribution.shape
    assert K_target < 10, noise_contribution.shape

    S = get_variance_for_zero_mean_signal(image_contribution, axis=-1)
    N = get_variance_for_zero_mean_signal(noise_contribution, axis=-1)

    all_target_selections = np.array(
        list(itertools.permutations(range(K_target), r=K_source)))

    mutual_power = np.array([
        np.sum(S[np.arange(K_source), selection])
        for selection in all_target_selections
    ])
    selection = all_target_selections[np.argmax(mutual_power)]

    SS = S[np.arange(K_source), selection]
    II = np.array([
        np.sum(np.delete(S[:, selection[k]], k, axis=0))
        for k in range(K_source)
    ])
    NN = N[selection]

    return _package(
        _sxr(SS, II + NN), _sxr(SS, II), _sxr(SS, NN),
        average_sources=average_sources, return_dict=return_dict)
