"""Speech-to-Reverberation Modulation energy Ratio (SRMR).

Capability parity with ``pb_bss/evaluation/module_srmr.py``, which is
itself a reimplementation of the MATLAB SRMR toolbox
(https://github.com/MuSAELab/SRMRToolbox): VAD preprocessing
(reference :158-186), gammatone filterbank, Hilbert envelopes, 8
modulation filters, Hamming-windowed segment energies and the
ERB-bandwidth cutoff logic (:42-154). Like the reference, the
ASL-adjustment is omitted (deviation from MATLAB typically < 1e-3).

The port's own copy of ``pb_bss_tpu.evaluation.module_srmr``: the
host oracle of :mod:`.module_srmr_device`, host NumPy end to end, its
gammatone stage the ``scipy.signal.lfilter`` cascade of
:func:`..transform.gammatone.gammatone_filterbank` (``device=False``).
"""
from __future__ import annotations

import math

import numpy as np
import scipy.signal

from ..transform.gammatone import calculate_cfs, gammatone_filterbank

__all__ = ['srmr']


def _segment_axis(x, length, shift):
    """(..., T) -> (num_segments, length) sliding windows."""
    n = 1 + (len(x) - length) // shift if len(x) >= length else 0
    idx = np.arange(length)[None, :] + shift * np.arange(n)[:, None]
    return x[idx]


def srmr(signal, sample_rate: int = 16000, n_cochlear_filters: int = 23,
         low_freq: int = 125):
    """SRMR with independent leading axes (reference :8-39)."""
    signal = np.asarray(signal)
    if signal.ndim >= 2:
        for i in range(signal.ndim - 1):
            assert signal.shape[i] < 30, (i, signal.shape)
        return np.array([
            SRMR(signal[i], sample_rate=sample_rate,
                 n=n_cochlear_filters, low_freq=low_freq)
            for i in np.ndindex(*signal.shape[:-1])
        ]).reshape(signal.shape[:-1])
    elif signal.ndim == 1:
        return SRMR(signal, sample_rate=sample_rate,
                    n=n_cochlear_filters, low_freq=low_freq)
    raise NotImplementedError(signal.ndim)


def SRMR(signal, sample_rate: int = 16000, n: int = 23,
         low_freq: int = 125) -> float:
    """Single-signal SRMR (reference :42-154)."""
    signal = _preprocessing_vad(np.asarray(signal, float), sample_rate)
    signal = signal - np.mean(signal)
    signal = signal / np.std(signal, keepdims=True)

    # cochlear decomposition + temporal envelopes: the host cascade,
    # since this oracle is host-side end to end (hilbert, lfilter,
    # windowed energies)
    bands = gammatone_filterbank(
        signal, sample_rate=sample_rate, n=n, low_freq=low_freq,
        device=False)
    envelopes = np.abs(scipy.signal.hilbert(bands, axis=-1))

    modulation_filter_frequencies = [
        4.0, 6.5, 10.7, 17.6, 28.9, 47.5, 78.1, 128.0]

    # 8 band-pass modulation filters on each envelope
    frame = int(sample_rate / 1000) * 256
    shift = int(sample_rate / 1000) * 64
    hamm = scipy.signal.windows.hamming(frame, sym=True)

    means = np.zeros((n, 8))
    for k, f_mod in enumerate(modulation_filter_frequencies):
        W0 = math.tan(2 * math.pi * f_mod / (2 * sample_rate))
        B0 = W0 / 2
        b = np.array([B0 / (1 + B0 + W0 ** 2), 0,
                      -B0 / (1 + B0 + W0 ** 2)])
        a = np.array([1, (2 * W0 ** 2 - 2) / (1 + B0 + W0 ** 2),
                      (1 - B0 + W0 ** 2) / (1 + B0 + W0 ** 2)])
        filtered = scipy.signal.lfilter(b, a, envelopes, axis=-1)
        for j in range(n):
            segments = _segment_axis(filtered[j], frame, shift)
            energies = np.sum((hamm * segments) ** 2, axis=-1)
            means[j, k] = np.mean(energies)

    # ERB bandwidth from the cumulative per-cochlear-band energy
    cfs = calculate_cfs(low_freq, sample_rate / 2, n)
    ERBs = cfs / 9.26449 + 24.7

    total_energy = np.sum(means)
    AC_perc = np.sum(means, axis=1) * 100 / total_energy
    cumulative = 0.0
    BW = 0.0
    for i in range(len(AC_perc)):
        cumulative += AC_perc[i]
        if cumulative > 90:
            BW = ERBs[i]
            break

    # modulation-band cutoffs
    cutoffs = []
    for f_mod in modulation_filter_frequencies:
        w0 = 2 * math.pi * f_mod / sample_rate
        B0 = math.tan(w0 / 2) / 2
        cutoffs.append(f_mod - (B0 * sample_rate / (2 * math.pi)))

    per_mod = np.sum(means, axis=0)
    numerator = np.sum(per_mod[:4])
    denominator = per_mod[4]
    for i in range(5, 8):
        denominator += per_mod[i]
        if cutoffs[i - 1] < BW < cutoffs[i]:
            break
    return numerator / denominator


def _preprocessing_vad(signal, sample_rate=16000):
    """Remove long silent gaps (reference :158-186).

    Vectorized: the reference iterates over every above-threshold
    sample in Python (O(N) interpreter work); the gap detection here
    is one ``np.diff`` and the splice one ``np.concatenate`` over the
    kept segments, with identical output.
    """
    max_val = np.abs(signal).max()
    threshold = (max_val ** 2) / (10 ** 5)
    L = np.where(np.abs(signal) > threshold)[0]
    window_width = 0.05 * sample_rate

    if len(L) < 2:
        return signal
    gap_at = np.flatnonzero(np.diff(L) > window_width)
    if len(gap_at) == 0:
        return signal
    starts = L[gap_at]        # last sample kept before each gap
    ends = L[gap_at + 1]      # first sample kept after each gap
    pieces = [signal[:starts[0] + 1]]
    for i in range(len(gap_at) - 1):
        pieces.append(signal[ends[i]:starts[i + 1] + 1])
    pieces.append(signal[ends[-1]:])
    return np.concatenate(pieces)
