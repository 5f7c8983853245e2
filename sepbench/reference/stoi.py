"""Short-Time Objective Intelligibility (Taal et al. 2011) in float64
NumPy, with pystoi's constants (10 kHz processing rate, 256/128 frames,
512-point FFT, 15 third-octave bands from 150 Hz, 384 ms segments,
-15 dB clipping, 40 dB silent-frame range). A copy of the system's
float64 host oracle, kept here so that the yardstick cannot move with
the program.
"""
from __future__ import annotations

import numpy as np
import scipy.signal

__all__ = ['stoi']

FS = 10000
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N_SEG = 30
BETA = -15.0
DYN_RANGE = 40.0


def _thirdoct(fs, nfft, num_bands, min_freq):
    f = np.linspace(0, fs, nfft + 1)[:nfft // 2 + 1]
    k = np.arange(num_bands, dtype=float)
    cf = 2.0 ** (k / 3) * min_freq
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_ii = int(np.argmin((f - freq_low[i]) ** 2))
        fh_ii = int(np.argmin((f - freq_high[i]) ** 2))
        obm[i, fl_ii:fh_ii] = 1
    return obm, cf


def _frame(x, frame_len, hop):
    n = 1 + (len(x) - frame_len) // hop if len(x) >= frame_len else 0
    idx = np.arange(frame_len)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def _remove_silent_frames(x, y, dyn_range, frame_len, hop):
    w = np.hanning(frame_len + 2)[1:-1]
    x_frames = _frame(x, frame_len, hop) * w
    y_frames = _frame(y, frame_len, hop) * w
    energies = 20 * np.log10(
        np.linalg.norm(x_frames, axis=1) + np.finfo(float).eps)
    mask = energies > np.max(energies) - dyn_range
    x_frames = x_frames[mask]
    y_frames = y_frames[mask]

    def overlap_add(frames):
        n = (len(frames) - 1) * hop + frame_len
        out = np.zeros(n)
        for i, frame in enumerate(frames):
            out[i * hop:i * hop + frame_len] += frame
        return out

    if len(x_frames) == 0:
        raise ValueError('Not enough non-silent frames for STOI.')
    return overlap_add(x_frames), overlap_add(y_frames)


def _band_magnitudes(x, obm):
    w = np.hanning(N_FRAME + 2)[1:-1]
    frames = _frame(x, N_FRAME, N_FRAME // 2) * w
    spec = np.fft.rfft(frames, NFFT, axis=-1)  # (T, F)
    power = np.abs(spec) ** 2
    return np.sqrt(power @ obm.T).T  # (bands, T)


def _stoi_single(reference, estimation, sample_rate):
    reference = np.asarray(reference, float)
    estimation = np.asarray(estimation, float)
    assert reference.shape == estimation.shape, (
        reference.shape, estimation.shape)

    if sample_rate != FS:
        reference = scipy.signal.resample_poly(reference, FS, sample_rate)
        estimation = scipy.signal.resample_poly(estimation, FS, sample_rate)

    reference, estimation = _remove_silent_frames(
        reference, estimation, DYN_RANGE, N_FRAME, N_FRAME // 2)

    obm, _ = _thirdoct(FS, NFFT, NUMBAND, MINFREQ)
    x_tob = _band_magnitudes(reference, obm)  # (bands, T)
    y_tob = _band_magnitudes(estimation, obm)

    T = x_tob.shape[-1]
    if T < N_SEG:
        raise ValueError(
            f'Signal too short for STOI: {T} < {N_SEG} frames.')

    c = 10 ** (-BETA / 20)
    d_sum = 0.0
    count = 0
    for m in range(N_SEG, T + 1):
        x_seg = x_tob[:, m - N_SEG:m]
        y_seg = y_tob[:, m - N_SEG:m]
        alpha = np.sqrt(
            np.sum(x_seg ** 2, axis=1, keepdims=True)
            / (np.sum(y_seg ** 2, axis=1, keepdims=True)
               + np.finfo(float).eps))
        y_prime = np.minimum(alpha * y_seg, x_seg * (1 + c))
        x_n = x_seg - np.mean(x_seg, axis=1, keepdims=True)
        y_n = y_prime - np.mean(y_prime, axis=1, keepdims=True)
        x_n = x_n / (np.linalg.norm(x_n, axis=1, keepdims=True)
                     + np.finfo(float).eps)
        y_n = y_n / (np.linalg.norm(y_n, axis=1, keepdims=True)
                     + np.finfo(float).eps)
        d_sum += np.sum(x_n * y_n)
        count += NUMBAND
    return d_sum / count


def stoi(reference, estimation, sample_rate):
    """STOI with independent leading axes (reference wrapper
    module_stoi.py:4-25).

    Args:
        reference / estimation: (..., num_samples).
        sample_rate: input sampling rate (resampled to 10 kHz).
    Returns:
        intelligibility in [~0, 1], shape (...,).
    """
    estimation, reference = np.broadcast_arrays(estimation, reference)
    if reference.ndim >= 2:
        return np.array([
            stoi(x_entry, y_entry, sample_rate=sample_rate)
            for x_entry, y_entry in zip(reference, estimation)
        ])
    return _stoi_single(reference, estimation, sample_rate)
