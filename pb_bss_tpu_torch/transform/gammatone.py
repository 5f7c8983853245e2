"""Gammatone filterbank (Apple TR #35 coefficients).

Counterpart of ``pb_bss_tpu.transform.gammatone``: 4th-order gammatone
filters as a cascade of four second-order sections with ERB-spaced
center frequencies, designed on the host in float64 by the same code.
Three routes:

* ``'fft'`` (default): each band is one linear FFT convolution against
  the cascade's impulse response, computed on the host in float64 and
  truncated to the signal length (exact ``lfilter`` semantics for a
  finite zero-state signal: only lags < T contribute), with one shared
  forward ``torch.fft.rfft`` of the signal. The filter spectra are
  uploaded once per (length, dtype, device).
* ``'scan'``: each section through the doubling-scan biquad
  (:mod:`.filters`) with the ``n`` filters batched along a leading axis
  by per-filter coefficient tensors; no per-length state.
* ``device=False``: the same cascade through ``scipy.signal.lfilter``
  on the host (NumPy in, NumPy out); the host SRMR oracle uses it.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._device import as_real_tensor, resolve_device
from .filters import biquad_filter

__all__ = ['gammatone_filterbank', 'calculate_cfs']


def Hz_2_ERBS(f):
    return 21.4 * math.log(0.00437 * f + 1, 10)


def ERBS_2_Hz(f):
    return (10 ** (f / 21.4) - 1) / 0.00437


def calculate_cfs(low_f, high_f, n):
    """n center frequencies linearly spaced on the ERBS scale in
    [low_f, high_f); high_f itself is excluded."""
    low = Hz_2_ERBS(low_f)
    high = Hz_2_ERBS(high_f)
    step = (high - low) / n
    return np.array([ERBS_2_Hz(low + i * step) for i in range(n)])


def _calculate_coefficients(cfs, sample_rate):
    """Apple TR #35 gammatone coefficients."""
    EarQ = 9.26449
    minBW = 24.7

    T = 1 / sample_rate
    ERB = cfs / EarQ + minBW
    B = 1.019 * 2 * math.pi * ERB

    cos_1 = T * np.cos(2 * cfs * math.pi * T) / np.exp(B * T)
    sin_1 = T * np.sin(2 * cfs * math.pi * T) / np.exp(B * T)

    A0 = T
    A2 = 0.0
    B0 = 1.0
    B1 = -2 * np.cos(2 * cfs * math.pi * T) / np.exp(B * T)
    B2 = np.exp(-2 * B * T)

    A11 = -(cos_1 + (3 + 2 ** 1.5) ** 0.5 * sin_1)
    A12 = -(cos_1 - (3 + 2 ** 1.5) ** 0.5 * sin_1)
    A13 = -(cos_1 + (3 - 2 ** 1.5) ** 0.5 * sin_1)
    A14 = -(cos_1 - (3 - 2 ** 1.5) ** 0.5 * sin_1)

    cos_2 = np.cos(2 * cfs * math.pi * T)
    sin_2 = np.sin(2 * cfs * math.pi * T)

    c_1 = -2 * np.exp(4j * cfs * math.pi * T) * T
    c_2 = 2 * np.exp(-1 * B * T + 2j * cfs * math.pi * T) * T

    dividend = (
        (c_1 + c_2 * (cos_2 - (3 - 2 ** 1.5) ** 0.5 * sin_2))
        * (c_1 + c_2 * (cos_2 + (3 - 2 ** 1.5) ** 0.5 * sin_2))
        * (c_1 + c_2 * (cos_2 - (3 + 2 ** 1.5) ** 0.5 * sin_2))
        * (c_1 + c_2 * (cos_2 + (3 + 2 ** 1.5) ** 0.5 * sin_2))
    )
    divisor = np.power(
        -2 / np.exp(2 * B * T) - 2 * np.exp(4j * cfs * math.pi * T)
        + 2 * (1 + np.exp(4j * cfs * math.pi * T)) / np.exp(B * T),
        4,
    )
    gain = np.abs(dividend / divisor)
    return A0, A11, A12, A13, A14, A2, B0, B1, B2, gain


def _section_coefficients(low_freq, high_freq, n, sample_rate):
    """(4, n, 3) feedforward stages + (n, 3) shared feedback."""
    cfs = calculate_cfs(low_freq, high_freq, n)
    A0, A11, A12, A13, A14, A2, B0, B1, B2, gain = \
        _calculate_coefficients(cfs, sample_rate)
    a = np.stack([np.full(n, B0), B1, B2], -1)  # (n, 3)
    stages = np.stack([
        np.stack([np.full(n, A0) / gain, A11 / gain,
                  np.full(n, A2) / gain], -1),
        np.stack([np.full(n, A0), A12, np.full(n, A2)], -1),
        np.stack([np.full(n, A0), A13, np.full(n, A2)], -1),
        np.stack([np.full(n, A0), A14, np.full(n, A2)], -1),
    ])  # (4, n, 3)
    return stages, a


@functools.lru_cache(maxsize=16)
def _impulse_response_rfft(low_freq, high_freq, n, sample_rate, t,
                           n_fft):
    """Host-f64 cascade impulse responses, truncated to the signal
    length, as rfft spectra (n, n_fft // 2 + 1)."""
    import scipy.signal

    stages, a = _section_coefficients(low_freq, high_freq, n,
                                      sample_rate)
    h = np.zeros((n, t))
    h[:, 0] = 1.0
    for s in range(stages.shape[0]):
        for i in range(n):
            h[i] = scipy.signal.lfilter(stages[s, i], a[i], h[i])
    return np.fft.rfft(h, n_fft)


@functools.lru_cache(maxsize=16)
def _impulse_response_rfft_device(low_freq, high_freq, n, sample_rate,
                                  t, n_fft, dtype, device):
    """The filter spectra as a complex tensor on ``device``, uploaded
    once per signature, not once per call."""
    hf = _impulse_response_rfft(
        low_freq, high_freq, n, sample_rate, t, n_fft)
    return torch.as_tensor(hf).to(device=device, dtype=dtype)


def _next_pow2(n):
    return int(2 ** np.ceil(np.log2(max(n, 2))))


def gammatone_filterbank(signal, sample_rate: int = 16000, n: int = 23,
                         low_freq: int = 125, high_freq: int = 0,
                         device=True, method='fft'):
    """Filter ``signal`` with ``n`` 4th-order gammatone filters.

    Args:
        signal: (..., T) real signal: a tensor (filtered on its device),
            or an array (filtered on the card) when ``device`` is True.
        sample_rate: sampling rate in Hz.
        n: number of filters.
        low_freq: lowest center frequency.
        high_freq: highest center frequency (exclusive); default
            ``sample_rate / 2``.
        device: False runs the cascade through ``scipy.signal.lfilter``
            on the host (NumPy in and out); True filters with torch ops
            on the signal's device (a NumPy signal goes to ``'cuda'``);
            a device name or ``torch.device`` moves the signal there.
        method: ``'fft'`` (default; exact truncated-impulse-response
            convolution, one host design per distinct signal length)
            or ``'scan'`` (doubling-scan IIR; no per-length state).
    Returns:
        (n, ..., T) filtered signals.
    """
    if high_freq == 0:
        high_freq = sample_rate / 2

    if device is False:
        import scipy.signal
        stages, a = _section_coefficients(low_freq, high_freq, n,
                                          sample_rate)
        x = np.broadcast_to(
            np.asarray(signal, float)[None],
            (n,) + np.shape(signal)).copy()
        for s in range(stages.shape[0]):
            for i in range(n):
                x[i] = scipy.signal.lfilter(stages[s, i], a[i], x[i],
                                            axis=-1)
        return x

    target = None if device is True else device
    if target is None and not isinstance(signal, torch.Tensor):
        target = 'cuda'
    signal = as_real_tensor(
        signal, None if target is None else resolve_device(target))
    if method == 'fft':
        t = signal.shape[-1]
        n_fft = _next_pow2(2 * t - 1)
        cdtype = (torch.complex128 if signal.dtype == torch.float64
                  else torch.complex64)
        hf = _impulse_response_rfft_device(
            low_freq, float(high_freq), n, sample_rate, t, n_fft,
            cdtype, signal.device)
        xf = torch.fft.rfft(signal, n_fft)
        hf = hf.reshape((n,) + (1,) * (signal.ndim - 1) + hf.shape[-1:])
        return torch.fft.irfft(xf[None] * hf, n_fft)[..., :t]
    assert method == 'scan', method
    stages, a = _section_coefficients(low_freq, high_freq, n,
                                      sample_rate)
    stages = torch.as_tensor(stages, dtype=signal.dtype,
                             device=signal.device)
    a = torch.as_tensor(a, dtype=signal.dtype, device=signal.device)
    expand = (slice(None),) + (None,) * (signal.ndim - 1)
    x = signal.expand((n,) + signal.shape)
    a_ = tuple(a[:, i][expand] for i in range(3))
    for s in range(stages.shape[0]):
        x = biquad_filter(x, tuple(stages[s, :, i][expand]
                                   for i in range(3)), a_)
    return x
