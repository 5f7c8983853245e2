"""STFT / iSTFT frontend.

Same conventions as ``pb_bss_tpu.transform.stft_module``:

* ``stft``: (..., num_samples) -> (..., T, F) complex, F = size//2+1,
  periodic Blackman window by default,
* ``fading=True`` pads ``size - shift`` zeros on both ends so every
  sample receives full window coverage; ``pad=True`` zero-pads the end
  so the last partial frame is kept,
* iSTFT synthesis uses the biorthogonal window
  ``w / sum_k w^2[n + k*shift]`` (perfect-reconstruction overlap-add).

Built from framing (``unfold``) plus ``torch.fft.rfft``/``irfft`` and a
chunked overlap-add; ``torch.stft`` is not used because its centering
and padding conventions differ.
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import torch

__all__ = ['stft', 'istft', 'stft_frames']


@functools.lru_cache(maxsize=None)
def _get_window(window, size):
    """Periodic window by name ('blackman', 'hann', 'hamming',
    'boxcar'), as scipy.signal.get_window(..., fftbins=True)."""
    return scipy.signal.get_window(window, size, fftbins=True)


def _biorthogonal_window(analysis_window, shift):
    """Synthesis window for perfect-reconstruction overlap-add: the
    analysis window divided by the overlapped sum of squared analysis
    windows at each in-frame position."""
    size = len(analysis_window)
    denominator = np.zeros(size)
    for offset in range(-(size // shift), size // shift + 1):
        shifted = np.zeros(size)
        lo = offset * shift
        src_lo = max(0, lo)
        src_hi = min(size, size + lo)
        if src_lo < src_hi:
            shifted[src_lo - lo:src_hi - lo] = (
                analysis_window[src_lo:src_hi] ** 2)
        denominator += shifted
    return analysis_window / denominator


def _real_float(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def stft_frames(num_samples, size=512, shift=128, *, fading=True,
                pad=True):
    """Number of frames :func:`stft` gives for ``num_samples``."""
    samples = num_samples + (2 * (size - shift) if fading else 0)
    if samples < size:
        return 1
    if pad:
        return int(np.ceil((samples - size + shift) / shift))
    return (samples - size + shift) // shift


def stft(time_signal, size: int = 512, shift: int = 128, *,
         window='blackman', fading: bool = True, pad: bool = True):
    """Short-time Fourier transform.

    Args:
        time_signal: (..., num_samples) real tensor.
        size: frame size == FFT size.
        shift: frame shift (hop).
        window: window name.
        fading: pad ``size - shift`` zeros on both ends.
        pad: zero-pad the end so the last partial frame is kept.
    Returns:
        (..., T, F) complex with F = size // 2 + 1.
    """
    time_signal = torch.as_tensor(time_signal)
    rdtype = _real_float(time_signal.dtype)
    time_signal = time_signal.to(rdtype)
    if fading:
        time_signal = torch.nn.functional.pad(
            time_signal, (size - shift, size - shift))
    samples = time_signal.shape[-1]
    frames = stft_frames(samples, size, shift, fading=False, pad=pad)
    needed = size + (frames - 1) * shift
    if needed > samples:
        time_signal = torch.nn.functional.pad(
            time_signal, (0, needed - samples))
    framed = time_signal[..., :needed].unfold(-1, size, shift)
    w = torch.as_tensor(_get_window(window, size), dtype=rdtype,
                        device=time_signal.device)
    return torch.fft.rfft(framed * w, n=size, dim=-1)


def _overlap_add(framed, size, shift):
    """(..., T, size) -> (..., size + (T-1)*shift) overlap-add.

    When ``shift`` divides ``size`` each frame is ``size/shift``
    contiguous chunks and the sum is ``size/shift`` slice-adds (a fixed
    summation order, unlike an atomic scatter)."""
    frames = framed.shape[-2]
    length = size + (frames - 1) * shift
    lead = framed.shape[:-2]
    if size % shift == 0:
        r = size // shift
        sub = framed.reshape(*lead, frames, r, shift)
        acc = framed.new_zeros(*lead, frames + r - 1, shift)
        for i in range(r):
            acc[..., i:i + frames, :] += sub[..., :, i, :]
        return acc.reshape(*lead, length)
    starts = torch.arange(frames, device=framed.device) * shift
    idx = (starts[:, None]
           + torch.arange(size, device=framed.device)[None, :]).reshape(-1)
    out = framed.new_zeros(*lead, length)
    return out.index_add_(-1, idx, framed.reshape(*lead, -1))


def istft(stft_signal, size: int = 512, shift: int = 128, *,
          window='blackman', fading: bool = True, num_samples: int = None):
    """Inverse STFT with bias-compensated overlap-add.

    Args:
        stft_signal: (..., T, F) complex tensor.
        num_samples: when given, the output is cut/padded to exactly
            that length (after fading removal).
    Returns:
        (..., num_samples) real.
    """
    stft_signal = torch.as_tensor(stft_signal)
    rdtype = (torch.float64 if stft_signal.dtype == torch.complex128
              else torch.float32)
    synthesis = torch.as_tensor(
        _biorthogonal_window(_get_window(window, size), shift),
        dtype=rdtype, device=stft_signal.device)
    framed = torch.fft.irfft(stft_signal, n=size, dim=-1) * synthesis
    time_signal = _overlap_add(framed, size, shift)
    length = time_signal.shape[-1]
    if fading:
        time_signal = time_signal[
            ..., size - shift: length - (size - shift)]
    if num_samples is not None:
        cur = time_signal.shape[-1]
        if num_samples <= cur:
            time_signal = time_signal[..., :num_samples]
        else:
            time_signal = torch.nn.functional.pad(
                time_signal, (0, num_samples - cur))
    return time_signal
