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
and padding conventions differ. ``method=`` is accepted as in the JAX
package, and every value runs the one FFT path (:func:`_check_method`).
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import torch

from ..utils import profiling

__all__ = ['stft', 'istft', 'stft_frames', 'STFT']


@functools.lru_cache(maxsize=None)
def _named_window(window, size):
    return scipy.signal.get_window(window, size, fftbins=True)


def _get_window(window, size):
    """float64 analysis window: a periodic window by name ('blackman',
    'hann', 'hamming', 'boxcar'), as scipy.signal.get_window(...,
    fftbins=True), or ``window(size)`` for a callable."""
    if callable(window):
        return np.asarray(window(size), np.float64)
    return _named_window(window, size)


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


def _check_method(method):
    """Validate ``method=`` ('auto', 'fft' or 'matmul', the JAX package's
    values). Every value runs ``torch.fft``: the JAX package takes the
    DFT as matrix products on the TPU, whose FFT is latency-bound there;
    on the H100 cuFFT is faster than those products, so they have no
    advantage and the port keeps one path."""
    if method not in ('auto', 'fft', 'matmul'):
        raise ValueError(f"method must be 'auto', 'fft' or 'matmul', got "
                         f'{method!r}')


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


@profiling.span('stft')
def stft(time_signal, size: int = 512, shift: int = 128, *,
         window='blackman', fading: bool = True, pad: bool = True,
         method: str = 'auto'):
    """Short-time Fourier transform.

    Args:
        time_signal: (..., num_samples) real tensor.
        size: frame size == FFT size.
        shift: frame shift (hop).
        window: window name or callable size -> array.
        fading: pad ``size - shift`` zeros on both ends.
        pad: zero-pad the end so the last partial frame is kept.
        method: ``'auto'``, ``'fft'`` or ``'matmul'``, as in the JAX
            package; each runs ``torch.fft.rfft`` (:func:`_check_method`).
    Returns:
        (..., T, F) complex with F = size // 2 + 1.
    """
    _check_method(method)
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


@profiling.span('istft')
def istft(stft_signal, size: int = 512, shift: int = 128, *,
          window='blackman', fading: bool = True, num_samples: int = None,
          method: str = 'auto'):
    """Inverse STFT with bias-compensated overlap-add.

    Args:
        stft_signal: (..., T, F) complex tensor.
        window: window name or callable size -> array (the analysis
            window; synthesis uses its biorthogonal window).
        num_samples: when given, the output is cut/padded to exactly
            that length (after fading removal).
        method: ``'auto'``, ``'fft'`` or ``'matmul'``, as in the JAX
            package; each runs ``torch.fft.irfft`` (:func:`_check_method`).
    Returns:
        (..., num_samples) real.
    """
    _check_method(method)
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


class STFT:
    """Object-style frontend bundling the parameters:
    ``STFT(512, 128)(signal)`` / ``.inverse(Signal)``."""

    def __init__(self, size=512, shift=128, *, window='blackman',
                 fading=True):
        self.size = size
        self.shift = shift
        self.window = window
        self.fading = fading

    def __call__(self, time_signal):
        return stft(time_signal, self.size, self.shift,
                    window=self.window, fading=self.fading)

    def inverse(self, stft_signal, num_samples=None):
        return istft(stft_signal, self.size, self.shift,
                     window=self.window, fading=self.fading,
                     num_samples=num_samples)

    @property
    def frequencies(self):
        return self.size // 2 + 1
