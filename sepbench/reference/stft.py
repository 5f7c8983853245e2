"""STFT and iSTFT as explicit DFT products.

Framing as the system under test fixes it: ``size - shift`` zeros on
both ends (fading), zeros at the end so the last partial frame is kept,
the periodic Blackman window, and synthesis by the biorthogonal window
``w / sum_k w^2[n + k shift]`` with overlap-add.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .precision import complex_dtype, mm, real_dtype


def blackman(size):
    """The periodic Blackman window (float64)."""
    n = np.arange(size) / size
    return 0.42 - 0.5 * np.cos(2 * np.pi * n) + 0.08 * np.cos(4 * np.pi * n)


def synthesis_window(size, shift):
    window = blackman(size)
    if size % shift:
        raise ValueError(f'shift {shift} must divide size {size}')
    squares = (window ** 2).reshape(size // shift, shift).sum(0)
    return window / np.tile(squares, size // shift)


def stft_frames(num_samples, size, shift):
    padded = num_samples + 2 * (size - shift)
    return max(1, math.ceil((padded - size + shift) / shift))


def _dft(size, precision, device):
    """(size, F) cosine and sine tables of the forward transform."""
    n = np.arange(size)[:, None]
    f = np.arange(size // 2 + 1)[None, :]
    angle = 2 * np.pi * ((n * f) % size) / size
    dtype = real_dtype(precision)
    return (torch.as_tensor(np.cos(angle), dtype=dtype, device=device),
            torch.as_tensor(np.sin(angle), dtype=dtype, device=device))


def stft(signal, size, shift, precision='float64'):
    """(..., N) real -> (..., T, F) complex."""
    dtype = real_dtype(precision)
    signal = signal.to(dtype)
    frames = stft_frames(signal.shape[-1], size, shift)
    needed = size + (frames - 1) * shift
    left = size - shift
    right = needed - signal.shape[-1] - left
    signal = torch.nn.functional.pad(signal, (left, right))
    framed = signal.unfold(-1, size, shift)
    framed = framed * torch.as_tensor(blackman(size), dtype=dtype,
                                      device=signal.device)
    cos, sin = _dft(size, precision, signal.device)
    return torch.complex(mm(framed, cos, precision),
                         -mm(framed, sin, precision))


def istft(spectrum, size, shift, num_samples, precision='float64'):
    """(..., T, F) complex -> (..., num_samples) real. Like an inverse
    real FFT, it reads only the real part of the first and last bin."""
    spectrum = spectrum.to(complex_dtype(precision))
    device = spectrum.device
    F = size // 2 + 1
    n = np.arange(size)[None, :]
    f = np.arange(F)[:, None]
    weight = np.full((F, 1), 2.0)
    weight[0] = weight[-1] = 1.0
    angle = 2 * np.pi * ((n * f) % size) / size
    dtype = real_dtype(precision)
    cos = torch.as_tensor(weight * np.cos(angle) / size, dtype=dtype,
                          device=device)
    sin = torch.as_tensor(-weight * np.sin(angle) / size, dtype=dtype,
                          device=device)
    framed = mm(spectrum.real, cos, precision) \
        + mm(spectrum.imag, sin, precision)
    framed = framed * torch.as_tensor(synthesis_window(size, shift),
                                      dtype=dtype, device=device)
    *lead, T, _ = framed.shape
    r = size // shift
    chunks = framed.reshape(*lead, T, r, shift)
    out = framed.new_zeros(*lead, T + r - 1, shift)
    for i in range(r):
        out[..., i:i + T, :] += chunks[..., :, i, :]
    out = out.reshape(*lead, (T + r - 1) * shift)
    out = out[..., size - shift:out.shape[-1] - (size - shift)]
    if out.shape[-1] >= num_samples:
        return out[..., :num_samples]
    return torch.nn.functional.pad(out, (0, num_samples - out.shape[-1]))


__all__ = ['stft', 'istft', 'stft_frames', 'blackman', 'synthesis_window']
