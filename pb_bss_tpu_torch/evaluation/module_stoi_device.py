"""Device STOI in torch ops.

Counterpart of ``pb_bss_tpu.evaluation.module_stoi_device``: the
measure of the float64 host oracle (:mod:`.module_stoi`) as one batched
tensor program, so a batch of signals is scored without a per-signal
host loop. The two host constructs that change a signal's length are
redesigned, not looped:

- **Resampling** (``scipy.signal.resample_poly``): the anti-aliasing FIR
  is designed on the host once per (up, down, length) with scipy's own
  ``firwin`` parameters (Kaiser 5.0, half_len = 10 * max_rate), so the
  taps match the host oracle's exactly; the polyphase upfirdn becomes
  zero-stuffing, one rfft convolution and a strided slice.
- **Silent-frame removal**: a stable ``argsort`` of the retention mask
  moves the retained frames to the front in their order and a gather
  compacts them; rows past the retained count are zeroed, overlap-add is
  two shifted half-frame adds (frame_len == 2 * hop), and every later
  reduction is masked by the retained count. A signal with no retained
  segment yields NaN (the host raises; a batch cannot).

The band-energy product runs inside ``models._precision.full_fp32``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._device import as_real_tensor, real_float, resolve_device
from ..models._precision import full_fp32
from .module_stoi import (
    BETA,
    DYN_RANGE,
    FS,
    MINFREQ,
    N_FRAME,
    N_SEG,
    NFFT,
    NUMBAND,
    _thirdoct,
)

__all__ = ['stoi_device', 'stoi_batch']

_HOP = N_FRAME // 2


@functools.lru_cache(maxsize=32)
def _resampler_design(up, down, n_in):
    """Host-side replication of scipy.signal.resample_poly's filter
    design and alignment bookkeeping: (up, down, taps, n_pre_remove,
    n_out), constant per signature."""
    import scipy.signal

    g = math.gcd(up, down)
    up //= g
    down //= g
    assert (up, down) != (1, 1)
    n_out = n_in * up
    n_out = n_out // down + bool(n_out % down)

    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = scipy.signal.firwin(
        2 * half_len + 1, 1.0 / max_rate, window=('kaiser', 5.0))
    h = h * up
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    # Ensure the full linear convolution reaches the last kept output
    # sample (scipy's n_post_pad loop, solved in closed form).
    conv_len = (n_in - 1) * up + len(h)
    needed = (n_pre_remove + n_out - 1) * down + 1
    if conv_len < needed:
        h = np.concatenate([h, np.zeros(needed - conv_len)])
    return up, down, h, n_pre_remove, n_out


@functools.lru_cache(maxsize=8)
def _window_and_bands(dtype, device):
    """The analysis window (hanning, zero ends dropped) and the
    third-octave band matrix (bands, NFFT // 2 + 1) on ``device``."""
    obm, _ = _thirdoct(FS, NFFT, NUMBAND, MINFREQ)
    window = np.hanning(N_FRAME + 2)[1:-1]
    return (torch.as_tensor(window, dtype=dtype, device=device),
            torch.as_tensor(obm, dtype=dtype, device=device))


def _resample(x, up, down, h, n_pre_remove, n_out):
    """upfirdn(h, x, up, down) + scipy's alignment slice; x (..., N)."""
    n_in = x.shape[-1]
    up_len = (n_in - 1) * up + 1
    x_up = x.new_zeros(x.shape[:-1] + (up_len,))
    x_up[..., ::up] = x
    n_fft = int(2 ** np.ceil(np.log2(up_len + len(h) - 1)))
    hf = torch.fft.rfft(torch.as_tensor(h, dtype=x.dtype, device=x.device),
                        n=n_fft)
    y = torch.fft.irfft(torch.fft.rfft(x_up, n=n_fft) * hf, n=n_fft)
    return y[..., ::down][..., n_pre_remove:n_pre_remove + n_out]


def _frames(x, num_frames):
    """(..., N) -> (..., num_frames, N_FRAME) with hop N_FRAME/2 via
    two shifted half-frame views."""
    blocks = x[..., :(num_frames + 1) * _HOP].reshape(
        x.shape[:-1] + (num_frames + 1, _HOP))
    return torch.cat([blocks[..., :-1, :], blocks[..., 1:, :]], -1)


def _stoi_core_10k(reference, estimation, window, obm):
    """STOI of (B, N) pairs already at 10 kHz -> (B,)."""
    n = reference.shape[-1]
    num_frames = 1 + (n - N_FRAME) // _HOP
    assert num_frames >= 1, (n, N_FRAME)
    eps = torch.finfo(reference.dtype).eps

    x_frames = _frames(reference, num_frames) * window    # (B, T, 256)
    y_frames = _frames(estimation, num_frames) * window

    # retention mask from the clean signal's frame energies
    energies = 20 * torch.log10(
        torch.linalg.vector_norm(x_frames, dim=-1) + eps)
    mask = energies > energies.max(-1, keepdim=True).values - DYN_RANGE
    n_ret = mask.sum(-1)                                  # (B,)

    # retained frames to the front, in order; the rest zeroed
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    rows = torch.arange(num_frames, device=mask.device)
    keep = (rows < n_ret[:, None]).to(x_frames.dtype)[..., None]
    index = order[..., None].expand(-1, -1, N_FRAME)
    x_c = x_frames.gather(1, index) * keep
    y_c = y_frames.gather(1, index) * keep

    def band_mags(c):
        # overlap-add (frame_len == 2 * hop): signal block i is
        # first_half[i] + second_half[i - 1]; then re-frame
        a, b = c[..., :_HOP], c[..., _HOP:]
        blocks = torch.cat([a[:, :1], a[:, 1:] + b[:, :-1], b[:, -1:]],
                           1)                             # (B, T + 1, HOP)
        frames = torch.cat([blocks[:, :-1], blocks[:, 1:]], -1) * window
        spec = torch.fft.rfft(frames, NFFT)               # (B, T, 257)
        power = spec.real ** 2 + spec.imag ** 2
        return torch.sqrt(power @ obm.T).mT               # (B, bands, T)

    x_tob = band_mags(x_c)
    y_tob = band_mags(y_c)

    # all length-N_SEG sliding segments, masked to the retained count
    # (segment s covers frames s .. s+N_SEG-1, valid iff
    # s + N_SEG <= n_ret; the host loops m in [N_SEG, n_ret])
    num_seg = num_frames - N_SEG + 1
    assert num_seg >= 1, (num_frames, N_SEG)
    x_seg = x_tob.unfold(-1, N_SEG, 1)                    # (B, bands, S, 30)
    y_seg = y_tob.unfold(-1, N_SEG, 1)
    seg_valid = (torch.arange(num_seg, device=mask.device) + N_SEG
                 <= n_ret[:, None]).to(x_tob.dtype)       # (B, S)

    c = 10.0 ** (-BETA / 20)
    alpha = torch.sqrt((x_seg ** 2).sum(-1, keepdim=True)
                       / ((y_seg ** 2).sum(-1, keepdim=True) + eps))
    y_prime = torch.minimum(alpha * y_seg, x_seg * (1 + c))
    x_n = x_seg - x_seg.mean(-1, keepdim=True)
    y_n = y_prime - y_prime.mean(-1, keepdim=True)
    x_n = x_n / (torch.linalg.vector_norm(x_n, dim=-1, keepdim=True) + eps)
    y_n = y_n / (torch.linalg.vector_norm(y_n, dim=-1, keepdim=True) + eps)
    d_seg = (x_n * y_n).sum(-1).sum(1)                    # (B, S)

    d_sum = (d_seg * seg_valid).sum(-1)
    count = NUMBAND * seg_valid.sum(-1)
    # count == 0 (everything silent / too short) -> NaN, not a raise
    return d_sum / torch.where(count == 0, torch.full_like(count, np.nan),
                               count)


def _stoi(reference, estimation, sample_rate):
    """STOI of (..., N) tensor pairs on their device -> (...) tensor."""
    lead, n = reference.shape[:-1], reference.shape[-1]
    refs = reference.reshape(-1, n)
    ests = estimation.reshape(-1, n)
    if sample_rate != FS:
        design = _resampler_design(FS, int(sample_rate), n)
        refs = _resample(refs, *design)
        ests = _resample(ests, *design)
    window, obm = _window_and_bands(refs.dtype, refs.device)
    with full_fp32():
        return _stoi_core_10k(refs, ests, window, obm).reshape(lead)


def stoi_batch(reference, estimation, sample_rate, device='cuda'):
    """Batched device STOI: one pass over the whole batch.

    Args:
        reference / estimation: (..., num_samples) real tensors or
            arrays, broadcastable against each other.
        sample_rate: input sampling rate (resampled to 10 kHz on the
            device with scipy's resample_poly filter).
        device: where to compute ('cuda' by default; raises without
            CUDA). float64 inputs compute in float64, others in float32.
    Returns:
        numpy array of shape (...,); NaN where the host oracle would
        raise (no non-silent segment).
    """
    device = resolve_device(device)
    dtype = real_float(reference, estimation)
    reference = as_real_tensor(reference, device, dtype)
    estimation = as_real_tensor(estimation, device, dtype)
    reference, estimation = torch.broadcast_tensors(reference, estimation)
    return _stoi(reference, estimation, sample_rate).cpu().numpy()


def stoi_device(reference, estimation, sample_rate, device='cuda'):
    """Single-signal drop-in for the host ``stoi`` on ``device``."""
    return float(stoi_batch(
        torch.as_tensor(reference)[None], torch.as_tensor(estimation)[None],
        sample_rate, device=device)[0])
