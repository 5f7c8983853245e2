"""Device SRMR in torch ops.

Counterpart of ``pb_bss_tpu.evaluation.module_srmr_device``: the measure
of the host oracle (:mod:`.module_srmr`) with its heavy numerics (the
23-band gammatone filterbank, the Hilbert envelopes, the 8 modulation
band-passes and the Hamming-windowed segment energies) batched over
signals on the device, and the two cheap data-dependent stages on the
host, as in the JAX package:

* the VAD preprocessing (its splice changes each signal's length: a
  data-dependent shape by construction), and
* the mean / std normalization of the spliced signal.

Spliced signals are zero-padded to a shared bucket length and carry
their true lengths; every filter is causal, so values inside the valid
range equal the host's, and segment energies are masked to segments
fully inside it. The one approximation against the host is the Hilbert
envelope, computed by an FFT over the bucket instead of the exact
spliced length (the gammatone outputs are zeroed past the valid range
first): a boundary effect, held within rtol 1e-3 of the host.

Both filterbanks run as FFT convolutions against impulse responses
designed on the host in float64 and truncated to the bucket length,
which for a finite zero-state signal is ``lfilter`` exactly. The 8
modulation filters are near-DC band-passes (4-128 Hz) whose pole
sections have DC gains of ~4e5: a float32 *recursion*, sequential or
scanned, amplifies their coefficient rounding into O(1) errors (the JAX
package measured 70x the output error for the 4 Hz filter), so they
never run as one. The gammatone cascade would be safe as a recursion;
its impulse response decays below 1e-20 well inside the bucket.

Signals go through the device in chunks whose working set stays under
``_WORKING_SET_BYTES``; ``chip_smoke.py`` logs the peak it measures.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._device import real_float, resolve_device
from ..transform.gammatone import _impulse_response_rfft, calculate_cfs
from .module_srmr import _preprocessing_vad

__all__ = ['srmr_batch', 'srmr_device']

_MODULATION_FREQS = (4.0, 6.5, 10.7, 17.6, 28.9, 47.5, 78.1, 128.0)
# bound of one chunk's device memory; the estimate per signal is
# _working_set_per_signal
_WORKING_SET_BYTES = 8 << 30


def _modulation_coefficients(sample_rate):
    """(8, 3) feedforward / (8, 3) feedback biquad coefficients of the
    modulation filterbank (host srmr's per-filter scalars, stacked)."""
    bs, as_ = [], []
    for f_mod in _MODULATION_FREQS:
        w0 = math.tan(2 * math.pi * f_mod / (2 * sample_rate))
        b0 = w0 / 2
        norm = 1 + b0 + w0 ** 2
        bs.append([b0 / norm, 0.0, -b0 / norm])
        as_.append([1.0, (2 * w0 ** 2 - 2) / norm,
                    (1 - b0 + w0 ** 2) / norm])
    return np.array(bs), np.array(as_)


def _frame_shift(sample_rate):
    return int(sample_rate / 1000) * 256, int(sample_rate / 1000) * 64


def _n_fft(m):
    return int(2 ** np.ceil(np.log2(2 * m - 1)))


@functools.lru_cache(maxsize=8)
def _design(sample_rate, m, n, low_freq):
    """The host float64 design for a bucket of ``m`` samples: the
    Hamming window, the gammatone and modulation impulse-response
    spectra (n, nf) / (8, nf), the analytic-signal multiplier (m,), the
    ERBs of the bands and the modulation cutoffs."""
    import scipy.signal

    frame, _ = _frame_shift(sample_rate)
    n_fft = _n_fft(m)
    hamm = scipy.signal.windows.hamming(frame, sym=True)
    b_mod, a_mod = _modulation_coefficients(sample_rate)
    impulse = np.zeros(m)
    impulse[0] = 1.0
    h_mod = np.stack([
        scipy.signal.lfilter(b_mod[kf], a_mod[kf], impulse)
        for kf in range(len(_MODULATION_FREQS))])      # (8, m)
    hf_mod = np.fft.rfft(h_mod, n_fft)
    # the 23-band cascade, one combined impulse response per band
    hf_gt = _impulse_response_rfft(
        low_freq, sample_rate / 2, n, sample_rate, m, n_fft)
    erbs = calculate_cfs(low_freq, sample_rate / 2, n) / 9.26449 + 24.7
    cutoffs = np.array([
        f - (math.tan(2 * math.pi * f / sample_rate / 2) / 2
             * sample_rate / (2 * math.pi))
        for f in _MODULATION_FREQS])
    h = np.zeros(m)
    if m % 2 == 0:
        h[0] = h[m // 2] = 1
        h[1:m // 2] = 2
    else:
        h[0] = 1
        h[1:(m + 1) // 2] = 2
    return dict(hamm=hamm, hf_gt=hf_gt, hf_mod=hf_mod, hilbert=h,
                erbs=erbs, cutoffs=cutoffs)


@functools.lru_cache(maxsize=8)
def _device_design(sample_rate, m, n, low_freq, dtype, device):
    cdtype = torch.complex128 if dtype == torch.float64 \
        else torch.complex64
    return {key: torch.as_tensor(value).to(
        device=device, dtype=cdtype if key.startswith('hf') else dtype)
        for key, value in _design(sample_rate, m, n, low_freq).items()}


def _srmr_core(xs, lengths, sample_rate, n, low_freq):
    """SRMR of (C, m) zero-padded spliced signals of true lengths (C,)
    -> (C,)."""
    C, m = xs.shape
    frame, shift = _frame_shift(sample_rate)
    ratio = frame // shift
    n_seg = m // shift - (ratio - 1)
    n_fft = _n_fft(m)
    d = _device_design(sample_rate, m, n, low_freq, xs.dtype, xs.device)

    valid = (torch.arange(m, device=xs.device) < lengths[:, None]) \
        .to(xs.dtype)
    # gammatone bank: one shared forward rfft of each signal, one
    # inverse per band
    bands = torch.fft.irfft(torch.fft.rfft(xs, n_fft)[:, None]
                            * d['hf_gt'], n_fft)[..., :m] * valid[:, None]
    # Hilbert envelope over the bucket length
    env = torch.fft.ifft(torch.fft.fft(bands) * d['hilbert']).abs()
    del bands

    starts = torch.arange(n_seg, device=xs.device) * shift
    seg_valid = (starts + frame <= lengths[:, None]).to(xs.dtype)
    count = seg_valid.sum(-1)
    count = torch.where(count == 0, torch.full_like(count, np.nan), count)

    env_f = torch.fft.rfft(env, n_fft)                 # (C, n, nf)
    means = []
    for kf in range(len(_MODULATION_FREQS)):
        filtered = torch.fft.irfft(env_f * d['hf_mod'][kf], n_fft)[..., :m]
        segments = filtered.unfold(-1, frame, shift)   # (C, n, S, frame)
        energies = ((d['hamm'] * segments) ** 2).sum(-1)
        means.append((energies * seg_valid[:, None]).sum(-1)
                     / count[:, None])
    means = torch.stack(means, -1)                     # (C, n, 8)

    total = means.sum((-2, -1))
    ac_perc = means.sum(-1) * 100 / total[:, None]     # (C, n)
    found = ac_perc.cumsum(-1) > 90
    # the cumulative share only grows: the first band past 90% is the
    # count of bands before it
    first = (~found).sum(-1).clamp(max=n - 1)
    bw = torch.where(found.any(-1), d['erbs'][first],
                     torch.zeros_like(total))

    per_mod = means.sum(-2)                            # (C, 8)
    numerator = per_mod[:, :4].sum(-1)
    # host loop: den = p4; add p5, stop if c4<BW<c5; add p6, stop if
    # c5<BW<c6; add p7
    cut = d['cutoffs']
    stop5 = ((cut[4] < bw) & (bw < cut[5])).to(xs.dtype)
    stop6 = ((cut[5] < bw) & (bw < cut[6])).to(xs.dtype)
    den = per_mod[:, 4] + per_mod[:, 5] + (1 - stop5) * (
        per_mod[:, 6] + (1 - stop6) * per_mod[:, 7])
    return numerator / den


def _working_set_per_signal(m, n, itemsize):
    """Bytes of device memory one signal's SRMR takes at its peak (the
    band spectra, envelopes, one modulation band's signal and its
    windowed segments, with temporaries): ~10 real (n, n_fft) arrays."""
    return 10 * n * _n_fft(m) * itemsize


def _bucket(lengths, sample_rate):
    frame, shift = _frame_shift(sample_rate)
    bucket = 4 * frame
    m = max(int(-(-max(int(lengths.max()), frame) // bucket)) * bucket,
            frame + shift)
    return -(-m // shift) * shift


def srmr_batch(signal, sample_rate: int = 16000,
               n_cochlear_filters: int = 23, low_freq: int = 125,
               device='cuda'):
    """Batched device SRMR over independent leading axes.

    Args:
        signal: (..., num_samples) real time signals (a tensor on any
            device or an array: the VAD splice runs on the host).
        sample_rate: sampling rate in Hz.
        device: where the filterbanks run ('cuda' by default; raises
            without CUDA). float64 inputs compute in float64, others in
            float32.
    Returns:
        numpy array of shape (...,) (a float for a 1-D signal); NaN
        where a VAD-spliced signal is shorter than one analysis frame
        (the host warns and yields NaN there too).
    """
    device = resolve_device(device)
    dtype = real_float(signal)
    if isinstance(signal, torch.Tensor):
        signal = signal.detach().cpu().numpy()
    x = np.asarray(signal, float)
    single = x.ndim == 1
    x = np.atleast_2d(x)
    lead = x.shape[:-1]
    spliced = []
    for row in x.reshape(-1, x.shape[-1]):
        s = _preprocessing_vad(row, sample_rate)
        s = s - np.mean(s)
        spliced.append(s / np.std(s, keepdims=True))
    lengths = np.array([len(s) for s in spliced])
    m = _bucket(lengths, sample_rate)
    padded = np.zeros((len(spliced), m))
    for i, s in enumerate(spliced):
        padded[i, :len(s)] = s

    itemsize = torch.empty((), dtype=dtype).element_size()
    chunk = max(1, _WORKING_SET_BYTES // _working_set_per_signal(
        m, n_cochlear_filters, itemsize))
    xs = torch.as_tensor(padded, dtype=dtype).to(device)
    lens = torch.as_tensor(lengths).to(device)
    out = torch.cat([
        _srmr_core(xs[i:i + chunk], lens[i:i + chunk], int(sample_rate),
                   int(n_cochlear_filters), int(low_freq))
        for i in range(0, len(spliced), chunk)])
    out = out.cpu().numpy().reshape(lead)
    return float(out[0]) if single else out


def srmr_device(signal, sample_rate: int = 16000,
                n_cochlear_filters: int = 23, low_freq: int = 125,
                device='cuda'):
    """Single-signal drop-in for the host ``SRMR``."""
    return srmr_batch(signal, sample_rate, n_cochlear_filters, low_freq,
                      device)
