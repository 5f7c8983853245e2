"""Time-frequency mask functions (counterpart of
``pb_bss_tpu.extraction.mask_module``): ideal binary, Wiener-like,
ideal ratio, ideal amplitude, phase-sensitive, ideal complex, Lorenz,
quantile and biased binary masks, and the voiced/unvoiced split.

Every mask takes the complex STFT signal and broadcasts over
independent dimensions; ``source_axis`` defaults to 0, an optional
``sensor_axis`` pools power, frequency and time are the trailing axes.
The Lorenz and quantile masks are one batched sort per call; the
quantile is ``np.percentile``'s linear interpolation, computed from the
sort (``torch.quantile`` refuses inputs of more than 2^24 elements).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .._dtypes import real_dtype as _real_dtype
from ..utils import abs_square

EPS = 1e-18

__all__ = [
    'voiced_unvoiced_split_characteristic',
    'ideal_binary_mask',
    'wiener_like_mask',
    'ideal_ratio_mask',
    'ideal_amplitude_mask',
    'phase_sensitive_mask',
    'ideal_complex_mask',
    'lorenz_mask',
    'quantile_mask',
    'biased_binary_mask',
]

_SENSOR_AXIS_MESSAGE = (
    'This mask has no meaningful way to pool a sensor axis: every '
    'candidate reduction (summing magnitudes, summing the complex '
    'values, root-sum-square) either discards the phase or changes '
    'the quantity the mask is defined on, so a complex per-sensor '
    'signal cannot be collapsed here. Pick one sensor (or pool '
    'outside) before calling; sensor_axis is only supported by the '
    'power-based masks, which pool |.|^2.'
)


def _pool_sensor_power(power, sensor_axis):
    """Sum a power over the sensor axis, keeping it as a singleton."""
    if sensor_axis is None:
        return power
    return power.sum(sensor_axis, keepdim=True)


def _drop_pooled_axis(mask, sensor_axis, keepdims):
    if sensor_axis is not None and not keepdims:
        return mask.squeeze(sensor_axis)
    return mask


def _soften(mask, weight):
    """Map hard {0, 1} decisions to {0.5 - w/2, 0.5 + w/2}."""
    return 0.5 + weight * (mask - 0.5)


def _flatten_rows(x, axis):
    """Collapse ``axis`` (int or tuple) into one trailing dim: returns
    (rows (R, N), restore), ``restore`` undoing it on a result of the
    same shape."""
    if not isinstance(axis, (tuple, list)):
        axis = (axis,)
    tmp_axis = tuple(-i - 1 for i in range(len(axis)))
    moved = torch.movedim(x, axis, tmp_axis)
    shape = moved.shape
    lead = shape[:len(shape) - len(tmp_axis)]
    rows = moved.reshape(math.prod(lead), math.prod(shape[len(lead):]))

    def restore(result):
        return torch.movedim(result.reshape(shape), tmp_axis, axis)

    return rows, restore


def voiced_unvoiced_split_characteristic(frequency_bins: int,
                                         split_bin: Optional[int] = None,
                                         width: Optional[int] = None):
    """(voiced, unvoiced) numpy weights over frequency, with a
    raised-cosine transition of ``width`` bins near ``split_bin``."""
    if split_bin is None:
        split_bin = frequency_bins // 2
    if width is None:
        width = frequency_bins // 5
    transition = 0.5 * (1 + np.cos(np.pi / (width - 1) * np.arange(0, width)))
    start = int(split_bin - width / 2)
    voiced = np.ones(frequency_bins)
    voiced[start - 1:(start + width - 1)] = transition
    voiced[start - 1 + width:] = 0
    unvoiced = 1 - voiced
    return voiced, unvoiced


def ideal_binary_mask(signal, source_axis: int = 0,
                      sensor_axis: Optional[int] = None,
                      keepdims: bool = False):
    """1 for the strongest source of each T-F bin [Erdogan2015]; the
    masks sum to one over sources."""
    components = signal.shape[source_axis]
    mask = _pool_sensor_power(abs_square(signal), sensor_axis)
    shape = [1] * signal.ndim
    shape[source_axis] = components
    mask = torch.argmax(mask, dim=source_axis, keepdim=True) == torch.arange(
        components, device=signal.device).reshape(shape)
    return _drop_pooled_axis(mask, sensor_axis, keepdims).to(
        _real_dtype(signal))


def wiener_like_mask(signal, source_axis: int = 0,
                     sensor_axis: Optional[int] = None, eps: float = EPS,
                     keepdims: bool = False):
    """Source power over total power [Erdogan2015]."""
    mask = _pool_sensor_power(abs_square(signal), sensor_axis)
    mask = mask / (mask.sum(source_axis, keepdim=True) + eps)
    return _drop_pooled_axis(mask, sensor_axis, keepdims)


def ideal_ratio_mask(signal, source_axis: int = 0,
                     sensor_axis: Optional[int] = None, eps: float = EPS):
    """Source magnitude over the summed magnitudes."""
    assert sensor_axis is None, _SENSOR_AXIS_MESSAGE
    mask = signal.abs()
    return mask / (mask.sum(source_axis, keepdim=True) + eps)


def ideal_amplitude_mask(signal, source_axis: int = 0,
                         sensor_axis: Optional[int] = None,
                         eps: float = EPS):
    """Source magnitude over the magnitude of the mixture."""
    assert sensor_axis is None, _SENSOR_AXIS_MESSAGE
    amplitude_of_sum = signal.sum(source_axis, keepdim=True).abs()
    return signal.abs() / (amplitude_of_sum + eps)


def phase_sensitive_mask(signal, source_axis: int = 0,
                         sensor_axis: Optional[int] = None,
                         eps: float = EPS):
    """``|S| / |Y| cos(angle(S) - angle(Y))`` [Erdogan2015]."""
    assert sensor_axis is None, _SENSOR_AXIS_MESSAGE
    observed = signal.sum(source_axis, keepdim=True)
    theta = torch.angle(signal) - torch.angle(observed)
    return signal.abs() / (observed.abs() + eps) * torch.cos(theta)


def ideal_complex_mask(signal, source_axis: int = 0,
                       sensor_axis: Optional[int] = None):
    """Complex mask S / Y [Erdogan2015]."""
    assert sensor_axis is None, _SENSOR_AXIS_MESSAGE
    return signal / signal.sum(source_axis, keepdim=True)


def lorenz_mask(signal, *, sensor_axis=None, axis=(-2, -1),
                lorenz_fraction: float = 0.98, weight: float = 0.999,
                keepdims: bool = False):
    """Softened mask by the Lorenz-function energy criterion: a T-F bin
    is active when its power exceeds the smallest power still inside
    the top ``lorenz_fraction`` of the cumulative (sorted descending)
    power over ``axis``."""
    power = _pool_sensor_power(abs_square(signal), sensor_axis)
    power, restore = _flatten_rows(power, axis)
    sorted_power = torch.sort(power, dim=-1, descending=True).values
    lorenz_function = torch.cumsum(sorted_power, dim=-1) / torch.clamp(
        sorted_power.sum(-1, keepdim=True), min=torch.finfo(power.dtype).tiny)
    below = lorenz_function < lorenz_fraction
    threshold = torch.where(
        below, sorted_power, torch.full_like(sorted_power, math.inf)).amin(
        -1, keepdim=True)
    mask = restore(_soften((power > threshold).to(power.dtype), weight))
    return _drop_pooled_axis(mask, sensor_axis, keepdims)


def _row_quantile(rows, q):
    """``np.percentile(rows, 100 q, axis=-1)`` (linear interpolation)
    from one sort of the rows."""
    n = rows.shape[-1]
    position = q * (n - 1)
    lo = math.floor(position)
    hi = min(lo + 1, n - 1)
    fraction = position - lo
    ordered = torch.sort(rows, dim=-1).values
    below, above = ordered[:, lo], ordered[:, hi]
    return below + fraction * (above - below)


def quantile_mask(signal, quantile=(0.1, -0.9), *, sensor_axis=None,
                  axis=-2, weight: float = 0.999):
    """Threshold mask at a magnitude quantile over ``axis``: a positive
    quantile selects the loudest fraction (speech), a negative one the
    quietest (noise). A tuple of quantiles stacks the masks on a new
    leading axis."""
    signal = signal.abs()
    assert sensor_axis is None, _SENSOR_AXIS_MESSAGE
    if isinstance(quantile, (tuple, list)):
        return torch.stack([
            quantile_mask(signal, q, sensor_axis=sensor_axis, axis=axis,
                          weight=weight)
            for q in quantile])
    rows, restore = _flatten_rows(signal, axis)
    if quantile >= 0:
        mask = rows > _row_quantile(rows, 1 - quantile)[:, None]
    else:
        mask = rows < _row_quantile(rows, abs(quantile))[:, None]
    return restore(_soften(mask.to(rows.dtype), weight))


def biased_binary_mask(signal, component_axis: int = 0,
                       sensor_axis: Optional[int] = None,
                       frequency_axis: int = -1,
                       threshold_unvoiced_speech: int = 5,
                       threshold_voiced_speech: int = 0,
                       threshold_unvoiced_noise: int = -10,
                       threshold_voiced_noise: int = -10,
                       low_cut: int = 5, high_cut: int = 500):
    """Thresholded speech / noise masks with a voiced/unvoiced frequency
    split. ``signal``: (2, ..., F), the stacked (speech image, noise
    image); returns the stacked bool (speech mask, noise mask)."""
    components = signal.shape[component_axis]
    assert components == 2, 'Only works for one speaker and noise.'
    if sensor_axis is not None:
        raise NotImplementedError()
    voiced, unvoiced = voiced_unvoiced_split_characteristic(
        signal.shape[frequency_axis])
    threshold_speech = (threshold_voiced_speech * voiced
                        + threshold_unvoiced_speech * unvoiced)
    threshold_noise = (threshold_unvoiced_noise * voiced
                       + threshold_voiced_noise * unvoiced)
    power = abs_square(signal)
    speech_power, noise_power = torch.chunk(power, 2, dim=component_axis)

    def scale(threshold):
        return torch.as_tensor(10 ** (threshold / 10), dtype=power.dtype,
                               device=power.device)

    power_threshold_speech = speech_power / scale(threshold_speech)
    power_threshold_noise = speech_power / scale(threshold_noise)
    speech_mask = (power_threshold_speech > noise_power) \
        & (power_threshold_speech > 0.005)
    noise_mask = (power_threshold_noise < noise_power) \
        | (power_threshold_noise < 0.005)
    fidx = torch.arange(signal.shape[frequency_axis], device=signal.device)
    in_band = (fidx >= low_cut - 1) & (fidx < high_cut)
    speech_mask = speech_mask & in_band
    noise_mask = noise_mask | ~in_band
    return torch.cat([speech_mask, noise_mask], dim=component_axis)
