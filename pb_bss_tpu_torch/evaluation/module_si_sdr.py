"""Scale-Invariant Signal-to-Distortion Ratio (SI-SDR) [LeRoux2019]
"SDR - Half-Baked or Well Done?", broadcast over leading dims.

Counterpart of ``pb_bss_tpu.evaluation.module_si_sdr``, with its float64
contract: :func:`si_sdr` refuses anything but float64 input unless the
caller passes ``allow_float32=True`` (the projection suffers
cancellation in float32: expect ~0.01 dB noise on typical signals).
Integer input is refused either way: its squares overflow.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ['si_sdr', 'si_sdr_allow_float32', 'si_sdr_stft']


def _dtype(x):
    """The numpy dtype of a tensor, an array or a scalar."""
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return x.dtype if hasattr(x, 'dtype') else np.asarray(x).dtype


def si_sdr_allow_float32(*arrays):
    """The opt-in policy for :func:`si_sdr`'s ``allow_float32``: True
    exactly when every input is floating and at least one is float32.
    Integer inputs keep raising the float64 contract: treating any
    non-float64 dtype as an opt-in would let int16 PCM silently compute
    garbage (integer sums overflow in the energy terms)."""
    dts = [_dtype(a) for a in arrays]
    return (all(np.issubdtype(dt, np.floating) for dt in dts)
            and any(dt == np.float32 for dt in dts))


def si_sdr(reference, estimation, *, allow_float32=False):
    """SI-SDR in dB of ``estimation`` against ``reference``.

    Args:
        reference: (..., T) float64 (tensor, array or sequence).
        estimation: (..., T) float64, broadcastable.
        allow_float32: accept other floating inputs (float32 on the
            card, where the evaluation stays on the device).

    >>> g = torch.Generator().manual_seed(0)
    >>> reference = torch.randn(100, generator=g, dtype=torch.float64)
    >>> float(si_sdr(reference, reference * 2)) == float('inf')
    True
    """
    if not allow_float32:
        # the contract is about the data given: check it before any
        # conversion
        for name, x in (('reference', reference),
                        ('estimation', estimation)):
            dt = _dtype(x)
            assert dt == np.float64, (
                f'The reference requires float64 inputs for a meaningful '
                f'SI-SDR ({name} has {dt}); pass allow_float32=True for '
                f'on-device f32 evaluation.')
    estimation, reference = torch.broadcast_tensors(
        torch.as_tensor(estimation), torch.as_tensor(reference))
    reference_energy = (reference ** 2).sum(-1, keepdim=True)
    # alpha after Equation (3) in [LeRoux2019]
    optimal_scaling = (reference * estimation).sum(-1, keepdim=True) \
        / reference_energy
    # e_target / e_res of Equation (4)
    projection = optimal_scaling * reference
    noise = estimation - projection
    ratio = (projection ** 2).sum(-1) / (noise ** 2).sum(-1)
    return 10 * torch.log10(ratio)


def si_sdr_stft(reference, estimation, size=512, shift=128):
    """SI-SDR with one complex scale per STFT frequency bin, in dB.

    A beamformer output carries an arbitrary gain and phase per
    frequency (after ``phase_correction``, a smooth phase that acts
    like a delay), which the plain SI-SDR counts as distortion. Here
    each bin of the estimate is projected onto the same bin of the
    reference; projection and residual energies are summed over all
    bins and frames. Not part of the JAX package; the port scores its
    beamformer outputs with it.

    Args:
        reference, estimation: (..., T) real tensors (broadcastable).
    """
    from ..transform import stft
    estimation, reference = torch.broadcast_tensors(estimation, reference)
    R = stft(reference, size, shift)  # (..., frames, F)
    E = stft(estimation, size, shift)
    scale = (R.conj() * E).sum(-2, keepdim=True) \
        / (R.abs() ** 2).sum(-2, keepdim=True)
    projection = scale * R
    ratio = (projection.abs() ** 2).sum((-2, -1)) \
        / ((E - projection).abs() ** 2).sum((-2, -1))
    return 10 * torch.log10(ratio)
