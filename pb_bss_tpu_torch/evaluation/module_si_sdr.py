"""Scale-Invariant Signal-to-Distortion Ratio (SI-SDR) [LeRoux2019]
"SDR - Half-Baked or Well Done?", broadcast over leading dims.

Computed in the inputs' precision; the JAX package asserts float64
unless ``allow_float32`` (the projection suffers cancellation in
float32: expect ~0.01 dB noise on typical signals).
"""
from __future__ import annotations

import torch

__all__ = ['si_sdr']


def si_sdr(reference, estimation):
    """SI-SDR in dB of ``estimation`` against ``reference``, both
    (..., T) real tensors (broadcastable).

    >>> g = torch.Generator().manual_seed(0)
    >>> reference = torch.randn(100, generator=g, dtype=torch.float64)
    >>> float(si_sdr(reference, reference * 2)) == float('inf')
    True
    """
    estimation, reference = torch.broadcast_tensors(estimation, reference)
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
