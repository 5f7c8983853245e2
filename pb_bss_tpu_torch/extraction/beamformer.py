"""Beamformers of the separation slice.

Counterpart of ``pb_bss_tpu.extraction.beamformer``: PSD estimation,
the GEV (max-SNR) beamformer with its diagonal-loading retry, blind
analytic normalization, phase correction across frequency and the
application of a beamforming vector.

Shape convention: time at the end, independent dims in front —
X: (F, D, T), mask: (F, K, T), PSD: (F, K, D, D).
"""
from __future__ import annotations

import torch

from .._dtypes import real_dtype as _real_dtype
from ..models._precision import full_fp32
from ..ops.gev import gev_with_retry
from ..ops.linalg import _kernel_eligible, gev_max_eigvec

__all__ = [
    'get_power_spectral_density_matrix',
    'get_gev_vector',
    'blind_analytic_normalization',
    'phase_correction',
    'apply_beamforming_vector',
]


def get_power_spectral_density_matrix(observation, mask=None,
                                      normalize=True):
    """Weighted power spectral density (spatial covariance) matrix.

    Args:
        observation: complex (..., sensors, frames).
        mask: None, (..., frames) or (..., sources, frames); bool masks
            are cast to float; normalized over time unless
            ``normalize=False``.
    Returns:
        (..., sensors, sensors) or (..., sources, sensors, sensors).
    The products run in full fp32 (:func:`full_fp32`), the counterpart
    of the JAX package's ``Precision.HIGHEST`` pin.
    """
    conj = observation.conj()
    if mask is None:
        with full_fp32():
            psd = torch.einsum('...dt,...et->...de', observation, conj)
        return psd / observation.shape[-1]
    if mask.dtype == torch.bool:
        mask = mask.to(_real_dtype(observation))
    if normalize:
        mask = mask / torch.clamp(mask.sum(-1, keepdim=True), min=1e-10)
    with full_fp32():
        if mask.ndim + 1 == observation.ndim:
            return torch.einsum(
                '...dt,...et->...de', mask[..., None, :] * observation,
                conj)
        return torch.einsum(
            '...kt,...dt,...et->...kde', mask.to(observation.dtype),
            observation, conj)


# Diagonal loading of the GEV retry, relative to tr(Phi_nn) / D. The JAX
# package loads 1e-10, which cannot lift the f32 rounding of a
# rank-deficient noise PSD (a few ulps of its largest eigenvalue below
# zero: a noise class whose masks cover ~one frame in a bin) and leaves
# the bin non-finite; 1e-5 does. Only bins that are non-finite without
# loading take the retry, so every other bin is the JAX package's.
RETRY_LOADING = 1e-5


def get_gev_vector(target_psd_matrix, noise_psd_matrix):
    """GEV (max-SNR) beamforming vector [Warsitz2007GEV], B-normalized
    (``w^H Phi_nn w = 1``). Bins whose noise PSD is not positive
    definite (non-finite vector) are retried with diagonal loading
    (:data:`RETRY_LOADING`): where the fused GEV kernel runs (CUDA,
    complex64, D <= 16, at least 64 pencils), inside its one launch
    (:func:`pb_bss_tpu_torch.ops.gev.gev_with_retry`); elsewhere by two
    calls and a select, which the kernel's result equals."""
    if _kernel_eligible(noise_psd_matrix):
        return gev_with_retry(target_psd_matrix, noise_psd_matrix,
                              RETRY_LOADING)
    beam = gev_max_eigvec(target_psd_matrix, noise_psd_matrix)
    bad = ~torch.isfinite(beam.abs()).all(-1, keepdim=True)
    loaded = gev_max_eigvec(
        target_psd_matrix, noise_psd_matrix, condition=RETRY_LOADING)
    return torch.where(bad, loaded, beam)


def blind_analytic_normalization(vector, noise_psd_matrix):
    """BAN postfilter [Warsitz2007GEV] Section III.A. Zero denominators
    map to a zero gain (zero-PSD semantics)."""
    nominator = torch.sqrt(torch.einsum(
        '...a,...ab,...bc,...c->...', vector.conj(), noise_psd_matrix,
        noise_psd_matrix, vector))
    denominator = torch.einsum(
        '...a,...ab,...b->...', vector.conj(), noise_psd_matrix, vector)
    denominator = torch.sqrt(denominator * denominator.conj())
    zero = denominator == 0
    normalization = torch.where(
        zero, torch.zeros_like(nominator),
        nominator / torch.where(zero, torch.ones_like(denominator),
                                denominator))
    return vector * normalization.abs()[..., None]


def phase_correction(vector):
    """Phase-align beamforming vectors across frequency via a
    cumulative product of adjacent-bin phase flips.

    Args:
        vector: (..., F, D).
    """
    correction = torch.cumprod(torch.exp(1j * torch.angle(torch.sum(
        vector[..., 1:, :].conj() * vector[..., :-1, :],
        dim=-1, keepdim=True))), dim=-2)
    return torch.cat(
        [vector[..., :1, :], vector[..., 1:, :] * correction], dim=-2)


def apply_beamforming_vector(vector, mix):
    """``y_t = w^H x_t``: vector (..., D), mix (..., D, T) -> (..., T)."""
    assert vector.shape[-1] < 30, (vector.shape,)
    return torch.einsum('...a,...at->...t', vector.conj(), mix)
