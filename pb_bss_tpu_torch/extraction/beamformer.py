"""Beamformers (counterpart of ``pb_bss_tpu.extraction.beamformer``).

PSD estimation, PCA, MVDR in the ATF form, the MERL form and the Souden
form with its SNR-based reference channel, GEV with its diagonal-loading
retry, LCMV, the speech-distortion-weighted multichannel Wiener filter,
the postfilters and normalizations, and the application of a
beamforming vector.

Shape convention: time at the end, independent dims in front —
X: (F, D, T), mask: (F, K, T), PSD: (F, K, D, D).

On CUDA the eigendecompositions (PCA, the pseudo-inverse fallback of
:func:`~pb_bss_tpu_torch.ops.linalg.stable_solve` in every MVDR, wMWF
and LCMV) launch the batched Jacobi kernel (K1, ``ops/eigh.py``) and the
GEV beamformer the fused GEV kernel (K3, ``ops/gev.py``) for batches
they take; elsewhere their plain twins run.

The reference channel of :func:`get_mvdr_vector_souden` and
:func:`get_wmwf_vector` is the SNR-maximizing one over the frequency
axis, the third from last. On (F, D, D) input it is one channel, as in
the JAX package, with its finiteness assert (a host sync). On input with
more leading dims, such as the pipeline's (B, K, F, D, D), each leading
index gets its own channel, with no assert and no host sync: the JAX
package reaches that case only under ``vmap`` and ``jit``, where its
assert does not run (the JAX package raises ``ValueError`` on such input
outside ``vmap``).
"""
from __future__ import annotations

import torch

from .._dtypes import real_dtype as _real_dtype, tiny as _tiny
from .._shard import frequency_sum
from ..models._precision import full_fp32
from ..ops.gev import gev_with_retry
from ..ops.linalg import (
    _kernel_eligible,
    condition_hermitian,
    force_hermitian,
    get_pca,
    gev_max_eigvec,
    stable_solve,
)

__all__ = [
    'get_power_spectral_density_matrix',
    'get_mvdr_vector_souden',
    'get_mvdr_vector',
    'get_wmwf_vector',
    'get_pca_vector',
    'get_gev_vector',
    'blind_analytic_normalization',
    'condition_covariance',
    'apply_beamforming_vector',
    'get_lcmv_vector',
    'get_lcmv_vector_souden',
]


def _trace(x):
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def get_power_spectral_density_matrix(observation, mask=None, sensor_dim=-2,
                                      source_dim=-2, time_dim=-1,
                                      normalize=True):
    """Weighted power spectral density (spatial covariance) matrix.

    Args:
        observation: complex (..., sensors, frames) (other layouts via
            ``sensor_dim`` / ``time_dim``).
        mask: None, (..., frames) or (..., sources, frames); bool masks
            are cast to float; normalized over time unless
            ``normalize=False``.
    Returns:
        (..., sensors, sensors) or (..., sources, sensors, sensors); a
        ``source_dim`` left of -2 moves the source axis there.
    The products run in full fp32 (:func:`full_fp32`), the counterpart
    of the JAX package's ``Precision.HIGHEST`` pin.
    """
    ndim = observation.ndim
    sensor_dim, source_dim, time_dim = (
        d % ndim - ndim for d in (sensor_dim, source_dim, time_dim))
    order = [i for i in range(-ndim, 0) if i not in (sensor_dim, time_dim)]
    observation = observation.permute(
        [i % ndim for i in order + [sensor_dim, time_dim]])
    conj = observation.conj()
    if mask is None:
        with full_fp32():
            psd = torch.einsum('...dt,...et->...de', observation, conj)
        return psd / observation.shape[-1]
    if mask.dtype == torch.bool:
        mask = mask.to(_real_dtype(observation))
    if normalize:
        mask = mask / torch.clamp(mask.sum(time_dim, keepdim=True),
                                  min=1e-10)
    if mask.ndim + 1 == ndim:
        with full_fp32():
            return torch.einsum(
                '...dt,...et->...de', mask[..., None, :] * observation,
                conj)
    order = [i for i in range(-ndim, 0) if i not in (source_dim, time_dim)]
    mask = mask.permute([i % ndim for i in order + [source_dim, time_dim]])
    with full_fp32():
        psd = torch.einsum('...kt,...dt,...et->...kde',
                           mask.to(observation.dtype), observation, conj)
    if source_dim < -2:
        psd = torch.movedim(psd, -3, source_dim % ndim)
    return psd


def get_pca_vector(target_psd_matrix, scaling=None):
    """PCA beamforming vector: the dominant eigenvector, scaled by
    ``None``, ``'trace'`` (sqrt of the trace over its norm) or
    ``'eigenvalue'`` (the eigenvalue over its norm)."""
    eigenvectors, eigenvalues = get_pca(target_psd_matrix)
    if scaling is None:
        return eigenvectors
    norm = torch.linalg.vector_norm(eigenvectors, dim=-1)
    if scaling == 'trace':
        scale = torch.sqrt(_trace(target_psd_matrix)) / norm
    elif scaling == 'eigenvalue':
        scale = eigenvalues / norm
    else:
        raise ValueError(scaling)
    return eigenvectors * scale[..., None]


def get_mvdr_vector(atf_vector, noise_psd_matrix):
    """MVDR in ATF form: ``Phi_nn^-1 h / (h^H Phi_nn^-1 h)``, on the
    hermitized noise PSD, with the least-squares fallback of
    :func:`stable_solve` per singular bin."""
    assert noise_psd_matrix is not None
    while atf_vector.ndim > noise_psd_matrix.ndim - 1:
        noise_psd_matrix = noise_psd_matrix[None]
    noise_psd_matrix = force_hermitian(noise_psd_matrix).expand(
        *atf_vector.shape, atf_vector.shape[-1])
    numerator = stable_solve(
        noise_psd_matrix, atf_vector[..., None], hermitian=True)[..., 0]
    denominator = torch.einsum('...d,...d->...', atf_vector.conj(),
                               numerator)
    return numerator / denominator[..., None]


def get_mvdr_vector_merl(target_psd_matrix, noise_psd_matrix):
    """MVDR of https://www.merl.com/publications/docs/TR2016-072.pdf with
    one reference channel for all bins, by the post-SNR of each channel.
    A singular noise PSD gives non-finite values (no fallback), as the
    JAX package's ``solve`` does."""
    with full_fp32():
        G, _ = torch.linalg.solve_ex(noise_psd_matrix, target_psd_matrix,
                                     check_errors=False)
    h = G / _trace(G)[..., None, None]
    nom_c = torch.einsum('...fac,fab,...fbc->c', h.conj(), target_psd_matrix,
                         h)
    denom_c = torch.einsum('...fac,fab,...fbc->c', h.conj(),
                           noise_psd_matrix, h)
    h_idx = torch.argmax((nom_c / denom_c).real)
    return h.index_select(-1, h_idx.reshape(1))[..., 0]


# Diagonal loading of the GEV retry, relative to tr(Phi_nn) / D. The JAX
# package loads 1e-10, which cannot lift the f32 rounding of a
# rank-deficient noise PSD (a few ulps of its largest eigenvalue below
# zero: a noise class whose masks cover ~one frame in a bin) and leaves
# the bin non-finite; 1e-5 does. Only bins that are non-finite without
# loading take the retry, so every other bin is the JAX package's.
RETRY_LOADING = 1e-5


def get_gev_vector(target_psd_matrix, noise_psd_matrix, force_cython=False,
                   use_eig=False):
    """GEV (max-SNR) beamforming vector [Warsitz2007GEV], B-normalized
    (``w^H Phi_nn w = 1``). Bins whose noise PSD is not positive
    definite (non-finite vector) are retried with diagonal loading
    (:data:`RETRY_LOADING`): where the fused GEV kernel runs (CUDA,
    complex64, D <= 16, at least 64 pencils), inside its one launch
    (:func:`pb_bss_tpu_torch.ops.gev.gev_with_retry`); elsewhere by two
    calls and a select, which the kernel's result equals.
    ``force_cython`` and ``use_eig`` are accepted and ignored, as in the
    JAX package: there is one code path."""
    del force_cython, use_eig
    assert noise_psd_matrix is not None
    if _kernel_eligible(noise_psd_matrix):
        return gev_with_retry(target_psd_matrix, noise_psd_matrix,
                              RETRY_LOADING)
    beam = gev_max_eigvec(target_psd_matrix, noise_psd_matrix)
    bad = ~torch.isfinite(beam.abs()).all(-1, keepdim=True)
    loaded = gev_max_eigvec(
        target_psd_matrix, noise_psd_matrix, condition=RETRY_LOADING)
    return torch.where(bad, loaded, beam)


def get_lcmv_vector(atf_vectors, response_vector, noise_psd_matrix):
    """LCMV beamformer from per-source ATFs and a response vector.

    Args:
        atf_vectors: (K, F, D)
        response_vector: (K,), e.g. one-hot for the attended source.
        noise_psd_matrix: (F, D, D)
    Returns:
        (F, D) beamforming vectors.
    """
    K, F, D = atf_vectors.shape
    assert noise_psd_matrix.shape == (F, D, D), noise_psd_matrix.shape
    phi_inverse_times_h = stable_solve(
        noise_psd_matrix[None].expand(K, F, D, D),
        atf_vectors[..., None])[..., 0]  # (K, F, D)
    h_phi_h = torch.einsum('k...d,K...d->...kK', atf_vectors.conj(),
                           phi_inverse_times_h)  # (F, K, K)
    response = torch.as_tensor(response_vector, device=h_phi_h.device)
    response = response.to(h_phi_h.dtype)[None, :, None].expand(F, K, 1)
    temp = stable_solve(h_phi_h, response)  # (F, K, 1)
    return torch.einsum('k...d,...k->...d', phi_inverse_times_h,
                        temp[..., 0])


def distortionless_normalization(vector, atf_vector, noise_psd_matrix):
    """Rescale towards a distortionless response for the given ATF.
    vector, atf_vector: (F, D); noise_psd_matrix: (F, D, D)."""
    nominator = torch.einsum('fab,fb,fc->fac', noise_psd_matrix, vector,
                             vector.conj())
    denominator = torch.einsum('fa,fab,fb->f', vector.conj(),
                               noise_psd_matrix, vector)
    projection_matrix = nominator / denominator[..., None, None]
    return torch.einsum('fab,fb->fa', projection_matrix, atf_vector)


def mvdr_snr_postfilter(vector, target_psd_matrix, noise_psd_matrix):
    """Single-channel SNR postfilter, (F, 1)."""
    nominator = torch.einsum('fa,fab,fb->f', vector.conj(),
                             target_psd_matrix, vector)
    denominator = torch.einsum('fa,fab,fb->f', vector.conj(),
                               noise_psd_matrix, vector)
    return (nominator / denominator)[:, None]


def zero_degree_normalization(vector, reference_channel):
    """Rotate phases so that the reference channel is real positive."""
    return vector * torch.exp(
        -1j * torch.angle(vector[..., reference_channel, None]))


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


def condition_covariance(x, gamma):
    """Diagonal loading ``(x + gamma tr(x)/D I) / (1 + gamma)``."""
    return condition_hermitian(x, gamma)


def apply_beamforming_vector(vector, mix):
    """``y_t = w^H x_t``: vector (..., D), mix (..., D, T) -> (..., T)."""
    assert vector.shape[-1] < 30, (vector.shape,)
    return torch.einsum('...a,...at->...t', vector.conj(), mix)


def apply_online_beamforming_vector(vector, mix):
    """Time-varying beamforming: vector (D, F, T), taken as (F, T, D)."""
    vector = vector.permute(1, 2, 0)
    return torch.einsum('...at,...at->...t', vector.conj(), mix)


def _snr(w_mat, target_psd_matrix, noise_psd_matrix, eps):
    """Post-beamforming SNR of each column of ``w_mat`` (..., F, D, R),
    summed over the bins (every bin of a sharded pipeline), (..., R)."""
    def power(psd):
        return frequency_sum(torch.einsum(
            '...FdR,...FdD,...FDR->...R', w_mat.conj(), psd, w_mat))
    return power(target_psd_matrix) / torch.clamp(
        power(noise_psd_matrix).real, min=eps)


def get_optimal_reference_channel(w_mat, target_psd_matrix, noise_psd_matrix,
                                  eps=None):
    """SNR-maximizing reference channel of (F, D, D) beamforming
    matrices; the frequency axis is required and reduced. Asserts a
    finite SNR (a host sync on CUDA), as the JAX package does outside
    ``jit``."""
    if w_mat.ndim != 3:
        raise ValueError(
            'Estimating the ref_channel expects currently that the input '
            'has 3 ndims (frequency x sensors x sensors). '
            'Considering an independent dim in the SNR estimate is not '
            'unique.'
        )
    if eps is None:
        eps = _tiny(w_mat)
    SNR = _snr(w_mat, target_psd_matrix, noise_psd_matrix, eps)
    assert bool(torch.isfinite(SNR).all()), SNR
    return torch.argmax(SNR.real)


def _reference_channel(w_mat, target_psd_matrix, noise_psd_matrix, eps=None):
    """The reference channel of (F, D, D) input with its assert
    (:func:`get_optimal_reference_channel`); of (..., F, D, D) input one
    per leading index, (...), with no assert and no host sync."""
    if w_mat.ndim <= 3:
        return get_optimal_reference_channel(
            w_mat, target_psd_matrix, noise_psd_matrix, eps=eps)
    if eps is None:
        eps = _tiny(w_mat)
    return torch.argmax(
        _snr(w_mat, target_psd_matrix, noise_psd_matrix, eps).real, dim=-1)


def _take_channel(mat, channel):
    """Column ``channel`` of (..., D, D) matrices: an int, a 0-dim
    tensor, or a (...)-shaped tensor without the last three axes (one
    channel per leading index)."""
    if not isinstance(channel, torch.Tensor):
        return mat[..., channel]
    channel = channel.to(mat.device)
    if channel.ndim == 0:
        return mat.index_select(-1, channel.reshape(1))[..., 0]
    index = channel[..., None, None, None].expand(*mat.shape[:-1], 1)
    return torch.gather(mat, -1, index)[..., 0]


def get_mvdr_vector_souden(target_psd_matrix, noise_psd_matrix,
                           ref_channel=None, eps=None,
                           return_ref_channel=False):
    """MVDR in the Souden formulation [Souden2010MVDR, Erdogan2016MVDR]:
    ``w = Phi_nn^-1 Phi_xx / tr(Phi_nn^-1 Phi_xx) e_ref``, the reference
    channel chosen by the SNR estimate unless given (see the module
    notes for batched input). Zero matrices give zero beamformers."""
    assert noise_psd_matrix is not None
    phi = stable_solve(noise_psd_matrix, target_psd_matrix)
    lambda_ = _trace(phi)[..., None, None]
    if eps is None:
        eps = _tiny(lambda_)
    mat = phi / torch.clamp(lambda_.real, min=eps)
    if ref_channel is None:
        ref_channel = _reference_channel(
            mat, target_psd_matrix, noise_psd_matrix, eps=eps)
    beamformer = _take_channel(mat, ref_channel)
    if return_ref_channel:
        return beamformer, ref_channel
    return beamformer


def get_wmwf_vector(target_psd_matrix, noise_psd_matrix,
                    reference_channel=None, channel_selection_vector=None,
                    distortion_weight=1.):
    """Speech-distortion-weighted multichannel Wiener filter;
    ``distortion_weight='frequency_dependent'`` takes the Max-SNR-inspired
    trade-off of https://arxiv.org/abs/1707.00201. The reference channel
    as in :func:`get_mvdr_vector_souden`."""
    assert noise_psd_matrix is not None
    phi = stable_solve(noise_psd_matrix, target_psd_matrix)
    lambda_ = _trace(phi)[..., None, None]
    if isinstance(distortion_weight, str) \
            and distortion_weight == 'frequency_dependent':
        phi_x1x1 = target_psd_matrix[..., 0:1, 0:1]
        filter_ = phi / torch.sqrt(phi_x1x1 * lambda_)
    else:
        filter_ = phi / (distortion_weight + lambda_)
    if channel_selection_vector is not None:
        channel_selection_vector = torch.as_tensor(
            channel_selection_vector, device=filter_.device)
        return torch.sum(filter_ * channel_selection_vector[..., None, :],
                         dim=-1)
    if reference_channel is None:
        reference_channel = _reference_channel(
            filter_, target_psd_matrix, noise_psd_matrix)
    return _take_channel(filter_, reference_channel)


def get_lcmv_vector_souden(target_psd_matrix, interference_psd_matrix,
                           noise_psd_matrix, ref_channel=None, eps=None,
                           return_ref_channel=False):
    """Souden-style rank-1 LCMV: not implemented, as in the JAX
    package."""
    raise NotImplementedError(
        'This is not yet thoroughly tested. It also misses the response '
        'vector, thus it is unclear, how to select, which speaker to '
        'attend to.'
    )
