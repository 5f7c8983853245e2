"""Fused GEV beamformer in one CUDA launch (kernel ``csrc/gev.cu``).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_gev.py:gev_pallas``. A lane owns one column of
each working matrix of one pencil (D <= 16) in registers, floor(32 / D)
pencils to a warp: the complex Cholesky of the noise PSD, the two
triangular solves of the whitening, hermitization, the plain twin's
cyclic Jacobi sweeps in disjoint steps (``column_jacobi_wavefront`` of
``csrc/em_iter.cuh``, with the twin's rotation at any scale), the
dominant eigenvector (first index among equal maxima) and the
back-substitution, each a chain of shuffles between the pencil's lanes.
B-normalized (``w^H phi_nn w = 1``); a noise PSD that is not positive
definite gives a non-finite vector (sqrt of a negative pivot).

:func:`gev_with_retry` is the same launch with the diagonal-loading
retry of ``extraction.beamformer.get_gev_vector`` inside it: a pencil
whose vector is not finite runs again on its loaded noise PSD, so the
retry costs no second launch.

What bounds it on the H100: a call holds a few hundred to a few
thousand 6 x 6 pencils, so it is bound by the latency of one pencil's
dependent steps, not by bytes or FLOPs; the design keeps them in
registers with no barrier, and :func:`cta_warps` sizes the CTAs so that
they spread over every SM.

On a CPU tensor the wrappers run their plain PyTorch twins,
:func:`gev_reference` and :func:`gev_with_retry_reference`. On a CUDA
tensor they launch the kernel or raise; they never fall back.
"""
from __future__ import annotations

import torch

from ._build import counted, launch
from .eigh import _sms, cta_warps, default_sweeps
from .linalg import condition_hermitian, gev_staged

__all__ = ['gev', 'gev_reference', 'gev_with_retry',
           'gev_with_retry_reference', 'cta_warps']


def gev_reference(target_psd_matrix, noise_psd_matrix, *, sweeps=None):
    """Plain PyTorch twin: the staged Cholesky / solve / Jacobi path
    with the plain batched Jacobi."""
    d = target_psd_matrix.shape[-1]
    return gev_staged(
        target_psd_matrix, noise_psd_matrix, eigh_method='jacobi',
        sweeps=default_sweeps(d) if sweeps is None else sweeps)


def gev_with_retry_reference(target_psd_matrix, noise_psd_matrix, loading,
                             *, sweeps=None):
    """Plain PyTorch twin of :func:`gev_with_retry`: the two-call
    composition of ``get_gev_vector``, the loaded vector where the
    unloaded one is not finite."""
    beam = gev_reference(target_psd_matrix, noise_psd_matrix, sweeps=sweeps)
    bad = ~torch.isfinite(beam.abs()).all(-1, keepdim=True)
    loaded = gev_reference(
        target_psd_matrix, condition_hermitian(noise_psd_matrix, loading),
        sweeps=sweeps)
    return torch.where(bad, loaded, beam)


def _launch(phi_xx, phi_nn, sweeps, loading):
    """The kernel on CUDA pencils; with ``loading`` the retry runs in the
    same launch."""
    if phi_nn.device.type != 'cuda':
        raise ValueError(f'unsupported device {phi_nn.device}')
    d = phi_xx.shape[-1]
    if (phi_xx.shape != phi_nn.shape or phi_xx.ndim < 2
            or phi_xx.shape[-2] != d or phi_xx.device != phi_nn.device):
        raise ValueError(
            f'pencils must be matching (..., D, D) on one device, got '
            f'{tuple(phi_xx.shape)} and {tuple(phi_nn.shape)}')
    if phi_xx.dtype != torch.complex64 or phi_nn.dtype != torch.complex64:
        raise ValueError(
            f'complex64 pencils required, got {phi_xx.dtype}, '
            f'{phi_nn.dtype}')
    if not 1 <= d <= 16:
        raise ValueError(f'the GEV kernel takes 1 <= D <= 16, got {d}')
    batch = phi_xx.shape[:-2]
    xx = phi_xx.resolve_conj().reshape(-1, d, d).contiguous()
    nn = phi_nn.resolve_conj().reshape(-1, d, d).contiguous()
    B = xx.shape[0]
    beam = torch.empty((B, d), dtype=torch.complex64, device=xx.device)
    if B:
        launch(gev, 'gev', 'gev_launch',
               xx.data_ptr(), nn.data_ptr(), beam.data_ptr(), B, d,
               default_sweeps(d) if sweeps is None else int(sweeps),
               cta_warps(B, d, _sms(xx.device.index or 0)),
               int(loading is not None),
               0.0 if loading is None else float(loading),
               torch.cuda.current_stream(xx.device).cuda_stream)
    return beam.reshape(*batch, d)


@counted
def gev(target_psd_matrix, noise_psd_matrix, *, sweeps=None):
    """Dominant generalized eigenvector of batched Hermitian pencils.

    Args:
        target_psd_matrix: (..., D, D) Hermitian complex64, D <= 16.
        noise_psd_matrix: (..., D, D) Hermitian positive definite.
    Returns:
        (..., D) complex64 B-normalized beamforming vectors.
    """
    if noise_psd_matrix.device.type == 'cpu':
        return gev_reference(target_psd_matrix, noise_psd_matrix,
                             sweeps=sweeps)
    return _launch(target_psd_matrix, noise_psd_matrix, sweeps, None)


def gev_with_retry(target_psd_matrix, noise_psd_matrix, loading, *,
                   sweeps=None):
    """:func:`gev`, and where a vector is not finite, the vector of the
    pencil whose noise PSD is loaded as ``condition_hermitian(phi_nn,
    loading)`` does, ``(x + loading tr(x) / D I) / (1 + loading)``: the
    diagonal-loading retry of ``get_gev_vector``, in one launch on
    CUDA. Counts in ``gev.launches``."""
    if noise_psd_matrix.device.type == 'cpu':
        return gev_with_retry_reference(target_psd_matrix, noise_psd_matrix,
                                        loading, sweeps=sweeps)
    return _launch(target_psd_matrix, noise_psd_matrix, sweeps, loading)
