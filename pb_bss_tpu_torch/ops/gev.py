"""Fused GEV beamformer in one CUDA launch (kernel ``csrc/gev.cu``).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_gev.py:gev_pallas``. One warp owns one pencil:
complex Cholesky of the noise PSD, the two triangular solves of the
whitening, hermitization, complex Jacobi, the dominant eigenvector
(first index among equal maxima) and the back-substitution, all in
shared memory. B-normalized (``w^H phi_nn w = 1``); a noise PSD that is
not positive definite gives a non-finite vector (sqrt of a negative
pivot), which the diagonal-loading retry of
``extraction.beamformer.get_gev_vector`` relies on.

What bounds it on the H100: a call holds a few hundred to a few
thousand 6 x 6 pencils, so it is bound by the latency of one pencil's
sequential factorization and sweeps, not by bytes or FLOPs; the design
keeps each pencil on one warp with no block-wide barrier.

On a CPU tensor the wrapper runs the plain PyTorch twin,
:func:`gev_reference`. On a CUDA tensor it launches the kernel or
raises; it never falls back.
"""
from __future__ import annotations

import torch

from .eigh import default_sweeps
from .linalg import gev_staged

__all__ = ['gev', 'gev_reference']


def gev_reference(target_psd_matrix, noise_psd_matrix, *, sweeps=None):
    """Plain PyTorch twin: the staged Cholesky / solve / Jacobi path
    with the plain batched Jacobi."""
    d = target_psd_matrix.shape[-1]
    return gev_staged(
        target_psd_matrix, noise_psd_matrix, eigh_method='jacobi',
        sweeps=default_sweeps(d) if sweeps is None else sweeps)


def gev(target_psd_matrix, noise_psd_matrix, *, sweeps=None):
    """Dominant generalized eigenvector of batched Hermitian pencils.

    Args:
        target_psd_matrix: (..., D, D) Hermitian complex64, D <= 16.
        noise_psd_matrix: (..., D, D) Hermitian positive definite.
    Returns:
        (..., D) complex64 B-normalized beamforming vectors.
    """
    phi_xx, phi_nn = target_psd_matrix, noise_psd_matrix
    if phi_nn.device.type == 'cpu':
        return gev_reference(phi_xx, phi_nn, sweeps=sweeps)
    if phi_nn.device.type != 'cuda':
        raise ValueError(f'unsupported device {phi_nn.device}')
    d = phi_xx.shape[-1]
    if (phi_xx.shape != phi_nn.shape or phi_xx.shape[-2] != d
            or phi_xx.device != phi_nn.device):
        raise ValueError(
            f'pencils must be matching (..., D, D) on one device, got '
            f'{tuple(phi_xx.shape)} and {tuple(phi_nn.shape)}')
    if phi_xx.dtype != torch.complex64 or phi_nn.dtype != torch.complex64:
        raise ValueError(
            f'complex64 pencils required, got {phi_xx.dtype}, '
            f'{phi_nn.dtype}')
    if d > 16:
        raise ValueError(f'the GEV kernel takes D <= 16, got {d}')
    batch = phi_xx.shape[:-2]
    xx = phi_xx.resolve_conj().reshape(-1, d, d).contiguous()
    nn = phi_nn.resolve_conj().reshape(-1, d, d).contiguous()
    B = xx.shape[0]
    beam = torch.empty((B, d), dtype=torch.complex64, device=xx.device)
    if B:
        from ._build import load
        err = load('gev').gev_launch(
            xx.data_ptr(), nn.data_ptr(), beam.data_ptr(), B, d,
            default_sweeps(d) if sweeps is None else int(sweeps),
            torch.cuda.current_stream(xx.device).cuda_stream)
        if err:
            raise RuntimeError(f'gev kernel launch failed: CUDA error {err}')
        gev.launches += 1
    return beam.reshape(*batch, d)


gev.launches = 0
