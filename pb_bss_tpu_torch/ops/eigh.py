"""Batched Hermitian Jacobi eigendecomposition in one CUDA launch
(kernel ``csrc/eigh.cu``).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_eigh.py:eigh_jacobi_pallas``. One warp owns one
D x D matrix (D <= 16) in shared memory and runs every cyclic Jacobi
sweep on it (the rotation of ``csrc/jacobi.cuh``, shared with the
whole-fit EM and GEV kernels); the eigenpairs are sorted ascending
afterwards with the stable :func:`~pb_bss_tpu_torch.ops.linalg.sort_ascending`,
as the JAX package sorts outside its ``pallas_call``.

What bounds it on the H100: each matrix is a few hundred bytes against
~90 dependent rotations per sweep set, so the kernel is bound by the
latency of one matrix's sweeps; the design runs one matrix per warp,
with no block-wide barrier, so that thousands are in flight at once.

On a CPU tensor the wrapper runs the plain PyTorch twin,
:func:`eigh_jacobi_reference`. On a CUDA tensor it launches the kernel
or raises; it never falls back.
"""
from __future__ import annotations

import torch

from .linalg import eigh_jacobi as _plain_eigh_jacobi, sort_ascending

__all__ = ['eigh_jacobi', 'eigh_jacobi_reference', 'default_sweeps']


def default_sweeps(d):
    """Sweeps of the JAX kernel's default: 6 for D <= 8, else 8."""
    return 6 if d <= 8 else 8


def eigh_jacobi_reference(a, *, sweeps=None, sort=True):
    """Plain PyTorch twin: the batched cyclic Jacobi of
    :func:`pb_bss_tpu_torch.ops.linalg.eigh_jacobi` with the kernel's
    default sweeps."""
    return _plain_eigh_jacobi(
        a, sweeps=default_sweeps(a.shape[-1]) if sweeps is None else sweeps,
        sort=sort)


def eigh_jacobi(a, *, sweeps=None, sort=True):
    """Batched Hermitian eigendecomposition.

    Args:
        a: (..., D, D) Hermitian complex64 or real symmetric float32,
            D <= 16.
        sweeps: cyclic Jacobi sweeps (default 6 for D <= 8, else 8).
        sort: sort the eigenpairs ascending (ties keep the lower index).
    Returns:
        (eigenvalues (..., D) float32, eigenvectors (..., D, D) in
        columns, complex64 for complex input and float32 for real
        input).
    """
    if a.device.type == 'cpu':
        return eigh_jacobi_reference(a, sweeps=sweeps, sort=sort)
    if a.device.type != 'cuda':
        raise ValueError(f'unsupported device {a.device}')
    d = a.shape[-1]
    if a.ndim < 2 or a.shape[-2] != d:
        raise ValueError(f'a must be (..., D, D), got {tuple(a.shape)}')
    if a.dtype not in (torch.complex64, torch.float32):
        raise ValueError(
            f'the Jacobi kernel takes complex64 or float32, got {a.dtype}')
    if d > 16:
        raise ValueError(f'the Jacobi kernel takes D <= 16, got {d}')
    batch = a.shape[:-2]
    flat = a.resolve_conj().reshape(-1, d, d).contiguous()
    B = flat.shape[0]
    w = torch.empty((B, d), dtype=torch.float32, device=a.device)
    v = torch.empty((B, d, d), dtype=a.dtype, device=a.device)
    if B:
        from ._build import load
        err = load('eigh').eigh_jacobi_launch(
            flat.data_ptr(), w.data_ptr(), v.data_ptr(), B, d,
            default_sweeps(d) if sweeps is None else int(sweeps),
            int(a.is_complex()),
            torch.cuda.current_stream(a.device).cuda_stream)
        if err:
            raise RuntimeError(
                f'eigh_jacobi kernel launch failed: CUDA error {err}')
        eigh_jacobi.launches += 1
    if sort:
        w, v = sort_ascending(w, v)
    return w.reshape(*batch, d), v.reshape(*batch, d, d)


eigh_jacobi.launches = 0
