"""Batched Hermitian Jacobi eigendecomposition in one CUDA launch
(kernel ``csrc/eigh.cu``).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_eigh.py:eigh_jacobi_pallas``. A lane owns one
column of one D x D matrix (D <= 16) in registers, floor(32 / D)
matrices to a warp; the cyclic sweeps of the plain twin run with their
disjoint rotations in one step (``column_jacobi_wavefront`` of
``csrc/em_iter.cuh``, with the twin's rotation at any scale), and each
lane ranks its eigenvalue by counting and writes its eigenpair at its
rank, so the sort (ascending, ties to the lower index, NaN last, as the
twin's stable ``torch.sort``) happens inside the kernel: the call is one
launch.

What bounds it on the H100: each matrix is a few hundred bytes against
6 sweeps of dependent rotation steps, so the sweeps' latency sets the
time; the design keeps them in registers with no barrier, and
:func:`cta_warps` sizes the CTAs so that they spread over every SM.

On a CPU tensor the wrapper runs the plain PyTorch twin,
:func:`eigh_jacobi_reference`. On a CUDA tensor it launches the kernel
or raises; it never falls back.
"""
from __future__ import annotations

import functools

import torch

from ._build import counted, launch
from .linalg import eigh_jacobi as _plain_eigh_jacobi

__all__ = ['eigh_jacobi', 'eigh_jacobi_reference', 'default_sweeps',
           'cta_warps']


def default_sweeps(d):
    """Sweeps of the JAX kernel's default: 6 for D <= 8, else 8."""
    return 6 if d <= 8 else 8


def cta_warps(B, D, sms):
    """Warps a CTA (4, 2 or 1) for B matrices of D x D on a card of
    ``sms`` SMs: the most that still leave at least two CTAs an SM, so
    that the warps spread over every SM (3,084 matrices at D=6 are 617
    warps: 309 CTAs of 2; the 1,539 of the integration finish, 308 CTAs
    of 1)."""
    warps = -(-B // (32 // D))
    for w in (4, 2):
        if -(-warps // w) >= 2 * sms:
            return w
    return 1


@functools.lru_cache(maxsize=None)
def _sms(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def eigh_jacobi_reference(a, *, sweeps=None, sort=True):
    """Plain PyTorch twin: the batched cyclic Jacobi of
    :func:`pb_bss_tpu_torch.ops.linalg.eigh_jacobi` with the kernel's
    default sweeps."""
    return _plain_eigh_jacobi(
        a, sweeps=default_sweeps(a.shape[-1]) if sweeps is None else sweeps,
        sort=sort)


@counted
def eigh_jacobi(a, *, sweeps=None, sort=True):
    """Batched Hermitian eigendecomposition.

    Args:
        a: (..., D, D) Hermitian complex64 or real symmetric float32,
            D <= 16.
        sweeps: cyclic Jacobi sweeps (default 6 for D <= 8, else 8).
        sort: sort the eigenpairs ascending (ties keep the lower index,
            NaN last).
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
    if not 1 <= d <= 16:
        raise ValueError(f'the Jacobi kernel takes 1 <= D <= 16, got {d}')
    batch = a.shape[:-2]
    flat = a.reshape(-1, d, d)
    if flat.is_conj() or not flat.is_contiguous():
        flat = flat.resolve_conj().contiguous()
    B = flat.shape[0]
    w = torch.empty((B, d), dtype=torch.float32, device=a.device)
    v = torch.empty((B, d, d), dtype=a.dtype, device=a.device)
    if B:
        launch(eigh_jacobi, 'eigh', 'eigh_jacobi_launch',
               flat.data_ptr(), w.data_ptr(), v.data_ptr(), B, d,
               default_sweeps(d) if sweeps is None else int(sweeps),
               int(a.is_complex()), int(bool(sort)),
               cta_warps(B, d, _sms(a.device.index or 0)),
               torch.cuda.current_stream(a.device).cuda_stream)
    return w.reshape(*batch, d), v.reshape(*batch, d, d)
