"""Whole-fit complex Watson mixture EM in one CUDA launch (kernel
``csrc/cwmm_loop.cu``).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_cwmm_loop.py:cwmm_em_full``. One CTA owns one
(utterance, frequency bin) and runs every EM iteration with the bin's
observations resident in shared memory: the affiliation-weighted
Hermitian scatter, the warm-started complex Jacobi (cold ``sweeps`` in
iteration 0, then ``warm_sweeps`` from the previous eigenbasis), the
dominant eigenpair, the concentration from a *uniform* ratio table
(:func:`concentration_table`, one pair of loads; the scan path and the
streamed kernel use the log-spaced ``hyp1f1`` table), the switched
log-norm and the E-step ``kappa |<y, m>|^2 - log Z`` with a max-shift
softmax. Saliency weights the statistics and L1-normalizes the mixture
weight. The final E-step is ``CWMM.predict``, so the fit returns its
posterior with no extra pass.

What bounds it on the H100: the observations are read from device
memory once per fit, so the kernel is bound by the fp32 FMAs of the
scatter and the E-step, not by bytes.

Gate (:func:`fits`): D <= 16 (a warp owns a D x D Jacobi) and the bin's
working set, :func:`smem_bytes`, within the 227 KB of shared memory a
block may opt into on the H100: T <= 3827 frames at D=6, K=3, 3588 with
saliency (:func:`max_frames`). It replaces the JAX package's VMEM tile
budget (``pallas_cwmm_loop.choose_tile_f_cwmm``).

On a CPU tensor the wrapper runs the plain PyTorch twin,
:func:`cwmm_em_full_reference`. On a CUDA tensor it launches the kernel
or raises; it never falls back.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._dtypes import tiny as _tiny
from ._build import SMEM_LIMIT
from .linalg import eigh_jacobi

__all__ = ['cwmm_em_full', 'cwmm_em_full_reference', 'concentration_table',
           'table_concentration', 'smem_bytes', 'max_frames', 'fits']

TABLE_SIZE = 512


@functools.lru_cache(maxsize=None)
def concentration_table(dimension, max_concentration=500.0,
                        size=TABLE_SIZE):
    """Uniform-in-ratio concentration lookup table.

    Returns ``(r0, dr, kappa_values)`` such that the dominant eigenvalue
    ``r`` of the unit-trace scatter (in [1/D, 1]) maps to the linear
    interpolation of ``kappa_values`` at ``(r - r0) / dr``. Built by
    inverting the hypergeometric ratio ``M(2, D+1, k) / (D M(1, D, k))``
    on a dense log-spaced kappa grid, as the JAX package builds it.
    """
    from scipy.special import hyp1f1
    kappa_dense = np.concatenate(
        [[0.0], np.logspace(-3, np.log10(max_concentration), 4096)])
    ratio_dense = np.concatenate([
        [1.0 / dimension],
        hyp1f1(2, dimension + 1, kappa_dense[1:])
        / (dimension * hyp1f1(1, dimension, kappa_dense[1:])),
    ])
    r0 = 1.0 / dimension
    r1 = float(ratio_dense[-1])
    grid = np.linspace(r0, r1, size)
    kappa = np.interp(grid, ratio_dense, kappa_dense)
    dr = (r1 - r0) / (size - 1)
    return float(r0), float(dr), kappa.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_table(dimension, max_concentration, device):
    return torch.as_tensor(
        concentration_table(dimension, max_concentration)[2], device=device)


def _log_norm_constants(dimension):
    """(log 2 + D log pi, lgamma(D)): the host constants of the kernel's
    log-norm."""
    return (math.log(2.0) + dimension * math.log(math.pi),
            math.lgamma(dimension))


def table_concentration(lam, r0, dr, table):
    """The kernel's table lookup: linear interpolation of the uniform
    ``table`` at ``(lam - r0) / dr``, clamped at both ends."""
    G = table.shape[0]
    idx = torch.clamp((lam - r0) / dr, 0.0, G - 1.0)
    i0 = torch.clamp(idx.floor().long(), max=G - 2)
    f = idx - i0.to(idx.dtype)
    return table[i0] * (1 - f) + table[i0 + 1] * f


def smem_bytes(D, K, T, has_sal=False):
    """Shared memory one bin's CTA needs (csrc/cwmm_loop.cu); saliency
    adds T floats."""
    return 8 * (D * T + 3 * K * D * D + K * D) + 4 * (
        K * T + has_sal * T + 4 * K)


def max_frames(D, K, has_sal=False):
    """Longest T the kernel takes at (D, K)."""
    return (SMEM_LIMIT - 8 * (3 * K * D * D + K * D) - 16 * K) \
        // (8 * D + 4 * K + 4 * has_sal)


def fits(D, K, T, has_sal=False):
    """Does the whole-fit Watson kernel take this shape?"""
    return D <= 16 and smem_bytes(D, K, T, has_sal) <= SMEM_LIMIT


def cwmm_em_full_reference(y, affiliation, *, iterations, sweeps=6,
                           max_concentration=500.0, saliency=None):
    """Plain PyTorch twin of the kernel: the scan path's M-step (with the
    uniform concentration table) and E-step, and one trailing E-step. It
    runs a cold Jacobi with ``sweeps`` every iteration; the kernel
    warm-starts later iterations, which converges to the same
    eigendecomposition.

    Args: as :func:`cwmm_em_full`.
    """
    from ..models._precision import full_fp32
    from ..models.complex_watson import ComplexWatson
    from ..models.mixture_model_utils import log_pdf_to_affiliation

    D, T = y.shape[-2:]
    r0, dr, _ = concentration_table(D, float(max_concentration))
    table = _device_table(D, float(max_concentration), y.device)
    weight = mode = kappa = None
    for _ in range(iterations):
        a = affiliation if saliency is None \
            else affiliation * saliency[..., None, :]
        asum = a.sum(-1)  # (..., K)
        if saliency is None:
            weight = asum / T
        else:
            norm = asum.sum(-1, keepdim=True)
            weight = asum / torch.where(norm == 0,
                                        torch.full_like(norm, 1e-10), norm)
        with full_fp32():
            scatter = (y[..., None, :, :] * a[..., None, :].to(y.dtype)) \
                @ y[..., None, :, :].conj().transpose(-1, -2)
        scatter = scatter / torch.clamp(
            asum, min=_tiny(asum))[..., None, None].to(scatter.dtype)
        eigenvalues, eigenvectors = eigh_jacobi(scatter, sweeps=sweeps)
        mode = eigenvectors[..., :, -1]
        kappa = table_concentration(eigenvalues[..., -1], r0, dr, table)
        log_norm = ComplexWatson.log_norm_tran_vu(kappa, D)
        with full_fp32():
            z = torch.einsum('...kd,...dt->...kt', mode.conj(), y)
        log_pdf = kappa[..., None] * (z.real ** 2 + z.imag ** 2) \
            - log_norm[..., None]
        affiliation = log_pdf_to_affiliation(weight[..., None], log_pdf)
    return weight, mode, kappa, affiliation


def cwmm_em_full(y, affiliation, *, iterations, sweeps=6, warm_sweeps=None,
                 max_concentration=500.0, saliency=None):
    """Run a full complex Watson mixture EM fit as ONE kernel launch.

    ``iterations`` M-steps from the given affiliations with an E-step
    after each; the last E-step is ``CWMM.predict`` on the returned
    model.

    Args:
        y: (F, D, T) or (B, F, D, T) complex64 unit-norm, time-last
            observations (a leading batch folds into the bin axis).
        affiliation: (..., F, K, T) initial posteriors.
        warm_sweeps: Jacobi sweeps of the warm-started iterations
            (None: every iteration cold with ``sweeps``).
        saliency: optional (..., F, T) frame weights of the statistics;
            the mixture weight is then L1-normalized over classes.
    Returns:
        (weight (..., F, K), mode (..., F, K, D) complex64, concentration
        (..., F, K), affiliation (..., F, K, T)).
    """
    if iterations < 1:
        raise ValueError(f'iterations must be >= 1, got {iterations}')
    if y.device.type == 'cpu':
        return cwmm_em_full_reference(
            y, affiliation, iterations=iterations, sweeps=sweeps,
            max_concentration=max_concentration, saliency=saliency)
    if y.device.type != 'cuda':
        raise ValueError(f'unsupported device {y.device}')
    if y.dtype != torch.complex64 or y.ndim not in (3, 4):
        raise ValueError(
            f'y must be complex64 (F, D, T) or (B, F, D, T), got '
            f'{y.dtype} {tuple(y.shape)}')
    *lead, D, T = y.shape
    K = affiliation.shape[-2]
    if tuple(affiliation.shape) != (*lead, K, T) or \
            affiliation.device != y.device:
        raise ValueError(
            f'affiliation must be {(*lead, K, T)} on {y.device}, got '
            f'{tuple(affiliation.shape)} on {affiliation.device}')
    has_sal = saliency is not None
    if not fits(D, K, T, has_sal):
        raise ValueError(
            f'(D={D}, K={K}, T={T}) is outside the whole-fit Watson kernel '
            f'gate (D <= 16, T <= {max_frames(D, K, has_sal)})')
    N = math.prod(lead)
    y_ = y.resolve_conj().reshape(N, D, T).contiguous()
    a_ = affiliation.reshape(N, K, T).to(torch.float32).contiguous()
    sal_ = None
    if has_sal:
        sal_ = torch.broadcast_to(
            torch.as_tensor(saliency, device=y.device), (*lead, T)
        ).reshape(N, T).to(torch.float32).contiguous()
    r0, dr, _ = concentration_table(D, float(max_concentration))
    table = _device_table(D, float(max_concentration), y.device)
    log2pi_d, lgamma_d = _log_norm_constants(D)
    weight = torch.empty((N, K), dtype=torch.float32, device=y.device)
    mode = torch.empty((N, K, D), dtype=torch.complex64, device=y.device)
    kappa = torch.empty((N, K), dtype=torch.float32, device=y.device)
    aff = torch.empty((N, K, T), dtype=torch.float32, device=y.device)
    if N:
        from ._build import load
        err = load('cwmm_loop').cwmm_em_full_launch(
            y_.data_ptr(), a_.data_ptr(),
            0 if sal_ is None else sal_.data_ptr(), table.data_ptr(),
            weight.data_ptr(), mode.data_ptr(), kappa.data_ptr(),
            aff.data_ptr(), N, D, K, T, int(iterations), int(sweeps),
            -1 if warm_sweeps is None else int(warm_sweeps), r0, dr,
            table.shape[0], log2pi_d, lgamma_d,
            torch.cuda.current_stream(y.device).cuda_stream)
        if err:
            raise RuntimeError(
                f'cwmm_em_full kernel launch failed: CUDA error {err}')
        cwmm_em_full.launches += 1
    return (weight.reshape(*lead, K), mode.reshape(*lead, K, D),
            kappa.reshape(*lead, K), aff.reshape(*lead, K, T))


cwmm_em_full.launches = 0
