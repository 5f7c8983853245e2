"""Whole-fit complex Watson mixture EM in one CUDA launch (kernel
``csrc/cwmm_loop.cu``, K6).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_cwmm_loop.py:cwmm_em_full``. One CTA owns one
(utterance, frequency bin) and runs every EM iteration with the bin's
observations resident in shared memory, on the whole-fit cACGMM kernel's
iteration body (``csrc/em_iter.cuh``, templated on D): the
affiliation-weighted Hermitian scatter summed in registers, the column
Jacobi in registers (a bin's K classes on one warp; cold ``sweeps`` in
iteration 0, then ``warm_sweeps`` from the previous eigenbasis, in the
plain twin's cyclic order, its disjoint rotations at once), the dominant
eigenpair, the concentration
from a *uniform* ratio table (:func:`concentration_table`, one pair of
loads; the scan path and the streamed kernel use the log-spaced
``hyp1f1`` table), the switched log-norm and the E-step
``kappa |<y, m>|^2 - log Z`` with a max-shift softmax, a thread per
frame. Saliency weights the statistics and L1-normalizes the mixture
weight. The final E-step is ``CWMM.predict``, so the fit returns its
posterior with no extra pass.

What bounds it on the H100: the observations are read from device
memory once per fit, so the kernel is bound by its instructions (the
scatter, the E-step and the Jacobi's latency chain), not by bytes.

Gate (:func:`fits`): D <= 16 (the template's range) and the bin's
working set, :func:`smem_bytes`, within the 227 KB of shared memory a
block may opt into on the H100: T <= 3833 frames at D=6, K=3, 3593 with
saliency (:func:`max_frames`), so a minute at 8 kHz (T=3753) stays on
the kernel. It replaces the JAX package's VMEM tile budget
(``pallas_cwmm_loop.choose_tile_f_cwmm``). The CTA's warps follow the
bin's shared memory and T (:func:`_threads`, the cACGMM kernel's rule).

On a CPU tensor the wrapper runs the plain PyTorch twin,
:func:`cwmm_em_full_reference` (iterations of
:func:`cwmm_em_step_reference`). On a CUDA tensor it launches the kernel
or raises; it never falls back.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .._dtypes import tiny as _tiny
from ._build import SMEM_LIMIT, counted, launch
from .em_loop import cta_threads
from .linalg import eigh_jacobi

__all__ = ['cwmm_em_full', 'cwmm_em_full_reference',
           'cwmm_em_step_reference', 'concentration_table',
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
    ``table`` at ``(lam - r0) / dr``, clamped at both ends (at D=1 the
    table is one value and dr is 0: a 0 / 0 looks up its first entry, as
    the kernel's fmaxf(NaN, 0) does)."""
    G = table.shape[0]
    idx = torch.clamp(torch.nan_to_num((lam - r0) / dr, nan=0.0), 0.0,
                      G - 1.0)
    i0 = torch.clamp(idx.floor().long(), max=G - 2)
    f = idx - i0.to(idx.dtype)
    return table[i0] * (1 - f) + table[i0 + 1] * f


def smem_bytes(D, K, T, has_sal=False):
    """Shared memory one bin's CTA takes (cwmm_smem_bytes in
    csrc/cwmm_loop.cu): y with an odd row stride, the scatter and the
    eigenvectors, the upper-triangle sums, the modes, the posterior times
    saliency, the saliency (with saliency) and four scalars per class."""
    Tp = T if D == 1 else T | 1
    P = D * (D + 1) // 2
    return 8 * (D * Tp + 2 * K * D * D + K * P + K * D) + 4 * (
        K * T + has_sal * T + 4 * K)


def max_frames(D, K, has_sal=False):
    """Longest T the kernel takes at (D, K)."""
    P = D * (D + 1) // 2
    fixed = 8 * (D + 2 * K * D * D + K * P + K * D) + 16 * K
    T = (SMEM_LIMIT - fixed) // (8 * D + 4 * K + 4 * has_sal)
    while smem_bytes(D, K, T + 1, has_sal) <= SMEM_LIMIT:
        T += 1
    return T


def fits(D, K, T, has_sal=False):
    """Does the whole-fit Watson kernel take this shape?"""
    return D <= 16 and smem_bytes(D, K, T, has_sal) <= SMEM_LIMIT


def _threads(D, K, T, has_sal=False):
    """Threads of one bin's CTA (ops/em_loop.cta_threads)."""
    return cta_threads(smem_bytes(D, K, T, has_sal), D, K, T)


def _dominant(values):
    """Index of the largest of the (..., D) eigenvalues, ties to the
    highest index (the kernel's column lanes; a stable ascending sort's
    last)."""
    D = values.shape[-1]
    return D - 1 - torch.argmax(values.flip(-1), dim=-1)


def cwmm_em_step_reference(y, affiliation, previous=None, *, sweeps=6,
                           warm_sweeps=2, max_concentration=500.0,
                           saliency=None):
    """One EM iteration of the kernel in plain PyTorch: the M-step from
    ``affiliation`` (times saliency), the Jacobi, the dominant eigenpair,
    the concentration from the uniform table, the log-norm and the
    E-step (``CWMM.predict``: no clip, no saliency).

    ``previous`` None is the kernel's first iteration: a cold Jacobi of
    ``sweeps`` sweeps from the identity. ``previous``, the (..., K, D, D)
    eigenvectors the kernel keeps between iterations (in its own column
    order), is a later one: the scatter rotated into that eigenbasis,
    ``V^H S V`` (Hermitian from its upper triangle), then ``warm_sweeps``
    cyclic sweeps whose rotations are applied to ``V`` (the kernel's order:
    two warm sweeps need not converge, and the order decides what they
    leave off the diagonal). The mode is the column of the largest
    eigenvalue, ties to the highest index.

    Args: as :func:`cwmm_em_full`. Returns: (weight (..., K), mode
    (..., K, D), concentration (..., K), affiliation (..., K, T),
    eigenvectors (..., K, D, D) unsorted, the state of the next step).
    """
    from ..models._precision import full_fp32
    from ..models.complex_watson import ComplexWatson
    from ..models.mixture_model_utils import log_pdf_to_affiliation

    D, T = y.shape[-2:]
    r0, dr, _ = concentration_table(D, float(max_concentration))
    table = _device_table(D, float(max_concentration), y.device)
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
    if previous is None:
        eigenvalues, eigenvectors = eigh_jacobi(scatter, sweeps=sweeps,
                                                sort=False)
    else:
        with full_fp32():
            rotated = previous.conj().transpose(-1, -2) @ scatter @ previous
        strict = torch.triu(rotated, 1)
        rotated = strict + strict.conj().transpose(-1, -2) \
            + torch.diag_embed(torch.diagonal(
                rotated, dim1=-2, dim2=-1).real.to(rotated.dtype))
        eigenvalues, rotation = eigh_jacobi(rotated, sweeps=warm_sweeps,
                                            sort=False)
        with full_fp32():
            eigenvectors = previous @ rotation
    best = _dominant(eigenvalues)
    mode = torch.gather(eigenvectors, -1, best[..., None, None].expand(
        *best.shape, D, 1))[..., 0]
    kappa = table_concentration(
        torch.gather(eigenvalues, -1, best[..., None])[..., 0], r0, dr,
        table)
    log_norm = ComplexWatson.log_norm_tran_vu(kappa, D)
    with full_fp32():
        z = torch.einsum('...kd,...dt->...kt', mode.conj(), y)
    log_pdf = kappa[..., None] * (z.real ** 2 + z.imag ** 2) \
        - log_norm[..., None]
    posterior = log_pdf_to_affiliation(weight[..., None], log_pdf)
    return weight, mode, kappa, posterior, eigenvectors


def cwmm_em_full_reference(y, affiliation, *, iterations, sweeps=6,
                           max_concentration=500.0, saliency=None,
                           return_eigenvectors=False):
    """Plain PyTorch twin of the kernel: ``iterations`` cold steps of
    :func:`cwmm_em_step_reference` (``sweeps`` from the identity every
    iteration, as the JAX kernel runs), each from the previous one's
    posterior. The kernel warm-starts later iterations, which converges to
    the same eigendecomposition; :func:`cwmm_em_step_reference` with
    ``previous`` holds one of its warm steps.

    Args and returns: as :func:`cwmm_em_full`.
    """
    for _ in range(iterations):
        out = cwmm_em_step_reference(
            y, affiliation, sweeps=sweeps,
            max_concentration=max_concentration, saliency=saliency)
        affiliation = out[3]
    return out if return_eigenvectors else out[:4]


@counted
def cwmm_em_full(y, affiliation, *, iterations, sweeps=6, warm_sweeps=None,
                 max_concentration=500.0, saliency=None,
                 return_eigenvectors=False):
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
        return_eigenvectors: also return the last M-step's eigenvectors
            (..., F, K, D, D) in the kernel's own column order, the state
            from which :func:`cwmm_em_step_reference` continues the fit.
    Returns:
        (weight (..., F, K), mode (..., F, K, D) complex64, concentration
        (..., F, K), affiliation (..., F, K, T)[, eigenvectors]).
    """
    if iterations < 1:
        raise ValueError(f'iterations must be >= 1, got {iterations}')
    if y.device.type == 'cpu':
        return cwmm_em_full_reference(
            y, affiliation, iterations=iterations, sweeps=sweeps,
            max_concentration=max_concentration, saliency=saliency,
            return_eigenvectors=return_eigenvectors)
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
    vec = torch.empty((N, K, D, D), dtype=torch.complex64, device=y.device) \
        if return_eigenvectors else None
    if N:
        launch(cwmm_em_full, 'cwmm_loop', 'cwmm_em_full_launch',
               y_.data_ptr(), a_.data_ptr(),
               0 if sal_ is None else sal_.data_ptr(), table.data_ptr(),
               weight.data_ptr(), mode.data_ptr(), kappa.data_ptr(),
               aff.data_ptr(), 0 if vec is None else vec.data_ptr(), N, D,
               K, T, _threads(D, K, T, has_sal), int(iterations),
               int(sweeps), -1 if warm_sweeps is None else int(warm_sweeps),
               r0, dr, table.shape[0], log2pi_d, lgamma_d,
               torch.cuda.current_stream(y.device).cuda_stream)
    out = (weight.reshape(*lead, K), mode.reshape(*lead, K, D),
           kappa.reshape(*lead, K), aff.reshape(*lead, K, T))
    return out + (vec.reshape(*lead, K, D, D),) if return_eigenvectors \
        else out
