"""Whole-fit integration-model EM in one cooperative CUDA launch (kernel
``csrc/integration_em_loop.cu``, K12).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_integration_em_loop.py:integration_em_full``.
The spectral model of ``VMFCACGMM`` / ``GCACGMM`` is global over the bins
of an utterance, so each EM iteration ends in a reduction over all of
them; the kernel is persistent and cooperative, with a grid-wide sync
between the per-bin step and the per-utterance spectral step. Per
iteration: each bin's E-step and sums (as K10), its spectral rows, its
M-step (the weight, the covariance rotated into the previous eigenbasis
and a warm Jacobi: ``sweeps`` in the first iteration, ``warm_sweeps``
after it, the eigenvalues max-normalized and floored); a grid sync; the
rows of each utterance added in a fixed order into its accumulator and,
before the next iteration, the closed-form spectral M-step (Banerjee's
vMF with log C interpolated in :func:`vmf_log_norm_table`, or the
Gaussian moment match); a grid sync. The caller finishes the spectral
model of the last iteration's accumulators (``models/vmfcacgmm.py``,
``models/gcacgmm.py``); the eigenpairs return ascending.

What bounds it on the H100: the E-step re-reads y and the embedding
every iteration (20 MB at F=513, T=300, D=6, E=20, which L2 holds for one
utterance), plus the serial per-iteration part: a warp's Jacobi per class
and two grid-wide syncs.

Gate (:func:`fits`): D <= 16 and the CTA's working set,
:func:`smem_bytes`, within the 227 KB of shared memory a block may opt
into (it holds one tile of frames, so T is unlimited); the grid is sized
at launch to the CTAs the card keeps co-resident (the occupancy per SM
times the SMs), at most one per bin. A launch that cannot be
co-resident raises. It replaces the JAX package's VMEM budget
(``choose_tile_f_loop``).

On a CPU tensor the wrapper runs the plain PyTorch twin,
:func:`integration_em_full_reference`, which takes the kernel's warm
step. On a CUDA tensor it launches the kernel or raises; it never falls
back.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .._dtypes import tiny as _tiny
from ._build import SMEM_LIMIT
from .integration_em import MODES, TILE, _check_mode, e_stats_reference
from .linalg import eigh_jacobi, sort_ascending

__all__ = ['integration_em_full', 'integration_em_full_reference',
           'integration_em_step_reference', 'vmf_log_norm_table',
           'spec_rows', 'acc_rows', 'smem_bytes', 'fits',
           'spectral_m_step_reference', 'TABLE_SIZE']

TABLE_SIZE = 1024
_WARPS = 8  # kThreads / 32 of csrc/integration.cuh


def spec_rows(e_dim, k, spectral_mode):
    """Floats of one utterance's spectral state: 'vmf' mean (E K),
    concentration (K), log normalizer (K); 'gaussian' precision-scaled mean
    (E K), precision (E K), constant (K)."""
    _check_mode(spectral_mode)
    return e_dim * k + 2 * k if spectral_mode == 'vmf' \
        else 2 * e_dim * k + k


def acc_rows(e_dim, k, spectral_mode):
    """Floats of one utterance's accumulator: the resultants
    ``sum_t a e`` (K E, class-major), ``sum_t a`` (K) and, for
    'gaussian', the second moments ``sum_t a e^2`` (K E)."""
    _check_mode(spectral_mode)
    return e_dim * k + k + (e_dim * k if spectral_mode == 'gaussian' else 0)


def vmf_log_norm_table(dim, min_concentration, max_concentration,
                       size=TABLE_SIZE):
    """The vMF log normalizer on a sqrt-spaced concentration grid (denser
    where it curves): ``(s0, ds, values)`` with ``values[g] =
    log_norm(kappa=(s0 + g ds)^2)`` (float32), evaluated with scipy's
    ``ive``. The kernel interpolates linearly at ``(sqrt(kappa) - s0) /
    ds``."""
    from scipy.special import ive
    nu = dim / 2 - 1
    s0 = float(np.sqrt(min_concentration))
    s1 = float(np.sqrt(max_concentration))
    ds = (s1 - s0) / (size - 1)
    kappa = (s0 + ds * np.arange(size)) ** 2
    kappa = np.clip(kappa, min_concentration, max_concentration)
    values = ((dim / 2) * np.log(2 * np.pi)
              + np.log(ive(nu, kappa)) + kappa - nu * np.log(kappa))
    return s0, ds, values.astype(np.float32)


def smem_bytes(D, K, E, spectral_mode):
    """Shared memory one CTA needs (csrc/integration_em_loop.cu)."""
    P = D * (D + 1) // 2
    A = acc_rows(E, K, spectral_mode)
    return 8 * (D * TILE + 3 * K * D * D + K * P) + 4 * (
        E * TILE + 2 * K * TILE + 4 * K * E + 5 * K + 2 * K * D
        + (_WARPS + 1) * A)


def fits(D, K, E, spectral_mode):
    """Does the whole-fit kernel take (D, K, E)? T is walked in tiles, so
    it does not change the budget."""
    return D <= 16 and smem_bytes(D, K, E, spectral_mode) <= SMEM_LIMIT


def interpolate_log_norm(kappa, table, s0, ds):
    """The kernel's two-load linear interpolation of the log normalizer
    table (a float32 tensor) at ``kappa``."""
    size = table.shape[0]
    idx = torch.clamp((torch.sqrt(kappa) - s0) / ds, 0., size - 1.)
    lo = torch.clamp(torch.floor(idx).long(), max=size - 2)
    w = idx - lo.to(idx.dtype)
    return table[lo] * (1 - w) + table[lo + 1] * w


def spectral_m_step_reference(acc, *, E, K, spectral_mode, spherical=True,
                              min_concentration=1e-10,
                              max_concentration=500., table=None):
    """The kernel's closed-form spectral M-step from (U, A) accumulators:
    'vmf' (mean (U, K, E), concentration (U, K), log C from ``table`` =
    (s0, ds, values tensor)); 'gaussian' (precision-scaled mean, precision
    (U, K, E), constant (U, K))."""
    tiny = _tiny(acc)
    r = acc[:, :K * E].reshape(-1, K, E)
    n = acc[:, K * E:K * E + K]
    if spectral_mode == 'vmf':
        norm = torch.linalg.vector_norm(r, dim=-1)
        mean = r / torch.clamp(norm, min=tiny)[..., None]
        r_bar = norm / torch.clamp(n, min=tiny)
        kappa = torch.clamp((r_bar * E - r_bar ** 3) / (1 - r_bar ** 2),
                            min_concentration, max_concentration)
        s0, ds, values = table
        return mean, kappa, interpolate_log_norm(kappa, values, s0, ds)
    m2 = acc[:, K * E + K:].reshape(-1, K, E)
    denom = torch.clamp(n, min=tiny)[..., None]
    mean = r / denom
    centered = torch.clamp(m2 / denom - mean ** 2, min=tiny)
    if spherical:
        cov = centered.mean(-1, keepdim=True)
        prec = (1. / cov).expand_as(mean)
        ldpc = -0.5 * E * torch.log(cov[..., 0])
    else:
        prec = 1. / centered
        ldpc = -0.5 * torch.log(centered).sum(-1)
    const = 0.5 * E * math.log(2 * math.pi) - ldpc \
        + 0.5 * (mean ** 2 * prec).sum(-1)
    return prec * mean, prec, const


def warm_eigh(covariance, vectors, sweeps):
    """The kernel's warm Jacobi: rotate into the previous eigenbasis,
    ``V^H C V`` made Hermitian from its upper triangle, then ``sweeps``
    cyclic sweeps whose rotations are applied to ``V`` (unsorted)."""
    from ..models._precision import full_fp32
    with full_fp32():
        rotated = vectors.conj().transpose(-1, -2) @ covariance @ vectors
    strict = torch.triu(rotated, 1)
    rotated = strict + strict.conj().transpose(-1, -2) + torch.diag_embed(
        torch.diagonal(rotated, dim1=-2, dim2=-1).real.to(rotated.dtype))
    values, rotation = eigh_jacobi(rotated, sweeps=sweeps, sort=False)
    with full_fp32():
        return values, vectors @ rotation


def integration_em_step_reference(y, emb, state, *, bins_per_utt, sweeps,
                                  spectral_mode='vmf', spatial_weight=1.,
                                  spectral_weight=1., affiliation_eps=1e-10,
                                  eigenvalue_floor=1e-10):
    """One iteration of the kernel in plain PyTorch: the E-step and sums
    from ``state`` = (eigenvectors (N, K, D, D), eigenvalues (N, K, D),
    weight (N, K), (mu, kappa, log_c) of the U utterances), then each
    bin's M-step with the warm Jacobi of ``sweeps`` sweeps. Returns the
    new (eigenvectors, eigenvalues unsorted, weight) and the (U, A)
    accumulators."""
    vectors, eigenvalues, weight, spec = state
    N, D, _ = y.shape
    K = weight.shape[-1]
    E = emb.shape[-2]
    U = N // bins_per_utt
    tiny = _tiny(weight)
    scatter, asum, res, m2 = e_stats_reference(
        y, emb, eigenvalues=eigenvalues, eigenvectors=vectors, weight=weight,
        mu=spec[0], kappa=spec[1], log_c=spec[2], bins_per_utt=bins_per_utt,
        spectral_mode=spectral_mode, spatial_weight=spatial_weight,
        spectral_weight=spectral_weight, affiliation_eps=affiliation_eps)
    parts = [res.reshape(U, bins_per_utt, K * E),
             asum.reshape(U, bins_per_utt, K)]
    if m2 is not None:
        parts.append(m2.reshape(U, bins_per_utt, K * E))
    acc = torch.cat(parts, -1).sum(1)
    weight = asum / torch.clamp(asum.sum(-1, keepdim=True), min=tiny)
    covariance = D * scatter / torch.clamp(
        asum, min=tiny)[..., None, None].to(scatter.dtype)
    values, vectors = warm_eigh(covariance, vectors, sweeps)
    lam_max = torch.clamp(values.max(-1, keepdim=True).values, min=tiny)
    eigenvalues = torch.clamp(values / lam_max, min=eigenvalue_floor)
    return vectors, eigenvalues, weight, acc


def integration_em_full_reference(y, emb, eigenvectors, eigenvalues, weight,
                                  mu, kappa, log_c, *, iterations,
                                  bins_per_utt=None, sweeps=6, warm_sweeps=2,
                                  spectral_mode='vmf', spherical=True,
                                  spatial_weight=1., spectral_weight=1.,
                                  affiliation_eps=1e-10,
                                  eigenvalue_floor=1e-10,
                                  min_concentration=1e-10,
                                  max_concentration=500.,
                                  table_size=TABLE_SIZE, sort=True):
    """Plain PyTorch twin of the kernel: ``iterations`` of
    :func:`integration_em_step_reference` (``sweeps`` in the first,
    ``warm_sweeps`` after it), the spectral M-step between them.

    Args and returns: as :func:`integration_em_full`.
    """
    _check_mode(spectral_mode)
    N = y.shape[0]
    K = weight.shape[-1]
    E = emb.shape[-2]
    bins_per_utt = N if bins_per_utt is None else bins_per_utt
    table = None
    if spectral_mode == 'vmf':
        s0, ds, values = vmf_log_norm_table(
            E, min_concentration, max_concentration, table_size)
        table = (s0, ds, torch.as_tensor(values, device=y.device))
    state = (eigenvectors, eigenvalues, weight, (mu, kappa, log_c))
    for it in range(iterations):
        vectors, values, weight, acc = integration_em_step_reference(
            y, emb, state, bins_per_utt=bins_per_utt,
            sweeps=sweeps if it == 0 else warm_sweeps,
            spectral_mode=spectral_mode, spatial_weight=spatial_weight,
            spectral_weight=spectral_weight, affiliation_eps=affiliation_eps,
            eigenvalue_floor=eigenvalue_floor)
        spec = state[3]
        if it < iterations - 1:
            spec = spectral_m_step_reference(
                acc, E=E, K=K, spectral_mode=spectral_mode,
                spherical=spherical, min_concentration=min_concentration,
                max_concentration=max_concentration, table=table)
        state = (vectors, values, weight, spec)
    values, vectors = state[1], state[0]
    if sort:
        values, vectors = sort_ascending(values, vectors)
    return values, vectors, state[2], acc


def integration_em_full(y, emb, eigenvectors, eigenvalues, weight, mu, kappa,
                        log_c, *, iterations, bins_per_utt=None, sweeps=6,
                        warm_sweeps=2, spectral_mode='vmf', spherical=True,
                        spatial_weight=1., spectral_weight=1.,
                        affiliation_eps=1e-10, eigenvalue_floor=1e-10,
                        min_concentration=1e-10, max_concentration=500.,
                        table_size=TABLE_SIZE, sort=True, grid=None):
    """Run ``iterations`` integration-model EM steps (E-step + full M-step)
    as ONE cooperative kernel launch.

    Args:
        y: (N, D, T) complex64 unit-norm, time-last observations, N =
            U * bins_per_utt (utterances folded into the bin axis).
        emb: (N, E, T) float32 raw embedding, time-last.
        eigenvectors (N, K, D, D), eigenvalues (N, K, D), weight (N, K):
            the initial cACG model and mixture weight of each bin.
        mu / kappa / log_c: the initial spectral state of each utterance
            (as :func:`pb_bss_tpu_torch.ops.integration_em.e_stats`).
        bins_per_utt: bins of one utterance (default N).
        sweeps / warm_sweeps: Jacobi sweeps of the first and the later
            iterations (each from the previous eigenbasis).
        spherical: the Gaussian's covariance type ('spherical' or
            'diagonal').
        sort: return the eigenpairs ascending (the model's order); False
            keeps the kernel's own column order, from which a further warm
            step continues exactly as the kernel's next iteration would.
        grid: CTAs to launch (default: the co-resident maximum, at most
            one per bin); a grid that cannot be co-resident raises.
    Returns:
        (eigenvalues (N, K, D) ascending, eigenvectors (N, K, D, D)
        complex64, weight (N, K), accumulators (U, A) of the last E-step
        (:func:`acc_rows` layout)).
    """
    _check_mode(spectral_mode)
    if iterations < 1:
        raise ValueError(f'iterations must be >= 1, got {iterations}')
    kwargs = dict(iterations=iterations, bins_per_utt=bins_per_utt,
                  sweeps=sweeps, warm_sweeps=warm_sweeps,
                  spectral_mode=spectral_mode, spherical=spherical,
                  spatial_weight=spatial_weight,
                  spectral_weight=spectral_weight,
                  affiliation_eps=affiliation_eps,
                  eigenvalue_floor=eigenvalue_floor,
                  min_concentration=min_concentration,
                  max_concentration=max_concentration, table_size=table_size,
                  sort=sort)
    if y.device.type == 'cpu':
        return integration_em_full_reference(
            y, emb, eigenvectors, eigenvalues, weight, mu, kappa, log_c,
            **kwargs)
    if y.device.type != 'cuda':
        raise ValueError(f'unsupported device {y.device}')
    if y.dtype != torch.complex64 or y.ndim != 3:
        raise ValueError(
            f'y must be complex64 (N, D, T), got {y.dtype} {tuple(y.shape)}')
    N, D, T = y.shape
    K = weight.shape[-1]
    E = emb.shape[-2]
    bins_per_utt = N if bins_per_utt is None else int(bins_per_utt)
    if bins_per_utt < 1 or N % bins_per_utt:
        raise ValueError(f'{N} bins do not fold into utterances of '
                         f'{bins_per_utt} bins')
    U = N // bins_per_utt
    if not fits(D, K, E, spectral_mode):
        raise ValueError(
            f'(D={D}, K={K}, E={E}) is outside the whole-fit integration '
            'kernel gate (D <= 16 and the shared-memory budget)')
    gaussian = spectral_mode == 'gaussian'

    def state(x, shape, dtype):
        """A private, contiguous copy: the kernel updates it in place."""
        if tuple(x.shape) != shape or x.device != y.device:
            raise ValueError(
                f'expected {shape} on {y.device}, got {tuple(x.shape)} '
                f'on {x.device}')
        return x.resolve_conj().to(dtype).clone().contiguous()

    if tuple(emb.shape) != (N, E, T) or emb.device != y.device:
        raise ValueError(f'emb must be {(N, E, T)} on {y.device}, got '
                         f'{tuple(emb.shape)} on {emb.device}')
    y_ = y.resolve_conj().contiguous()
    emb_ = emb.to(torch.float32).contiguous()
    vec = state(eigenvectors, (N, K, D, D), torch.complex64)
    eig = state(eigenvalues, (N, K, D), torch.float32)
    w = state(weight, (N, K), torch.float32)
    svec = state(mu, (U, K, E), torch.float32)
    sb = state(kappa, (U, K, E) if gaussian else (U, K), torch.float32)
    sc = state(log_c, (U, K), torch.float32)
    A = acc_rows(E, K, spectral_mode)
    f32 = dict(dtype=torch.float32, device=y.device)
    rows = torch.empty((N, A), **f32)
    acc = torch.zeros((U, A), **f32)
    s0 = ds = 0.
    table = None
    if not gaussian:
        s0, ds, values = vmf_log_norm_table(
            E, min_concentration, max_concentration, table_size)
        table = torch.as_tensor(values, device=y.device)
    if N:
        from ._build import load
        used = ctypes.c_int(0)
        err = load('integration_em_loop').integration_em_loop_launch(
            y_.data_ptr(), emb_.data_ptr(), vec.data_ptr(), eig.data_ptr(),
            w.data_ptr(), svec.data_ptr(), sb.data_ptr(), sc.data_ptr(),
            rows.data_ptr(), acc.data_ptr(),
            0 if table is None else table.data_ptr(), N, D, K, T, E,
            bins_per_utt, int(iterations), int(sweeps), int(warm_sweeps),
            MODES[spectral_mode], float(eigenvalue_floor),
            float(spatial_weight), float(spectral_weight),
            float(affiliation_eps), float(min_concentration),
            float(max_concentration), int(table_size), float(s0), float(ds),
            int(bool(spherical)), 0 if grid is None else int(grid),
            ctypes.byref(used),
            torch.cuda.current_stream(y.device).cuda_stream)
        if err:
            raise RuntimeError(
                f'integration_em_full kernel launch failed: CUDA error {err}'
                f' (grid {used.value or grid})')
        integration_em_full.launches += 1
        integration_em_full.last_grid = used.value
    if sort:
        eig, vec = sort_ascending(eig, vec)
    return eig, vec, w, acc


integration_em_full.launches = 0
integration_em_full.last_grid = 0
