"""Whole-fit complex Bingham mixture EM in one CUDA launch (kernel
``csrc/cbmm_loop.cu``, K9).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_cbmm_loop.py:cbmm_em_full``. One CTA owns one
(utterance, frequency bin) and runs every EM iteration with the bin's
observations resident in shared memory: the affiliation-weighted
Hermitian scatter, the warm-started complex Jacobi (cold ``sweeps`` in
iteration 0, then ``warm_sweeps`` from the previous eigenbasis), the
ascending sort of the moments (floored at 0) with their eigenvector
columns, the minimum spacing, the moment inversion by chord Gauss-Newton
(the chord kernel K8's device code, ``csrc/bingham.cuh``: ``cold_rounds``
rounds of ``cold_steps`` steps from ``-1/s`` in iteration 0, then one round
of ``warm_steps`` from the previous eigenvalues), the floor and spacing
under a finite ``max_concentration``, the log normalizer from one more
cascade and the E-step ``y^H V diag(lambda) V^H y - log c`` with a
max-shift softmax and the ``affiliation_eps`` clip. Saliency weights the
statistics and L1-normalizes the mixture weight. The final E-step is
unclipped: it is ``CBMM.predict``, so the fit returns its posterior with
no extra pass.

What bounds it on the H100: the fp32 operations of the cascades (about
12 kFLOP each at D=6, 49 per class in the first iteration and 23 after
it), not the observations, which are read once per fit.

Gate (:func:`fits`): 2 <= D <= 8 and the bin's working set,
:func:`smem_bytes`, within the 227 KB of shared memory a block may opt
into on the H100 (:func:`max_frames`: T <= 3750 at D=6, K=3; 3515 with
saliency). It replaces the JAX package's VMEM tile budget
(``pallas_cbmm_loop.choose_tile_f_cbmm``).

On a CPU tensor the wrapper runs the plain PyTorch twin,
:func:`cbmm_em_full_reference`. On a CUDA tensor it launches the kernel
or raises; it never falls back.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._dtypes import tiny as _tiny
from ._build import SMEM_LIMIT
from .bingham import FD_STEP, chord_round, grad_cascade, lam_of_u
from .linalg import eigh_jacobi

__all__ = ['cbmm_em_full', 'cbmm_em_full_reference',
           'cbmm_em_step_reference', 'smem_bytes', 'max_frames', 'fits',
           'solve_bounds']

GROUP_FLOATS = 384  # kGroupFloats of csrc/bingham.cuh


def smem_bytes(D, K, T, has_sal=False):
    """Shared memory one bin's CTA needs (csrc/cbmm_loop.cu); saliency adds
    T floats."""
    return 8 * (D * T + 3 * K * D * D) + 4 * (
        K * T + has_sal * T + 19 * K + K * GROUP_FLOATS)


def max_frames(D, K, has_sal=False):
    """Longest T the kernel takes at (D, K)."""
    fixed = 8 * 3 * K * D * D + 4 * (19 * K + K * GROUP_FLOATS)
    return (SMEM_LIMIT - fixed) // (8 * D + 4 * K + 4 * has_sal)


def fits(D, K, T, has_sal=False):
    """Does the whole-fit Bingham kernel take this shape?"""
    return 2 <= D <= 8 and smem_bytes(D, K, T, has_sal) <= SMEM_LIMIT


def solve_bounds(D, spacing_eps, max_concentration):
    """(lower, upper, cap_init) of the moment inversion: the diffs in
    [-min(mc, 32768 / (D - 1)), -spacing_eps] (the cascade's exact domain)
    and the cold start floored at -(min(mc, 32768) - j)."""
    mc = float(max_concentration)
    return (-min(mc, 32768.0 / (D - 1)), -float(spacing_eps),
            min(mc, 32768.0))


def _log_norm_constant(D):
    return math.log(2.0) + D * math.log(math.pi)


def cbmm_em_step_reference(y, affiliation, previous=None, *, sweeps=6,
                           warm_sweeps=2, spacing_eps=1e-3,
                           affiliation_eps=0., cold_rounds=3, cold_steps=10,
                           warm_steps=16, saliency=None,
                           max_concentration=math.inf):
    """One EM iteration of the kernel in plain PyTorch, batched over the
    bins: the M-step from ``affiliation``, the Jacobi, the sort, the
    moment inversion, log c and the E-step (clipped by
    ``affiliation_eps``).

    ``previous`` None is the kernel's first iteration: a cold Jacobi
    (``sweeps`` from the identity) and ``cold_rounds`` chord rounds of
    ``cold_steps`` from ``-1/s``. ``previous = (eigenvalues (..., K, D),
    eigenvectors (..., K, D, D))``, the state the kernel keeps between
    iterations, is a later one: the scatter rotated into the previous
    eigenbasis, ``V^H S V`` (Hermitian from its upper triangle), then
    ``warm_sweeps`` sweeps whose rotations are applied to ``V``, and one
    round of ``warm_steps`` from the previous eigenvalues. The columns
    are sorted stably by the moments floored at 0, as the kernel's swap
    network sorts them.

    Args: as :func:`cbmm_em_full`. Returns: as :func:`cbmm_em_full`.
    """
    from ..models._precision import full_fp32
    from ..models.mixture_model_utils import log_pdf_to_affiliation

    *lead, D, T = y.shape
    K = affiliation.shape[-2]
    N = math.prod(lead)
    y = y.reshape(N, D, T)
    a = affiliation.reshape(N, K, T).to(torch.float32)
    if saliency is not None:
        a = a * torch.broadcast_to(saliency, (*lead, T)).reshape(N, 1, T)
    lower, upper, cap_init = solve_bounds(D, spacing_eps, max_concentration)

    def space(nodes):
        steps = torch.clamp(torch.diff(nodes, dim=-1), min=spacing_eps)
        return torch.cat([nodes[..., :1], nodes[..., :1]
                          + torch.cumsum(steps, -1)], -1)

    asum = a.sum(-1)  # (N, K)
    if saliency is None:
        weight = asum / T
    else:
        norm = asum.sum(-1, keepdim=True)
        weight = asum / torch.where(norm == 0,
                                    torch.full_like(norm, 1e-10), norm)
    with full_fp32():
        scatter = (y[:, None] * a[:, :, None, :].to(y.dtype)) \
            @ y[:, None].conj().transpose(-1, -2)
    scatter = scatter / torch.clamp(
        asum, min=_tiny(asum))[..., None, None].to(scatter.dtype)
    if previous is None:
        moments, vectors = eigh_jacobi(scatter, sweeps=sweeps, sort=False)
    else:
        vectors = previous[1].reshape(N, K, D, D)
        with full_fp32():
            rotated = vectors.conj().transpose(-1, -2) @ scatter @ vectors
        strict = torch.triu(rotated, 1)
        rotated = strict + strict.conj().transpose(-1, -2) \
            + torch.diag_embed(torch.diagonal(
                rotated, dim1=-2, dim2=-1).real.to(rotated.dtype))
        moments, rotation = eigh_jacobi(rotated, sweeps=warm_sweeps,
                                        sort=False)
        with full_fp32():
            vectors = vectors @ rotation
    moments, order = torch.sort(torch.clamp(moments, min=0.0), dim=-1,
                                stable=True)
    vectors = torch.gather(vectors, -1,
                           order[..., None, :].expand_as(vectors))
    s = space(moments).reshape(N * K, D)
    if previous is None:
        x0 = -1.0 / torch.clamp(s, min=1e-12)
        x0 = torch.cat([x0[:, :-1], torch.zeros_like(x0[:, :1])], -1)
        x0 = torch.maximum(x0, -(cap_init - torch.arange(
            D, dtype=s.dtype, device=s.device)))
        rounds, steps = cold_rounds, cold_steps
    else:
        x0 = previous[0].reshape(N * K, D).to(torch.float32)
        rounds, steps = 1, warm_steps
    u = torch.clamp(torch.clamp(x0[:, :-1] - x0[:, 1:], min=lower),
                    max=upper)
    for _ in range(rounds):
        u = chord_round(s, u, iterations=steps, lower=lower, upper=upper,
                        fd_step=FD_STEP)
    lam = lam_of_u(u)
    if np.isfinite(float(max_concentration)):
        lam = space(torch.clamp(lam, min=-float(max_concentration)))
    _, dd = grad_cascade(lam)
    log_c = (_log_norm_constant(D) + torch.log(dd)).reshape(N, K)
    lam = lam.reshape(N, K, D)
    with full_fp32():
        forms = (vectors * lam[..., None, :].to(vectors.dtype)) \
            @ vectors.conj().transpose(-1, -2)
        quad = torch.einsum('ndt,nkdt->nkt', y.conj(), torch.einsum(
            'nkde,net->nkdt', forms, y)).real
    posterior = log_pdf_to_affiliation(
        weight[..., None], quad - log_c[..., None],
        affiliation_eps=affiliation_eps)
    return (weight.reshape(*lead, K), lam.reshape(*lead, K, D),
            vectors.reshape(*lead, K, D, D), log_c.reshape(*lead, K),
            posterior.reshape(*lead, K, T))


def cbmm_em_full_reference(y, affiliation, *, iterations,
                           affiliation_eps=0., **kwargs):
    """Plain PyTorch twin of the kernel: ``iterations`` of
    :func:`cbmm_em_step_reference`, each from the previous one's
    posterior and state, the last E-step unclipped.

    Args and returns: as :func:`cbmm_em_full`.
    """
    state = None
    for it in range(iterations):
        out = cbmm_em_step_reference(
            y, affiliation, state, affiliation_eps=0.
            if it == iterations - 1 else affiliation_eps, **kwargs)
        affiliation, state = out[4], out[1:3]
    return out


def cbmm_em_full(y, affiliation, *, iterations, sweeps=6, warm_sweeps=2,
                 spacing_eps=1e-3, affiliation_eps=0., cold_rounds=3,
                 cold_steps=10, warm_steps=16, saliency=None,
                 max_concentration=math.inf):
    """Run a full complex Bingham mixture EM fit as ONE kernel launch.

    ``iterations`` M-steps from the given affiliations with an E-step
    after each; the last E-step is unclipped, ``CBMM.predict`` on the
    returned model.

    Args:
        y: (F, D, T) or (B, F, D, T) complex64 unit-norm, time-last
            observations (a leading batch folds into the bin axis).
        affiliation: (..., F, K, T) initial posteriors.
        spacing_eps: minimum spacing of the moments and of the bounded
            eigenvalues, and the upper bound -spacing_eps of the diffs.
        affiliation_eps: clip of the posteriors of every E-step but the
            last.
        cold_rounds / cold_steps / warm_steps: the solve's chord rounds.
        saliency: optional (..., F, T) frame weights of the statistics;
            the mixture weight is then L1-normalized over classes.
        max_concentration: a finite value bounds the diffs and floors the
            eigenvalues at -max_concentration (then spaced again).
    Returns:
        (weight (..., F, K), eigenvalues (..., F, K, D) ascending with the
        maximum pinned to 0, eigenvectors (..., F, K, D, D) complex64,
        log normalizer (..., F, K), affiliation (..., F, K, T)).
    """
    if iterations < 1:
        raise ValueError(f'iterations must be >= 1, got {iterations}')
    kwargs = dict(iterations=iterations, sweeps=sweeps,
                  warm_sweeps=warm_sweeps, spacing_eps=spacing_eps,
                  affiliation_eps=affiliation_eps, cold_rounds=cold_rounds,
                  cold_steps=cold_steps, warm_steps=warm_steps,
                  saliency=saliency, max_concentration=max_concentration)
    if y.device.type == 'cpu':
        return cbmm_em_full_reference(y, affiliation, **kwargs)
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
            f'(D={D}, K={K}, T={T}) is outside the whole-fit Bingham kernel '
            f'gate (2 <= D <= 8, T <= {max_frames(D, K, has_sal)})')
    N = math.prod(lead)
    y_ = y.resolve_conj().reshape(N, D, T).contiguous()
    a_ = affiliation.reshape(N, K, T).to(torch.float32).contiguous()
    sal_ = None
    if has_sal:
        sal_ = torch.broadcast_to(
            torch.as_tensor(saliency, device=y.device), (*lead, T)
        ).reshape(N, T).to(torch.float32).contiguous()
    lower, upper, cap_init = solve_bounds(D, spacing_eps, max_concentration)
    mc = float(max_concentration)
    weight = torch.empty((N, K), dtype=torch.float32, device=y.device)
    lam = torch.empty((N, K, D), dtype=torch.float32, device=y.device)
    vec = torch.empty((N, K, D, D), dtype=torch.complex64, device=y.device)
    log_c = torch.empty((N, K), dtype=torch.float32, device=y.device)
    aff = torch.empty((N, K, T), dtype=torch.float32, device=y.device)
    if N:
        from ._build import load
        err = load('cbmm_loop').cbmm_em_full_launch(
            y_.data_ptr(), a_.data_ptr(),
            0 if sal_ is None else sal_.data_ptr(), weight.data_ptr(),
            lam.data_ptr(), vec.data_ptr(), log_c.data_ptr(), aff.data_ptr(),
            N, D, K, T, int(iterations), int(sweeps), int(warm_sweeps),
            int(cold_rounds), int(cold_steps), int(warm_steps),
            float(spacing_eps), lower, upper, FD_STEP,
            float(affiliation_eps), cap_init,
            mc if np.isfinite(mc) else -1.0, _log_norm_constant(D),
            torch.cuda.current_stream(y.device).cuda_stream)
        if err:
            raise RuntimeError(
                f'cbmm_em_full kernel launch failed: CUDA error {err}')
        cbmm_em_full.launches += 1
    return (weight.reshape(*lead, K), lam.reshape(*lead, K, D),
            vec.reshape(*lead, K, D, D), log_c.reshape(*lead, K),
            aff.reshape(*lead, K, T))


cbmm_em_full.launches = 0
