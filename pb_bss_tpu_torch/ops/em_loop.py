"""Whole-fit cACGMM EM in one CUDA launch (kernel ``csrc/em_loop.cu``).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_em_loop.py:cacgmm_em_full``. One CTA owns one
(utterance, frequency bin) and runs every EM iteration with the bin's
observations resident in shared memory: Hermitian M-step scatter
(lanes over entries, warps over frames, register sums), the parallel
complex Jacobi with a lane per column (cold ``sweeps`` in iteration 0,
then ``warm_sweeps`` from the previous eigenbasis), eigenvalue
max-normalization and floor, the E-step with the quadratic form as the
projection on the scaled eigenbasis and the max-shift softmax, with
saliency weighting the statistics and the source-activity mask gating
the E-step numerators. The final E-step is unclipped, so the returned
affiliation equals ``predict`` on the returned model. The kernel is
instantiated for every D in 1..16 (:data:`DIMS`); the CTA's warps
follow T (:func:`_threads`).

What bounds it on the H100: the observations are read from device
memory once per fit, so the kernel is bound by its instructions (the
E-step's projections, the scatter's pair products, the Jacobi's serial
chain), not by bytes; the design keeps the whole working set of a bin
in shared memory and registers to get there.

Gate (:func:`fits`): D <= 16 and the bin's working set,
:func:`smem_bytes`, within the 227 KB of shared memory a block may opt
into on the H100 — T <= 3178 frames at D=6, K=3 (:func:`max_frames`),
2600 with saliency and a source-activity mask. That is the first design's
budget, which held both extras in shared memory; the kernel reads them
from device memory and needs less (:func:`kernel_smem_bytes`), so the
gate admits exactly the shapes it admitted before. It replaces the JAX
package's VMEM tile budget (``pallas_em_loop.choose_tile_f``), which
stops near 600 frames and counts the same two extras.

On a CPU tensor the wrapper runs the plain PyTorch twin,
:func:`cacgmm_em_full_reference`. On a CUDA tensor it launches the
kernel or raises; it never falls back.
"""
from __future__ import annotations

import torch

from ._build import SMEM_LIMIT
from .linalg import sort_ascending

__all__ = ['cacgmm_em_full', 'cacgmm_em_full_reference', 'smem_bytes',
           'kernel_smem_bytes', 'max_frames', 'fits', 'DIMS']

DIMS = tuple(range(1, 17))  # the D the kernel is instantiated for
_MAX_WARPS = 8  # kMaxThreads / 32 in csrc/em_loop.cu
_SM_SMEM = 233472  # shared memory of an H100 SM; 1 KB of it per CTA is kept
_SM_WARPS = 32  # warps an SM should hold: half its 64


def smem_bytes(D, K, T, has_sal=False, has_mask=False):
    """The gate's shared-memory budget of one bin: the first design's
    working set (saliency adds T floats, the source-activity mask K T).
    The kernel needs less (:func:`kernel_smem_bytes`)."""
    return 8 * (D * T + 4 * K * D * D) + 4 * (
        2 * K * T + K * D + 3 * K + has_sal * T + has_mask * K * T)


def max_frames(D, K, has_sal=False, has_mask=False):
    """Longest T the kernel takes at (D, K) with the given extras."""
    return (SMEM_LIMIT - 8 * 4 * K * D * D - 4 * (K * D + 3 * K)) \
        // (8 * D + 8 * K + 4 * has_sal + 4 * K * has_mask)


def kernel_smem_bytes(D, K, T):
    """Shared memory one bin's CTA takes (em_smem_bytes in
    csrc/em_loop.cu): y with an odd row stride, the posterior times
    saliency and the scatter weights, the scatter, eigenvectors and
    scaled eigenbasis, and the per-class scalars."""
    Tp = T if D == 1 else T | 1
    return 8 * (D * Tp + 3 * K * D * D) + 4 * (2 * K * T + K * D + 4 * K)


def _threads(D, K, T):
    """Threads of one bin's CTA. The shared memory of a bin fixes how many
    CTAs an SM holds; the CTA takes enough warps that those CTAs together
    hold about 32 warps (at most eight a CTA), as few as spread the
    frames over the same rounds of a thread per frame (at most one
    partial warp a round), and at least the warps that run the K
    Jacobis at once (floor(32 / D) classes to a warp)."""
    ctas = max(1, min(32, _SM_SMEM // (kernel_smem_bytes(D, K, T) + 1024)))
    warps = min(_MAX_WARPS, -(-_SM_WARPS // ctas))
    rounds = -(-max(T, 1) // (32 * warps))
    warps = -(-max(T, 1) // (32 * rounds))
    jacobi = -(-K // (32 // D))
    return 32 * min(_MAX_WARPS, max(warps, jacobi))


def fits(D, K, T, has_sal=False, has_mask=False):
    """Does the whole-fit kernel take this shape (with saliency
    ``has_sal`` and a source-activity mask ``has_mask``)?"""
    return D <= 16 and smem_bytes(D, K, T, has_sal, has_mask) <= SMEM_LIMIT


def cacgmm_em_full_reference(y, affiliation, quadratic_form, *,
                             iterations, sweeps=6, eigenvalue_floor=1e-10,
                             affiliation_eps=1e-10, saliency=None,
                             source_activity_mask=None):
    """Plain PyTorch twin of the kernel: the scan-path EM restated with
    one trailing unclipped E-step (the JAX package's
    ``cacgmm_em_full_reference``). It runs a cold Jacobi with
    ``sweeps`` every iteration; the kernel warm-starts later
    iterations, which converges to the same eigendecomposition.

    Args: as :func:`cacgmm_em_full`.
    """
    from ..models.cacgmm import _m_step

    model = None
    for i in range(iterations):
        model = _m_step(
            y, quadratic_form, affiliation, saliency,
            hermitize=True, covariance_norm='eigenvalue',
            eigenvalue_floor=eigenvalue_floor, weight_constant_axis=(-1,),
            eigh_sweeps=sweeps, eigh_method='jacobi')
        affiliation, quadratic_form, _ = model._predict(
            y, source_activity_mask=source_activity_mask,
            affiliation_eps=0. if i == iterations - 1 else affiliation_eps)
    return (model.weight[..., 0], model.cacg.covariance_eigenvalues,
            model.cacg.covariance_eigenvectors, affiliation)


def cacgmm_em_full(y, affiliation, quadratic_form, *, iterations,
                   sweeps=6, warm_sweeps=None, eigenvalue_floor=1e-10,
                   affiliation_eps=1e-10, saliency=None,
                   source_activity_mask=None):
    """Run a full cACGMM EM fit as ONE kernel launch.

    ``iterations`` M-steps starting from the given affiliations and
    quadratic forms, an E-step after each; the final E-step uses
    ``affiliation_eps=0``.

    Args:
        y: (F, D, T) or (B, F, D, T) complex64 unit-norm, time-last
            observations (a leading batch folds into the bin axis).
        affiliation: (..., F, K, T) initial posteriors.
        quadratic_form: (..., F, K, T) initial quadratic forms.
        warm_sweeps: Jacobi sweeps of the warm-started iterations
            (None: every iteration cold with ``sweeps``).
        saliency: optional (..., F, T) frame weights of the M-step
            statistics; the mixture weight is then L1-normalized over
            classes.
        source_activity_mask: optional (..., F, K, T) 0/1 (bool or
            float) gate of the E-step numerators.
    Returns:
        (weight (..., F, K), eigenvalues (..., F, K, D) ascending,
        eigenvectors (..., F, K, D, D) complex64, affiliation
        (..., F, K, T)).
    """
    if iterations < 1:
        raise ValueError(f'iterations must be >= 1, got {iterations}')
    if y.device.type == 'cpu':
        return cacgmm_em_full_reference(
            y, affiliation, quadratic_form, iterations=iterations,
            sweeps=sweeps, eigenvalue_floor=eigenvalue_floor,
            affiliation_eps=affiliation_eps, saliency=saliency,
            source_activity_mask=source_activity_mask)
    if y.device.type != 'cuda':
        raise ValueError(f'unsupported device {y.device}')
    if y.dtype != torch.complex64 or y.ndim not in (3, 4):
        raise ValueError(
            f'y must be complex64 (F, D, T) or (B, F, D, T), got '
            f'{y.dtype} {tuple(y.shape)}')
    *lead, D, T = y.shape
    K = affiliation.shape[-2]
    for name, x in (('affiliation', affiliation),
                    ('quadratic_form', quadratic_form)):
        if tuple(x.shape) != (*lead, K, T) or x.device != y.device:
            raise ValueError(
                f'{name} must be {(*lead, K, T)} on {y.device}, got '
                f'{tuple(x.shape)} on {x.device}')
    has_sal = saliency is not None
    has_mask = source_activity_mask is not None
    if not fits(D, K, T, has_sal, has_mask):
        raise ValueError(
            f'(D={D}, K={K}, T={T}) is outside the whole-fit kernel gate '
            f'(D <= 16, T <= {max_frames(D, K, has_sal, has_mask)})')
    N = 1
    for n in lead:
        N *= n

    def fold(x, *trailing):
        if x is None:
            return None
        x = torch.broadcast_to(torch.as_tensor(x, device=y.device),
                               (*lead, *trailing))
        return x.reshape(N, *trailing).to(torch.float32).contiguous()

    y_ = y.resolve_conj().reshape(N, D, T).contiguous()
    a_ = fold(affiliation, K, T)
    q_ = fold(quadratic_form, K, T)
    sal_ = fold(saliency, T)
    mask_ = fold(source_activity_mask, K, T)
    weight = torch.empty((N, K), dtype=torch.float32, device=y.device)
    eig = torch.empty((N, K, D), dtype=torch.float32, device=y.device)
    vec = torch.empty((N, K, D, D), dtype=torch.complex64, device=y.device)
    aff = torch.empty((N, K, T), dtype=torch.float32, device=y.device)
    if N:
        from ._build import load
        err = load('em_loop').cacgmm_em_full_launch(
            y_.data_ptr(), a_.data_ptr(), q_.data_ptr(),
            0 if sal_ is None else sal_.data_ptr(),
            0 if mask_ is None else mask_.data_ptr(), weight.data_ptr(),
            eig.data_ptr(), vec.data_ptr(), aff.data_ptr(), N, D, K, T,
            _threads(D, K, T), int(iterations), int(sweeps),
            -1 if warm_sweeps is None else int(warm_sweeps),
            float(eigenvalue_floor), float(affiliation_eps),
            torch.cuda.current_stream(y.device).cuda_stream)
        if err:
            raise RuntimeError(
                f'cacgmm_em_full kernel launch failed: CUDA error {err}')
        cacgmm_em_full.launches += 1
    eig, vec = sort_ascending(eig, vec)
    return (weight.reshape(*lead, K), eig.reshape(*lead, K, D),
            vec.reshape(*lead, K, D, D), aff.reshape(*lead, K, T))


cacgmm_em_full.launches = 0
