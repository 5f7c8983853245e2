"""cACGMM EM with frequency-constant mixture weights, one CUDA launch per
EM iteration (kernels ``csrc/em_step.cu``, on the whole-fit kernel's
iteration body ``csrc/em_iter.cuh``: the register scatter, the column
Jacobi and the E-step, templated on D in 1..16).

Replaces the JAX package's Pallas TPU kernels
``pb_bss_tpu/ops/pallas_em_step.py:cacgmm_em_fc`` (``_m_init_kernel``
and ``_em_step_kernel``). With ``weight_constant_axis=(-3, -1)`` each
M-step reduces the affiliation sums over every bin of an utterance, so
the fit cannot stay inside one launch as the whole-fit kernel's does.
It is split at that one reduction:

* :func:`m_init` (one launch): the first M-step from the initial
  affiliations, cold in-kernel Jacobi; one CTA per (utterance, bin).
* :func:`em_step` (one launch per further iteration): E-step with the
  utterance's weight, M-step scatter and the Jacobi warm-started from
  the previous eigenbasis, per (utterance, bin). With the inline aligner
  it also writes the E-step posterior.
* between launches, in PyTorch: the (B, K) weight from the per-bin
  affiliation sums, and the inline permutation aligner, whose mapping
  permutes the per-class state (eigenvectors, eigenvalues, sums) with
  ``torch.gather`` before the weight is taken. That is the scan path's
  align-then-M exactly: the M-statistics are linear per class and the
  eigendecomposition commutes with relabeling.

A fit of ``iterations`` M-steps launches :func:`m_init` once and
:func:`em_step` ``iterations - 1`` times (``iterations`` times when it
resumes from a model).

What bounds it on the H100: each launch reads y once (59 MB at B=8,
F=513, D=6, T=300), ~1 GFLOP of work, so by the card's peaks a step is
bound by the operations. Gate (:func:`fits`): D <= 16 and the bin's
working set, :func:`smem_bytes`, within the 227 KB of shared memory a
block may opt into: T <= 3190 at D=6, K=3 (:func:`max_frames`). The
kernels take :func:`kernel_smem_bytes`: y's rows at an odd stride where
that still fits (:func:`row_stride`), the gate's formula where not. The
CTA's warps follow the bin's shared memory and T (:func:`_threads`, the
whole-fit kernel's chooser). Past the gate, fits without an aligner take
the streamed kernel's ``'fc'`` mode and fits with one the scan path.

On a CPU tensor the wrappers run their plain PyTorch twins
(:func:`m_init_reference`, :func:`em_step_reference`). On a CUDA tensor
they launch the kernels or raise; they never fall back.
:func:`cacgmm_em_fc_reference` is the whole fit with the twins, on any
device.
"""
from __future__ import annotations

import torch

from .._dtypes import tiny as _tiny
from .._shard import (
    frequency_bins,
    frequency_gather,
    frequency_rows,
    frequency_sum,
)
from ._build import SMEM_LIMIT, counted, launch
from .em_loop import cta_threads
from .linalg import eigh_jacobi, sort_ascending

__all__ = ['cacgmm_em_fc', 'cacgmm_em_fc_reference', 'm_init',
           'm_init_reference', 'em_step', 'em_step_reference', 'smem_bytes',
           'kernel_smem_bytes', 'row_stride', 'max_frames', 'fits']


def smem_bytes(D, K, T):
    """The gate's shared memory of one bin: y, the covariance, the
    eigenvectors and the scaled eigenbasis, the posterior and the weights,
    the eigenvalues and 3 K scalars (:func:`kernel_smem_bytes` at
    ``Tp = T``)."""
    return 8 * (D * T + 3 * K * D * D) + 4 * (2 * K * T + K * D + 3 * K)


def kernel_smem_bytes(D, K, T, Tp):
    """Shared memory one bin's CTA takes (fc_smem_bytes in
    csrc/em_step.cu, both kernels) with y's rows at stride ``Tp``."""
    return smem_bytes(D, K, T) + 8 * D * (Tp - T)


def row_stride(D, K, T):
    """The stride of y's rows in shared memory: T rounded up to odd (the
    channels of a frame in distinct banks) where the bin's working set
    still fits, else T."""
    Tp = T if D == 1 else T | 1
    return Tp if kernel_smem_bytes(D, K, T, Tp) <= SMEM_LIMIT else T


def _threads(D, K, T):
    """Threads of one bin's CTA: the whole-fit kernel's choice from the
    bin's shared memory and T (ops/em_loop.cta_threads)."""
    return cta_threads(kernel_smem_bytes(D, K, T, row_stride(D, K, T)), D,
                       K, T)


def max_frames(D, K):
    """Longest T the kernels take at (D, K)."""
    return (SMEM_LIMIT - 8 * 3 * K * D * D - 4 * (K * D + 3 * K)) \
        // (8 * D + 8 * K)


def fits(D, K, T):
    """Do the frequency-constant EM kernels take this shape? Saliency,
    the source-activity mask and the emitted posterior live in device
    memory, so they do not change the budget."""
    return D <= 16 and smem_bytes(D, K, T) <= SMEM_LIMIT


def _floor(eigenvalues, eigenvalue_floor):
    """Max-normalization and floor of the Jacobi diagonal."""
    lam_max = torch.clamp(eigenvalues.max(-1, keepdim=True).values,
                          min=_tiny(eigenvalues))
    return torch.clamp(eigenvalues / lam_max, min=eigenvalue_floor)


def _m_stats(y, aff, qf):
    """Affiliation sums and the covariance D sum_t (a / max(q, 10 tiny))
    y y^H / max(sum_t a, tiny), Hermitian, per (bin, class)."""
    from ..models._precision import full_fp32
    D = y.shape[-2]
    asum = aff.sum(-1)
    w = aff / torch.clamp(qf, min=10 * _tiny(qf))
    yw = y[:, None] * w[:, :, None, :].to(y.dtype)  # (N, K, D, T)
    with full_fp32():
        scatter = yw @ y[:, None].conj().transpose(-1, -2)
    covariance = D * scatter / torch.clamp(
        asum, min=_tiny(asum))[..., None, None].to(scatter.dtype)
    covariance = (covariance + covariance.conj().transpose(-1, -2)) / 2
    return covariance, asum


def m_init_reference(y, affiliation, quadratic_form, *, sweeps,
                     eigenvalue_floor, saliency=None):
    """Plain PyTorch twin of :func:`m_init`.

    Args: as :func:`m_init`.
    """
    aff = affiliation if saliency is None else affiliation * saliency[:, None]
    covariance, asum = _m_stats(y, aff, quadratic_form)
    eigenvalues, eigenvectors = eigh_jacobi(covariance, sweeps=sweeps,
                                            sort=False)
    return eigenvectors, _floor(eigenvalues, eigenvalue_floor), asum


@counted
def m_init(y, affiliation, quadratic_form, *, sweeps, eigenvalue_floor,
           saliency=None):
    """The first M-step of a frequency-constant fit, one launch.

    Args:
        y: (N, D, T) complex64 unit-norm, time-last observations (N =
            B F bins).
        affiliation / quadratic_form: (N, K, T) initial posteriors and
            quadratic forms.
        sweeps: cold Jacobi sweeps.
        saliency: optional (N, T) frame weights.
    Returns:
        (eigenvectors (N, K, D, D) complex64 in columns, eigenvalues
        (N, K, D) normalized and floored, unsorted, affiliation sums
        (N, K), saliency-weighted).
    """
    if y.device.type == 'cpu':
        return m_init_reference(
            y, affiliation, quadratic_form, sweeps=sweeps,
            eigenvalue_floor=eigenvalue_floor, saliency=saliency)
    N, D, T, K = _check(y, affiliation.shape[-2])
    operands = [_operand(y, affiliation, (N, K, T), torch.float32),
                _operand(y, quadratic_form, (N, K, T), torch.float32),
                _operand(y, saliency, (N, T), torch.float32)]
    y_ = y.resolve_conj().contiguous()
    vec, eig, asum = _state(y, N, K, D)
    if N:
        launch(m_init, 'em_step', 'em_fc_init_launch', y_.data_ptr(),
               *[0 if x is None else x.data_ptr() for x in operands],
               vec.data_ptr(), eig.data_ptr(), asum.data_ptr(), N, D, K, T,
               row_stride(D, K, T), _threads(D, K, T), int(sweeps),
               float(eigenvalue_floor),
               torch.cuda.current_stream(y.device).cuda_stream)
    return vec, eig, asum


def em_step_reference(y, eigenvalues, eigenvectors, weight, *,
                      warm_sweeps, eigenvalue_floor, affiliation_eps,
                      saliency=None, source_activity_mask=None,
                      emit_affiliation=False):
    """Plain PyTorch twin of :func:`em_step`: the scan path's E-step
    (projection ``V^H y``), its M-step, and the Jacobi warm-started
    from the previous eigenbasis (``V^H S V`` diagonalized by
    ``warm_sweeps`` sweeps, the rotations applied to ``V``).

    Args: as :func:`em_step`.
    """
    from ..models._precision import full_fp32
    from ..models.mixture_model_utils import log_pdf_to_affiliation

    N, D, T = y.shape
    B, K = weight.shape
    with full_fp32():
        z = torch.einsum('nkde,ndt->nket', eigenvectors.conj(), y)
        qf = torch.einsum('nket,nke->nkt', z.real ** 2 + z.imag ** 2,
                          1. / eigenvalues)
    qf = torch.clamp(qf, min=_tiny(y))
    log_pdf = -D * torch.log(qf) - torch.log(eigenvalues).sum(-1)[..., None]
    per_bin = weight[:, None, :].expand(B, N // B, K).reshape(N, K)
    aff = log_pdf_to_affiliation(
        per_bin[..., None], log_pdf,
        source_activity_mask=source_activity_mask,
        affiliation_eps=affiliation_eps)
    emitted = aff if emit_affiliation else None
    if saliency is not None:
        aff = aff * saliency[:, None]
    covariance, asum = _m_stats(y, aff, qf)
    with full_fp32():
        rotated = eigenvectors.conj().transpose(-1, -2) @ covariance \
            @ eigenvectors
    rotated = (rotated + rotated.conj().transpose(-1, -2)) / 2
    eig, rotation = eigh_jacobi(rotated, sweeps=warm_sweeps, sort=False)
    with full_fp32():
        eigenvectors = eigenvectors @ rotation
    return eigenvectors, _floor(eig, eigenvalue_floor), asum, emitted


@counted
def em_step(y, eigenvalues, eigenvectors, weight, *, warm_sweeps,
            eigenvalue_floor, affiliation_eps, saliency=None,
            source_activity_mask=None, emit_affiliation=False):
    """One EM iteration of a frequency-constant fit, one launch.

    Args:
        y: (N, D, T) complex64 unit-norm, time-last observations, N = B F.
        eigenvalues: (N, K, D) normalized and floored; eigenvectors
            (N, K, D, D) complex64 in columns: the previous state.
        weight: (B, K) mixture weight of each utterance.
        warm_sweeps: Jacobi sweeps after the warm rotation.
        saliency: optional (N, T); source_activity_mask: optional
            (N, K, T) 0/1 floats.
        emit_affiliation: also return the E-step posterior (clipped,
            before saliency), for the inline aligner.
    Returns:
        (eigenvectors, eigenvalues (unsorted), affiliation sums (N, K),
        posterior (N, K, T) or None).
    """
    if y.device.type == 'cpu':
        return em_step_reference(
            y, eigenvalues, eigenvectors, weight, warm_sweeps=warm_sweeps,
            eigenvalue_floor=eigenvalue_floor,
            affiliation_eps=affiliation_eps, saliency=saliency,
            source_activity_mask=source_activity_mask,
            emit_affiliation=emit_affiliation)
    N, D, T, K = _check(y, eigenvalues.shape[-2])
    B = weight.shape[0]
    if N % max(B, 1):
        raise ValueError(f'{N} bins do not split into {B} utterances')
    operands = [
        _operand(y, eigenvectors, (N, K, D, D), torch.complex64),
        _operand(y, eigenvalues, (N, K, D), torch.float32),
        _operand(y, weight, (B, K), torch.float32),
        _operand(y, saliency, (N, T), torch.float32),
        _operand(y, source_activity_mask, (N, K, T), torch.float32)]
    y_ = y.resolve_conj().contiguous()
    vec, eig, asum = _state(y, N, K, D)
    emitted = (torch.empty((N, K, T), dtype=torch.float32, device=y.device)
               if emit_affiliation else None)
    if N:
        launch(em_step, 'em_step', 'em_fc_step_launch', y_.data_ptr(),
               *[0 if x is None else x.data_ptr() for x in operands],
               vec.data_ptr(), eig.data_ptr(), asum.data_ptr(),
               0 if emitted is None else emitted.data_ptr(), N, N // B, D,
               K, T, row_stride(D, K, T), _threads(D, K, T),
               int(warm_sweeps), float(eigenvalue_floor),
               float(affiliation_eps),
               torch.cuda.current_stream(y.device).cuda_stream)
    return vec, eig, asum, emitted


def _check(y, K):
    if y.device.type != 'cuda':
        raise ValueError(f'unsupported device {y.device}')
    if y.dtype != torch.complex64 or y.ndim != 3:
        raise ValueError(
            f'y must be complex64 (N, D, T), got {y.dtype} {tuple(y.shape)}')
    N, D, T = y.shape
    if not fits(D, K, T):
        raise ValueError(
            f'(D={D}, K={K}, T={T}) is outside the frequency-constant EM '
            f'kernels\' gate (D <= 16, T <= {max_frames(D, K)})')
    return N, D, T, K


def _operand(y, x, shape, dtype):
    if x is None:
        return None
    if tuple(x.shape) != shape or x.device != y.device:
        raise ValueError(f'expected {shape} on {y.device}, got '
                         f'{tuple(x.shape)} on {x.device}')
    return x.resolve_conj().to(dtype).contiguous()


def _state(y, N, K, D):
    return (torch.empty((N, K, D, D), dtype=torch.complex64, device=y.device),
            torch.empty((N, K, D), dtype=torch.float32, device=y.device),
            torch.empty((N, K), dtype=torch.float32, device=y.device))


def _em_fc(init_pass, step_pass, y, affiliation, quadratic_form, *,
           iterations, sweeps=6, warm_sweeps=2, eigenvalue_floor=1e-10,
           affiliation_eps=1e-10, saliency=None, source_activity_mask=None,
           first_e_step=False, init_weight=None, init_eigenvalues=None,
           init_eigenvectors=None, aligner=None):
    """The EM loop of :func:`cacgmm_em_fc` with given init and step
    passes."""
    if y.ndim not in (3, 4):
        raise ValueError(
            f'y must be (F, D, T) or (B, F, D, T), got {tuple(y.shape)}')
    batched = y.ndim == 4
    assert aligner is None or not batched, (
        'the inline permutation aligner needs the real frequency axis — '
        'fold the batch yourself or use per-utterance calls')
    *lead, D, T = y.shape
    B = lead[0] if batched else 1
    F = lead[-1]
    N = B * F
    K = (affiliation.shape[-2] if affiliation is not None
         else init_eigenvalues.shape[-2])
    rdtype = torch.float32

    def fold(x, *trailing):
        if x is None:
            return None
        return torch.broadcast_to(x, (*lead, *trailing)).reshape(
            N, *trailing)

    y_f = fold(y, D, T)
    sal = fold(saliency, T)
    sam = fold(source_activity_mask, K, T)

    def weight_from_asum(asum):
        """The per-utterance weight (B, K) from the per-bin sums: the
        one reduction over bins (over every bin of a sharded fit)."""
        sums = frequency_sum(asum.reshape(B, F, K).sum(1))
        if sal is not None:
            denom = sums.sum(-1, keepdim=True)
            denom = torch.where(denom == 0, torch.full_like(denom, 1e-10),
                                denom)
            return sums / denom
        return sums / (frequency_bins(F) * T)

    def align(vec, eig, asum, posterior):
        """Permute the per-class state with the aligner's mapping of
        the emitted posterior: aligned[f, k] = x[f, mapping[k, f]]."""
        # the aligner walks every bin (gathered in a sharded fit)
        mapping = frequency_rows(aligner.calculate_mapping(
            frequency_gather(posterior.transpose(0, 1), 1)), 1)
        index = mapping.transpose(0, 1).to(torch.long)  # (F, K)
        return (torch.gather(vec, 1, index[..., None, None].expand(
                    vec.shape)),
                torch.gather(eig, 1, index[..., None].expand(eig.shape)),
                torch.gather(asum, 1, index))

    if not first_e_step:
        vec, eig, asum = init_pass(
            y_f, fold(affiliation, K, T), fold(quadratic_form, K, T),
            sweeps=sweeps, eigenvalue_floor=eigenvalue_floor, saliency=sal)
        weight = weight_from_asum(asum)
        n_steps = iterations - 1
    else:
        eig = fold(init_eigenvalues, K, D).to(rdtype)
        vec = fold(init_eigenvectors, K, D, D).to(torch.complex64)
        # a (1, K) weight broadcasts over the batch
        weight = torch.broadcast_to(init_weight.to(rdtype), (B, K))
        n_steps = iterations
    for _ in range(n_steps):
        vec, eig, asum, posterior = step_pass(
            y_f, eig, vec, weight, warm_sweeps=warm_sweeps,
            eigenvalue_floor=eigenvalue_floor,
            affiliation_eps=affiliation_eps, saliency=sal,
            source_activity_mask=sam,
            emit_affiliation=aligner is not None)
        if aligner is not None:
            vec, eig, asum = align(vec, eig, asum, posterior)
        weight = weight_from_asum(asum)

    eig, vec = sort_ascending(eig, vec)
    return ((weight if batched else weight[0]), eig.reshape(*lead, K, D),
            vec.reshape(*lead, K, D, D))


def cacgmm_em_fc(y, affiliation, quadratic_form, *, iterations, sweeps=6,
                 warm_sweeps=2, eigenvalue_floor=1e-10,
                 affiliation_eps=1e-10, saliency=None,
                 source_activity_mask=None, first_e_step=False,
                 init_weight=None, init_eigenvalues=None,
                 init_eigenvectors=None, aligner=None):
    """cACGMM EM with frequency-constant mixture weights
    (``weight_constant_axis=(-3, -1)``): :func:`m_init`, then one
    :func:`em_step` launch per iteration.

    Args:
        y: (F, D, T) or (B, F, D, T) complex64 unit-norm, time-last
            observations (a leading batch folds into the bin axis; the
            weight stays per utterance).
        affiliation / quadratic_form: (..., F, K, T) initial state
            (ignored with ``first_e_step``).
        iterations: M-steps.
        sweeps: cold Jacobi sweeps of the first M-step; warm_sweeps: the
            sweeps of every later one, from the previous eigenbasis.
        saliency: optional (..., F, T) frame weights (the weight is then
            the L1-normalized saliency-weighted sum).
        source_activity_mask: optional (..., F, K, T) 0/1 gate.
        first_e_step: start from the model in ``init_weight`` ((K,),
            or (B, K) / (1, K) for batched input), ``init_eigenvalues``
            ((..., F, K, D), normalized and floored) and
            ``init_eigenvectors`` ((..., F, K, D, D)) with an E-step.
        aligner: an inline permutation aligner (unbatched input only),
            run on each E-step's posterior between launches.
    Returns:
        (weight (..., K), eigenvalues (..., F, K, D), eigenvectors
        (..., F, K, D, D) complex64), eigenpairs sorted ascending.
    """
    return _em_fc(
        m_init, em_step, y, affiliation, quadratic_form,
        iterations=iterations, sweeps=sweeps, warm_sweeps=warm_sweeps,
        eigenvalue_floor=eigenvalue_floor, affiliation_eps=affiliation_eps,
        saliency=saliency, source_activity_mask=source_activity_mask,
        first_e_step=first_e_step, init_weight=init_weight,
        init_eigenvalues=init_eigenvalues,
        init_eigenvectors=init_eigenvectors, aligner=aligner)


def cacgmm_em_fc_reference(y, affiliation, quadratic_form, **kwargs):
    """Plain PyTorch twin of :func:`cacgmm_em_fc`: the same loop with
    :func:`m_init_reference` and :func:`em_step_reference`, on any
    device."""
    return _em_fc(m_init_reference, em_step_reference, y, affiliation,
                  quadratic_form, **kwargs)
