"""The opt-in cACGMM E-step kernels (``csrc/em_estep.cu``).

Replaces the JAX package's Pallas TPU kernels
``pb_bss_tpu/ops/pallas_em.py``: :func:`cacgmm_e_step`
(``cacgmm_e_step``, the fused E-step) and :func:`cacgmm_em_scatter`
(``cacgmm_em_scatter``, the E-step folded into the M-step scatter, the
kernel behind ``CACGMMTrainer.fit(use_pallas_em=True)``). Both keep the
JAX package's real/imaginary plane interface.

The quadratic form is the projection on the scaled eigenbasis
``W = V diag(sqrt(1/l))`` (built once per segment),
``q = sum_i |(W^H y)_i|^2``, which equals the plain twins'
``sum_i |(V^H y)_i|^2 / l_i`` up to f32 rounding; the JAX kernels'
assembled inverse ``V diag(1/l) V^H`` cancels once an eigenvalue sits at
the floor. The E-step is unclipped, as the JAX kernels' is. Both kernels
walk the streamed passes' plan (:mod:`._plan`): the bins' frames laid end
to end in equal spans over whole waves of CTAs (:data:`THREADS` threads a
CTA, :data:`WAVES` waves). The scatter kernel is K4's pass
(``csrc/stream.cuh``: a cp.async ring of tiles, register sums, one
cross-warp reduction a segment) with K10's reduction: a bin split over
CTAs is summed by the last CTA on it in the same launch, so the call is
one launch and repeats bit for bit. It takes the inverse eigenvalues and
log-determinants as given, weights by ``a / q`` and returns ``D`` times
the sum as planes; its shared memory depends on D and K only
(:func:`scatter_fits`).

What bounds it on the H100: y is read once per call (3.7 MB at F=257,
T=304), so at the trainer's sizes the launches are short and their fixed
costs count: every CTA takes the same share of frames and sets a
segment's model up once.

Both kernels read y and the eigenvectors as complex64. The public
wrappers take the JAX package's planes and join them once a call; the
trainer's ``use_pallas_em`` route calls :func:`em_scatter_model` with the
model's complex tensors as they are (no plane copies an iteration).

On a CPU tensor the wrappers run their plain PyTorch twins
(:func:`cacgmm_e_step_reference`, :func:`cacgmm_em_scatter_reference`).
On a CUDA tensor they launch the kernels or raise; they never fall
back.
"""
from __future__ import annotations

import functools

import torch

from .._dtypes import tiny as _tiny
from . import _plan
from ._build import SMEM_LIMIT, counted, launch

__all__ = ['cacgmm_e_step', 'cacgmm_e_step_reference', 'cacgmm_em_scatter',
           'cacgmm_em_scatter_reference', 'em_scatter_model', 'scatter_fits',
           'smem_bytes', 'plan', 'THREADS', 'WAVES']

# a CTA's threads, one a frame of a tile (kThreads in csrc/em_estep.cu),
# and the whole waves of the grid (ops/_plan.py): on an H100, two waves of
# 128 threads were the fastest of 128 or 256 threads in 1, 2 or 4 waves at
# the trainer's shape (F=257, T=304), and within the spread at a minute
# (F=513, T=3753; PERF.md §6)
THREADS = 128
WAVES = 2
_GROUP = 4  # classes summed in registers at once (kGroup)
_STAGES = 2  # tiles in the scatter's ring (kStages)
_KINDS = {'e_step': 0, 'scatter': 1}


def smem_bytes(kind, D, K, threads=THREADS):
    """Shared memory of one CTA of ``threads`` threads of kernel ``kind``
    ('e_step' or 'scatter'; e_step_smem_bytes and scatter_smem_bytes in
    csrc/em_estep.cu)."""
    model = 2 * K * D * D + 2 * K * threads + 2 * K
    if kind == 'e_step':
        return 4 * model
    sets = -(-(D * (D + 1) // 2) // 32)
    ring = max(_STAGES * D * (threads + 1) * 2,
               threads // 32 * _GROUP * sets * 64)
    return 4 * (ring + threads * _GROUP + threads // 32 * _GROUP + model + 1)


@functools.lru_cache(maxsize=None)
def scatter_fits(D, K):
    """Does the scatter kernel take (D, K)? (T does not matter: it walks
    the frames in tiles.)"""
    return 1 <= D <= 16 and smem_bytes('scatter', D, K) <= SMEM_LIMIT


def plan(N, T, capacity, threads=THREADS):
    """(ctas, span, slots) of one call over N bins of T frames on a card
    that holds ``capacity`` CTAs of ``threads`` threads at once:
    :func:`._plan.partition` in :data:`WAVES` waves, at least a tile of
    frames a CTA. The frames of bin n fall to CTAs floor(n T / span) ..
    floor(((n + 1) T - 1) / span); where they are more than one, the
    scatter writes a partial sum a slot (< slots)."""
    return _plan.partition(N, T, capacity, tile=threads, waves=WAVES)


def cacgmm_e_step_reference(y_re, y_im, v_re, v_im, inv_eigenvalues, logdet,
                            weight):
    """Plain PyTorch twin of :func:`cacgmm_e_step` (the JAX package's
    ``cacgmm_e_step_reference``): projection, quadratic form, max-shift
    softmax with the linear weights."""
    from ..models._precision import full_fp32
    y = torch.complex(y_re.float(), y_im.float())
    v = torch.complex(v_re.float(), v_im.float())
    with full_fp32():
        z = torch.einsum('fkde,fdt->fket', v.conj(), y)
        qf = torch.einsum('fket,fke->fkt', z.real ** 2 + z.imag ** 2,
                          inv_eigenvalues.float())
    qf = torch.clamp(qf, min=_tiny(qf))
    D = y_re.shape[-2]
    log_pdf = -D * torch.log(qf) - logdet.float()[..., None]
    shifted = torch.exp(log_pdf - log_pdf.max(1, keepdim=True).values)
    weighted = shifted * weight.float()[..., None]
    denominator = torch.clamp(weighted.sum(1, keepdim=True), min=_tiny(qf))
    return weighted / denominator, qf


def cacgmm_em_scatter_reference(y_re, y_im, v_re, v_im, inv_eigenvalues,
                                logdet, weight):
    """Plain PyTorch twin of :func:`cacgmm_em_scatter` (the JAX
    package's ``cacgmm_em_scatter_reference``)."""
    from ..models._precision import full_fp32
    affiliation, qf = cacgmm_e_step_reference(
        y_re, y_im, v_re, v_im, inv_eigenvalues, logdet, weight)
    y = torch.complex(y_re.float(), y_im.float())
    D = y_re.shape[-2]
    m = affiliation / qf
    ym = y[:, None] * m[:, :, None, :].to(y.dtype)  # (F, K, D, T)
    with full_fp32():
        scatter = D * (ym @ y[:, None].conj().transpose(-1, -2))
    return scatter.real, scatter.imag, affiliation.sum(-1)


def _operand(x, shape, dtype, device):
    if tuple(x.shape) != shape or x.device != device:
        raise ValueError(f'expected {shape} on {device}, got '
                         f'{tuple(x.shape)} on {x.device}')
    if x.dtype != dtype or x.is_conj() or not x.is_contiguous():
        x = x.resolve_conj().to(dtype).contiguous()
    return x


def _operands(y, v, inv_eigenvalues, logdet, weight):
    """Check the shapes and device of the complex y (F, D, T) and
    eigenvectors (F, K, D, D) and the rest; contiguous operands."""
    if y.device.type != 'cuda':
        raise ValueError(f'unsupported device {y.device}')
    if y.ndim != 3:
        raise ValueError(f'y must be (F, D, T), got {tuple(y.shape)}')
    F, D, T = y.shape
    K = v.shape[1]
    if not 1 <= D <= 16:
        raise ValueError(f'the E-step kernels take D <= 16, got {D}')
    operands = (
        _operand(y, (F, D, T), torch.complex64, y.device),
        _operand(v, (F, K, D, D), torch.complex64, y.device),
        _operand(inv_eigenvalues, (F, K, D), torch.float32, y.device),
        _operand(logdet, (F, K), torch.float32, y.device),
        _operand(weight, (F, K), torch.float32, y.device))
    return operands, F, D, K, T


def _complex(re, im):
    """The complex64 tensor of two real planes (the kernels' operand)."""
    return torch.complex(re.float(), im.float())


def _check(kind, D, K):
    """Raise unless kernel ``kind`` takes (D, K)."""
    if smem_bytes(kind, D, K) > SMEM_LIMIT:
        raise ValueError(
            f'(D={D}, K={K}) is outside the {kind} kernel\'s shared-memory '
            'budget')


@functools.lru_cache(maxsize=None)
def _grid(kind, device_index, F, D, K, T, waves):
    """(ctas, span, slots) of kernel ``kind`` over F bins of T frames: the
    card's capacity and the plan, once a shape (``waves`` is
    :data:`WAVES`, a key of the cache)."""
    return plan(F, T, _plan.capacity('em_estep', device_index, _KINDS[kind],
                                     D, K))


def _launch(kind, operands, outputs, F, D, K, T):
    """One launch of kernel ``kind`` over the F bins of T > 0 frames:
    operands (y, v, inv_eigenvalues, logdet, weight), outputs as the C
    entry point takes them; counted in :func:`cacgmm_e_step` or
    :func:`cacgmm_em_scatter`."""
    device = operands[0].device
    index = device.index or 0
    ctas, span, slots = _grid(kind, index, F, D, K, T, WAVES)
    stream = torch.cuda.current_stream(device).cuda_stream
    pointers = [x.data_ptr() for x in (*operands, *outputs)]
    if kind == 'e_step':
        launch(cacgmm_e_step, 'em_estep', 'em_e_step_launch', *pointers, F,
               D, K, T, ctas, span, stream)
        return
    counters, work = _plan.workspace(
        device, stream, F,
        2 * slots * F * K * (D * (D + 1) // 2 + 1) if slots > 1 else 0)
    launch(cacgmm_em_scatter, 'em_estep', 'em_scatter_launch', *pointers,
           work.data_ptr(), counters.data_ptr(), F, D, K, T, ctas, span,
           stream)


@counted
def cacgmm_e_step(y_re, y_im, v_re, v_im, inv_eigenvalues, logdet, weight):
    """Fused cACGMM E-step over all frequency bins.

    Args:
        y_re / y_im: (F, D, T) observation planes (time-last).
        v_re / v_im: (F, K, D, D) covariance eigenvector planes
            (eigenvectors in columns).
        inv_eigenvalues: (F, K, D) reciprocal eigenvalues.
        logdet: (F, K) log-determinants.
        weight: (F, K) linear-domain mixture weights.
    Returns:
        (affiliation (F, K, T), quadratic_form (F, K, T)) float32.
    """
    if y_re.device.type == 'cpu':
        return cacgmm_e_step_reference(y_re, y_im, v_re, v_im,
                                       inv_eigenvalues, logdet, weight)
    operands, F, D, K, T = _operands(
        _complex(y_re, y_im), _complex(v_re, v_im), inv_eigenvalues, logdet,
        weight)
    _check('e_step', D, K)
    aff = torch.empty((F, K, T), dtype=torch.float32, device=y_re.device)
    qf = torch.empty((F, K, T), dtype=torch.float32, device=y_re.device)
    if F and T:
        _launch('e_step', operands, (aff, qf), F, D, K, T)
    return aff, qf


@counted
def cacgmm_em_scatter(y_re, y_im, v_re, v_im, inv_eigenvalues, logdet,
                      weight):
    """Fused E-step + M-step scatter over all frequency bins.

    Args: as :func:`cacgmm_e_step`.
    Returns:
        (scatter_re (F, K, D, D), scatter_im (F, K, D, D),
        affiliation_sum (F, K)): the unnormalized weighted scatter
        ``D sum_t (a / q) y y^H`` and ``sum_t a``.
    """
    if y_re.device.type == 'cpu':
        return cacgmm_em_scatter_reference(y_re, y_im, v_re, v_im,
                                           inv_eigenvalues, logdet, weight)
    return em_scatter_model(_complex(y_re, y_im), _complex(v_re, v_im),
                            inv_eigenvalues, logdet, weight)


def em_scatter_model(y, eigenvectors, inv_eigenvalues, logdet, weight):
    """:func:`cacgmm_em_scatter` on the complex observations ``y`` (F, D,
    T) and the model's complex64 eigenvectors (F, K, D, D), which the
    kernel reads as they are. The route of
    ``CACGMMTrainer.fit(use_pallas_em=True)``; on CPU tensors the plain
    twin on their planes."""
    if y.device.type == 'cpu':
        return cacgmm_em_scatter_reference(
            y.real, y.imag, eigenvectors.real, eigenvectors.imag,
            inv_eigenvalues, logdet, weight)
    operands, F, D, K, T = _operands(y, eigenvectors, inv_eigenvalues,
                                     logdet, weight)
    _check('scatter', D, K)
    s_re = torch.empty((F, K, D, D), dtype=torch.float32, device=y.device)
    s_im = torch.empty_like(s_re)
    asum = torch.empty((F, K), dtype=torch.float32, device=y.device)
    if F and not T:
        for x in (s_re, s_im, asum):
            x.zero_()
    elif F:
        _launch('scatter', operands, (s_re, s_im, asum), F, D, K, T)
    return s_re, s_im, asum
