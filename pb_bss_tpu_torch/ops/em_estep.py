"""The opt-in cACGMM E-step kernels (``csrc/em_estep.cu``).

Replaces the JAX package's Pallas TPU kernels
``pb_bss_tpu/ops/pallas_em.py``: :func:`cacgmm_e_step`
(``cacgmm_e_step``, the fused E-step) and :func:`cacgmm_em_scatter`
(``cacgmm_em_scatter``, the E-step folded into the M-step scatter, the
kernel behind ``CACGMMTrainer.fit(use_pallas_em=True)``). Both keep the
JAX package's real/imaginary plane interface.

The quadratic form is the projection on the scaled eigenbasis
``W = V diag(sqrt(1/l))`` (built once per bin and class),
``q = sum_i |(W^H y)_i|^2``, which equals the plain twins'
``sum_i |(V^H y)_i|^2 / l_i`` up to f32 rounding; the JAX kernels'
assembled inverse ``V diag(1/l) V^H`` cancels once an eigenvalue sits at
the floor. The E-step is unclipped, as the JAX kernels' is. The scatter kernel walks T
in shared-memory tiles and so takes any T; its shared memory depends on
D and K only (:func:`scatter_fits`). It computes nearly what the
streamed statistics pass (``em_stream.cu``) computes, but is its own
kernel: it takes the inverse eigenvalues and log-determinants as given,
weights by ``a / q`` and returns ``D`` times the sum as planes.

What bounds it on the H100: y is read once per call (3.7 MB at F=257,
T=304, D=6), so at the trainer's sizes the launches are short and
latency-bound.

On a CPU tensor the wrappers run their plain PyTorch twins
(:func:`cacgmm_e_step_reference`, :func:`cacgmm_em_scatter_reference`).
On a CUDA tensor they launch the kernels or raise; they never fall
back.
"""
from __future__ import annotations

import torch

from .._dtypes import tiny as _tiny
from ._build import SMEM_LIMIT

__all__ = ['cacgmm_e_step', 'cacgmm_e_step_reference', 'cacgmm_em_scatter',
           'cacgmm_em_scatter_reference', 'scatter_fits']

TILE = 512  # frames per shared-memory tile (kTile in csrc/em_estep.cu)


def scatter_fits(D, K):
    """Does the scatter kernel take (D, K)? (T does not matter.)"""
    P = D * (D + 1) // 2
    return D <= 16 and (8 * (D * TILE + 2 * K * D * D + K * P)
                        + 4 * (2 * K * TILE + 3 * K)) <= SMEM_LIMIT


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


def _operands(y_re, y_im, v_re, v_im, inv_eigenvalues, logdet, weight):
    """Check the shapes and device; contiguous float32 operands."""
    if y_re.device.type != 'cuda':
        raise ValueError(f'unsupported device {y_re.device}')
    if y_re.ndim != 3:
        raise ValueError(f'y planes must be (F, D, T), got '
                         f'{tuple(y_re.shape)}')
    F, D, T = y_re.shape
    K = v_re.shape[1]
    shapes = ((F, D, T), (F, D, T), (F, K, D, D), (F, K, D, D), (F, K, D),
              (F, K), (F, K))
    out = []
    for x, shape in zip((y_re, y_im, v_re, v_im, inv_eigenvalues, logdet,
                         weight), shapes):
        if tuple(x.shape) != shape or x.device != y_re.device:
            raise ValueError(f'expected {shape} on {y_re.device}, got '
                             f'{tuple(x.shape)} on {x.device}')
        out.append(x.to(torch.float32).contiguous())
    if D > 16:
        raise ValueError(f'the E-step kernels take D <= 16, got {D}')
    return out, F, D, K, T


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
    operands, F, D, K, T = _operands(y_re, y_im, v_re, v_im,
                                     inv_eigenvalues, logdet, weight)
    aff = torch.empty((F, K, T), dtype=torch.float32, device=y_re.device)
    qf = torch.empty((F, K, T), dtype=torch.float32, device=y_re.device)
    if F and T:
        from ._build import load
        err = load('em_estep').em_e_step_launch(
            *[x.data_ptr() for x in operands], aff.data_ptr(),
            qf.data_ptr(), F, D, K, T,
            torch.cuda.current_stream(y_re.device).cuda_stream)
        if err:
            raise RuntimeError(
                f'cacgmm_e_step kernel launch failed: CUDA error {err}')
        cacgmm_e_step.launches += 1
    return aff, qf


cacgmm_e_step.launches = 0


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
    operands, F, D, K, T = _operands(y_re, y_im, v_re, v_im,
                                     inv_eigenvalues, logdet, weight)
    if not scatter_fits(D, K):
        raise ValueError(
            f'(D={D}, K={K}) is outside the scatter kernel\'s shared-memory '
            'budget')
    s_re = torch.empty((F, K, D, D), dtype=torch.float32,
                       device=y_re.device)
    s_im = torch.empty_like(s_re)
    asum = torch.empty((F, K), dtype=torch.float32, device=y_re.device)
    if F:
        from ._build import load
        err = load('em_estep').em_scatter_launch(
            *[x.data_ptr() for x in operands], s_re.data_ptr(),
            s_im.data_ptr(), asum.data_ptr(), F, D, K, T,
            torch.cuda.current_stream(y_re.device).cuda_stream)
        if err:
            raise RuntimeError(
                f'cacgmm_em_scatter kernel launch failed: CUDA error {err}')
        cacgmm_em_scatter.launches += 1
    return s_re, s_im, asum


cacgmm_em_scatter.launches = 0
