"""Jointly-diagonalizable full-rank spatial covariance analysis (FCA)
as the separation pipeline's refinement runs it: FastFCA (Ito and
Nakatani, arXiv:1805.06572) and FastFCA-AS (Ito, Araki and Nakatani,
arXiv:1805.09498), with the diagonalizer updated by FastMNMF's
iterative-projection (IP) rows.

Per bin the K sources share one diagonalizer Q; in the transformed
domain ``z_t = Q y_t`` channel d has the variance ``sigma2_dt = sum_k
v_kt lambda_kd``. One iteration, from ``p = |Q y|^2``:

* the Itakura-Saito multiplicative update (MU) of the powers,
  ``v <- v sqrt(sum_d lambda p / sigma2^2 / sum_d lambda / sigma2)``;
* the MU of the spatial spectra, ``lambda <- lambda sqrt(sum_t v p /
  sigma2^2 / sum_t v / sigma2)``, from the new powers;
* ``lambda`` divided by its mean over d (the scale moves into ``v``)
  and floored at 1e-6;
* one IP sweep of the D rows, in order, from the new ``sigma2``: row d
  solves ``(Q V_d) h = e_d`` with ``V_d = mean_t y y^H / sigma2_dt``,
  is scaled to ``h^H V_d h = 1`` and becomes ``h^H``.

The output is the Wiener image ``Q^{-1} (g_k z)`` at the reference
channel, with the gains ``g_kd = v_k lambda_kd / sum_j v_j lambda_jd``.

The conventions of the system under test where they fix a result:
``eps = 1e-10`` added to ``sigma2``, to the powers after their MU and to
the MUs' denominators, ``eps / K`` to each class's numerator of the
gains, a row's squared norm floored at ``eps``; ``Q_0 = I``,
``lambda_0 = 1``, ``v_0 = mask * mean_d |y_d|^2 + eps``. Departures: an
IP row and the back-transform's inverse are plain LU solves (the system
takes the pseudo-inverse of a system whose float32 LU solution is not
finite or leaves a relative residual above sqrt(eps), a gate of its
precision and not of the model); a singular system leaves its bin
non-finite and raises nothing.

Every matrix product goes through :func:`precision.mm`, so the same code
is the judge (float64) and the control (TF32 inputs); the solves run in
the working precision.
"""
from __future__ import annotations

import torch

from .precision import cmm, complex_dtype, mm, real_dtype

EPS = 1e-10
FLOOR = 1e-6


def _sigma2(v, lam, precision):
    """(N, K, T), (N, K, D) -> (N, D, T)."""
    return mm(lam.transpose(-1, -2), v, precision) + EPS


def _mu(v, lam, p, precision):
    """The MUs of the powers, then of the spatial spectra."""
    sigma2 = _sigma2(v, lam, precision)
    num = mm(lam, p / sigma2 ** 2, precision)
    den = mm(lam, 1 / sigma2, precision)
    v = v * torch.sqrt(num / (den + EPS)) + EPS
    sigma2 = _sigma2(v, lam, precision)
    num = mm(v, (p / sigma2 ** 2).transpose(-1, -2), precision)
    den = mm(v, (1 / sigma2).transpose(-1, -2), precision)
    lam = lam * torch.sqrt(num / (den + EPS))
    return v, lam


def _normalize(v, lam):
    scale = lam.mean(-1, keepdim=True)
    return v * scale, torch.clamp(lam / scale, min=FLOOR)


def _ip_sweep(q, y, sigma2, precision):
    """One IP sweep over the rows of ``q`` (N, D, D) for ``y`` (N, D, T)."""
    N, D, T = y.shape
    for d in range(D):
        weighted = y / sigma2[:, d, None, :]
        v_d = cmm(weighted, y.conj().transpose(-1, -2), precision) / T
        e_d = torch.zeros((N, D, 1), dtype=q.dtype, device=q.device)
        e_d[:, d] = 1
        h, _ = torch.linalg.solve_ex(cmm(q, v_d, precision), e_d)  # (N, D, 1)
        norm2 = cmm(h.conj().transpose(-1, -2), cmm(v_d, h, precision),
                    precision)[:, 0, 0].real
        h = h / torch.sqrt(torch.clamp(norm2, min=EPS))[:, None, None]
        q = torch.cat([q[:, :d], h.conj().transpose(-1, -2), q[:, d + 1:]],
                      dim=1)
    return q


def fit(y, masks, iterations, precision='float64'):
    """(Q, lambda, v) of the fit of ``y`` (N, D, T) from ``masks``
    (N, K, T)."""
    rdtype = real_dtype(precision)
    y = y.to(complex_dtype(precision))
    N, D, T = y.shape
    K = masks.shape[-2]
    mean_power = (y.real ** 2 + y.imag ** 2).mean(-2)  # (N, T)
    v = masks.to(rdtype) * mean_power[:, None] + EPS
    lam = torch.ones((N, K, D), dtype=rdtype, device=y.device)
    q = torch.eye(D, dtype=y.dtype, device=y.device).expand(N, D, D)
    for _ in range(iterations):
        z = cmm(q, y, precision)
        p = z.real ** 2 + z.imag ** 2
        v, lam = _normalize(*_mu(v, lam, p, precision))
        q = _ip_sweep(q, y, _sigma2(v, lam, precision), precision)
    return q, lam, v


def images(q, lam, v, y, reference_channel, precision='float64'):
    """The Wiener images at ``reference_channel`` (N, K, T) of ``y``
    (N, D, T) under the model (Q, lambda, v)."""
    y = y.to(complex_dtype(precision))
    K = v.shape[-2]
    numerator = v[:, :, None, :] * lam[..., None] + EPS / K  # (N, K, D, T)
    gains = numerator / numerator.sum(1, keepdim=True)
    z = cmm(q, y, precision)  # (N, D, T)
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    q_inv, _ = torch.linalg.solve_ex(q, eye.expand(q.shape))
    row = q_inv[:, None, reference_channel:reference_channel + 1]
    return cmm(row, gains * z[:, None], precision)[..., 0, :]


def fca(spectrum, masks, iterations, precision='float64', *,
        reference_channel=0):
    """The refinement's output spectra (B, K, T, F) from spectra
    (B, D, T, F) and aligned masks (B, K, F, T): every bin fitted on its
    own, the Wiener image at ``reference_channel``. TF32 stays off in
    the library for the call; the control rounds its inputs itself."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        B, D, T, F = spectrum.shape
        K = masks.shape[1]
        y = spectrum.permute(0, 3, 1, 2).reshape(B * F, D, T)
        m = masks.transpose(1, 2).reshape(B * F, K, T)
        model = fit(y, m, iterations, precision)
        out = images(*model, y, reference_channel, precision)
        return out.reshape(B, F, K, T).permute(0, 2, 3, 1)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


__all__ = ['fca', 'fit', 'images']
