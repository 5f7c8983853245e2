"""Batched Bingham moment inversion by chord Gauss-Newton (kernel
``csrc/bingham.cu``, device code in ``csrc/bingham.cuh``).

Replaces the JAX package's Pallas TPU kernel
``pb_bss_tpu/ops/pallas_bingham.py:bingham_chord_solve``. Each problem
inverts ``grad log Z(lambda) = s`` for one (bin, class) in the diff
parameterization ``u_i = lambda_i - lambda_{i+1}`` in ``[lower, upper]``:
one chord round is

* ``grad log Z`` at ``u`` and at ``D - 1`` shifted points, each from one
  block-Frechet cascade (:func:`grad_cascade`), giving a one-sided
  finite-difference Jacobian with the relative step ``fd_step *
  max(1, |u|)``; a column whose effective (clipped) step is below 1% of
  the intended one is zeroed;
* the regularized normal matrix ``J^T J (1 + 1e-5) + 1e-20``, inverted
  once by an unrolled Cholesky;
* ``iterations`` steps ``u <- clip(u - clip(Minv J^T r, +-1e3))`` with
  ``r = grad log Z(u) - s``, one cascade each.

The block-Frechet cascade evaluates ``expm`` of the doubled-node
bidiagonal ``[[J, C], [0, J]]`` (``C = e_D e_1^T``) as ``[[E, X], [0,
E]]``: ``E[0, D-1] = exp[lambda_1..lambda_D]`` and ``X[i, i] =
exp[lambda_1..lambda_D, lambda_i]``, so ``grad_i log Z = X[i, i] / E[0,
D-1]``. The Taylor phase multiplies by the bidiagonal ``J`` as a column
shift-and-scale, the squaring phase is ``(E, X) <- (E E, E X + X E)``.

On a CPU tensor :func:`bingham_chord_solve` runs the plain twin
(:func:`bingham_chord_solve_reference`, the same rounds as batched
PyTorch ops over the problems). On a CUDA tensor it launches the kernel
or raises; it never falls back.
"""
from __future__ import annotations

import torch

__all__ = ['bingham_chord_solve', 'bingham_chord_solve_reference',
           'grad_cascade', 'lam_of_u', 'chord_round', 'cascade_flops',
           'solve_cascades']

SQUARINGS = 15
TAYLOR_TERMS = 13
FD_STEP = -1e-2
_TINY = torch.finfo(torch.float32).tiny


def grad_cascade(lam):
    """(grad log Z (B, D), dd = exp[lambda_1..lambda_D] (B,)) at
    ascending nodes ``lam`` (B, D), each <= 0 (max pinned to 0), in the
    kernel's block-Frechet form."""
    from ..models._precision import full_fp32
    B, D = lam.shape
    cs = 2.0 ** -SQUARINGS
    eye = torch.eye(D, dtype=lam.dtype, device=lam.device)
    superdiag = torch.ones(D - 1, dtype=lam.dtype,
                           device=lam.device).diag(1)
    cols = lam[:, None, :]  # column j scales by lambda_j

    def shift(m):  # column j <- column j - 1, column 0 <- 0
        return torch.cat([torch.zeros_like(m[..., :1]), m[..., :-1]], -1)

    T = cs * (lam[:, :, None] * eye + superdiag)
    E = eye + T
    TX = torch.zeros_like(T)
    TX[:, D - 1, 0] = cs
    X = TX.clone()
    for k in range(2, TAYLOR_TERMS + 1):
        csk = cs / k
        e1 = torch.zeros_like(T)
        e1[..., 0] = T[..., D - 1]
        TX = (e1 + TX * cols + shift(TX)) * csk
        T = (T * cols + shift(T)) * csk
        E = E + T
        X = X + TX
    with full_fp32():
        for _ in range(SQUARINGS):
            E, X = E @ E, E @ X + X @ E
    dd = torch.clamp(E[:, 0, D - 1], min=_TINY)
    return torch.diagonal(X, dim1=-2, dim2=-1) * (1.0 / dd)[:, None], dd


def lam_of_u(u):
    """lambda_j = sum_{i >= j} u_i, lambda_{D-1} = 0: (B, D-1) -> (B, D)."""
    full = torch.cat([u, torch.zeros_like(u[:, :1])], dim=-1)
    return torch.flip(torch.cumsum(torch.flip(full, [-1]), -1), [-1])


def chord_round(s, u, *, iterations, lower, upper, fd_step=FD_STEP):
    """One Jacobian refresh and ``iterations`` chord steps on ``u`` (B,
    D-1) for the sorted moments ``s`` (B, D); returns the new ``u``."""
    B, D = s.shape
    d1 = D - 1

    def clip(x):
        return torch.clamp(torch.clamp(x, min=lower), max=upper)

    g0, _ = grad_cascade(lam_of_u(u))
    eye = torch.eye(d1, dtype=u.dtype, device=u.device)
    shift = fd_step * torch.clamp(u.abs(), min=1.0)[:, :, None] * eye
    u_s = clip(u[:, None, :] + shift)  # (B, i, D-1): shifted in entry i
    h = (u_s - u[:, None, :]).sum(-1)  # effective (clipping-safe)
    h_int = shift.sum(-1)  # intended
    g, _ = grad_cascade(lam_of_u(u_s.reshape(B * d1, d1)))
    dead = h.abs() < 0.01 * h_int.abs()
    inv_h = torch.where(dead, torch.zeros_like(h),
                        1.0 / torch.where(dead, torch.ones_like(h), h))
    J = (g.reshape(B, d1, D) - g0[:, None, :]) * inv_h[..., None]  # (B, i, d)

    # (J^T J (1 + 1e-5) + 1e-20)^-1 by the kernel's unrolled Cholesky
    jtj = [[(J[:, a] * J[:, b]).sum(-1) for b in range(d1)]
           for a in range(d1)]
    for a in range(d1):
        jtj[a][a] = jtj[a][a] * (1.0 + 1e-5) + 1e-20
    chol = [[None] * d1 for _ in range(d1)]
    for a in range(d1):
        acc = jtj[a][a]
        for k in range(a):
            acc = acc - chol[a][k] * chol[a][k]
        inv_diag = torch.rsqrt(torch.clamp(acc, min=_TINY))
        chol[a][a] = 1.0 / inv_diag
        for b in range(a + 1, d1):
            acc = jtj[b][a]
            for k in range(a):
                acc = acc - chol[b][k] * chol[a][k]
            chol[b][a] = acc * inv_diag
    columns = []
    for col in range(d1):
        y = [None] * d1
        for a in range(d1):
            acc = torch.full_like(chol[0][0], 1.0 if a == col else 0.0)
            for k in range(a):
                acc = acc - chol[a][k] * y[k]
            y[a] = acc / chol[a][a]
        x = [None] * d1
        for a in range(d1 - 1, -1, -1):
            acc = y[a]
            for k in range(a + 1, d1):
                acc = acc - chol[k][a] * x[k]
            x[a] = acc / chol[a][a]
        columns.append(torch.stack(x, -1))
    minv = torch.stack(columns, -1)  # (B, a, col)

    for _ in range(iterations):
        g, _ = grad_cascade(lam_of_u(u))
        b = (J * (g - s)[:, None, :]).sum(-1)
        delta = (minv * b[:, None, :]).sum(-1)
        u = clip(u - torch.clamp(delta, -1e3, 1e3))
    return u


def bingham_chord_solve_reference(s_sorted, x0, *, iterations, lower, upper,
                                  fd_step=FD_STEP):
    """Plain PyTorch twin of the kernel: one chord round, batched over the
    problems. Args and returns as :func:`bingham_chord_solve`."""
    u = torch.clamp(torch.clamp(x0[:, :-1] - x0[:, 1:], min=lower),
                    max=upper)
    return lam_of_u(chord_round(s_sorted, u, iterations=iterations,
                                lower=lower, upper=upper, fd_step=fd_step))


def bingham_chord_solve(s_sorted, x0, *, iterations, lower, upper,
                        fd_step=FD_STEP):
    """Chord Gauss-Newton Bingham moment inversion, one launch.

    Args:
        s_sorted: (B, D) float32 ascending, spaced moments (unit trace).
        x0: (B, D) float32 start: ascending, max pinned to 0.
        iterations: chord steps (one cascade each).
        lower / upper: bounds of the diffs ``lambda_i - lambda_{i+1}``.
    Returns:
        (B, D) float32 Bingham eigenvalues, ascending, max pinned to 0.
    """
    if s_sorted.device.type == 'cpu':
        return bingham_chord_solve_reference(
            s_sorted, x0, iterations=iterations, lower=lower, upper=upper,
            fd_step=fd_step)
    if s_sorted.device.type != 'cuda':
        raise ValueError(f'unsupported device {s_sorted.device}')
    if s_sorted.ndim != 2 or not 2 <= s_sorted.shape[-1] <= 8:
        raise ValueError(f's_sorted must be (B, D) with 2 <= D <= 8, got '
                         f'{tuple(s_sorted.shape)}')
    if tuple(x0.shape) != tuple(s_sorted.shape) or x0.device != \
            s_sorted.device:
        raise ValueError(f'x0 must be {tuple(s_sorted.shape)} on '
                         f'{s_sorted.device}, got {tuple(x0.shape)} on '
                         f'{x0.device}')
    B, D = s_sorted.shape
    s_ = s_sorted.to(torch.float32).contiguous()
    x_ = x0.to(torch.float32).contiguous()
    out = torch.empty_like(s_)
    if B:
        from ._build import load
        err = load('bingham').bingham_chord_launch(
            s_.data_ptr(), x_.data_ptr(), out.data_ptr(), B, D,
            int(iterations), float(lower), float(upper), float(fd_step),
            torch.cuda.current_stream(s_.device).cuda_stream)
        if err:
            raise RuntimeError(
                f'bingham_chord kernel launch failed: CUDA error {err}')
        bingham_chord_solve.launches += 1
    return out


bingham_chord_solve.launches = 0


def cascade_flops(D):
    """float32 operations one block-Frechet cascade needs at D nodes,
    counted over the entries that can be nonzero, 2 per multiply-add.

    Taylor phase (terms 2..13): ``T <- T J / k`` and ``TX <- (T e_D e_1^T
    + TX J) / k`` with the bidiagonal ``J``, then ``E += T`` and ``X +=
    TX``: per entry of the new term one multiply-add for each nonzero
    product term, one scale and one add. ``T = J^k / k!`` is upper
    triangular with bandwidth k and ``TX`` fills the corner ``(D - 1 - i)
    + j <= k - 1``, so the early terms are sparse. Squarings (15):
    ``E E`` and ``E X + X E`` with ``E`` upper triangular, D (D + 1) (D +
    2) / 6 + D^2 (D + 1) multiply-adds when ``X`` is full."""
    import numpy as np
    pattern = (np.eye(D, dtype=np.int64)
               + np.eye(D, k=1, dtype=np.int64))  # J: bidiagonal
    t = pattern.copy()
    tx = np.zeros((D, D), np.int64)
    tx[D - 1, 0] = 1
    e, x = pattern.copy(), tx.copy()  # E = I + cs J, X = TX
    flops = 0
    for _ in range(2, TAYLOR_TERMS + 1):
        inject = np.zeros_like(tx)
        inject[:, 0] = t[:, D - 1] > 0
        terms_x = (tx > 0) @ pattern + inject
        terms_t = (t > 0) @ pattern
        flops += int((2 * terms_x + 2 * (terms_x > 0)).sum()
                     + (2 * terms_t + 2 * (terms_t > 0)).sum())
        t, tx = terms_t, terms_x
        e, x = e | (t > 0), x | (tx > 0)
    for _ in range(SQUARINGS):
        flops += 2 * int((e @ e).sum() + (e @ x).sum() + (x @ e).sum())
        e, x = (e @ e > 0).astype(np.int64), (e @ x + x @ e > 0).astype(
            np.int64)
    return flops


def solve_cascades(D, rounds, steps):
    """Cascades of one problem's solve: per round the base point, D - 1
    finite-difference points and one per chord step."""
    return rounds * (D + steps)
