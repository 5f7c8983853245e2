"""Batched small-matrix linear algebra.

Counterpart of ``pb_bss_tpu.ops.linalg``: Hermitian symmetrization,
unit norm, the plain batched cyclic Jacobi eigensolver, the branchless
stable solve with its pseudo-inverse fallback, PCA, diagonal loading and
the GEV dominant eigenvector, with the JAX package's routing between
plain code and hand-written kernels.

Routing on CUDA follows the JAX package's TPU routing: where the JAX
package launches its batched Jacobi kernel
(``pallas_eigh.eigh_jacobi_pallas``) or its fused GEV kernel, the port
launches their CUDA counterparts (:mod:`.eigh`, :mod:`.gev`).
"""
from __future__ import annotations

import torch

from .._dtypes import real_dtype as _real_dtype, tiny as _tiny

__all__ = [
    'force_hermitian',
    'unit_norm',
    'eigh',
    'eigh_jacobi',
    'sort_ascending',
    'stable_solve',
    'solve_pinv',
    'get_pca',
    'condition_hermitian',
    'gev_max_eigvec',
]


def force_hermitian(matrix):
    """Symmetrize: ``(A + A^H) / 2``."""
    return (matrix + matrix.conj().transpose(-1, -2)) / 2


def unit_norm(signal, *, axis=-1, eps=1e-4, eps_style='plus', ord=None):
    """Normalize vectors to unit norm (2-norm, or 1-norm with
    ``ord=1``) with the JAX package's three eps styles:

    - ``'plus'``: divide by ``norm + eps``;
    - ``'max'``: divide by ``max(norm, eps)``;
    - ``'where'``: divide by ``eps`` only where the norm is exactly zero
      (zero vectors stay zero).
    """
    if ord is None or ord == 2:
        norm = torch.sqrt(torch.sum(
            (signal * signal.conj()).real, dim=axis, keepdim=True))
    elif ord == 1:
        norm = torch.sum(signal.abs(), dim=axis, keepdim=True)
    else:
        raise NotImplementedError(f'ord={ord}')
    if eps_style == 'plus':
        norm = norm + eps
    elif eps_style == 'max':
        norm = torch.clamp(norm, min=eps)
    elif eps_style == 'where':
        norm = torch.where(norm == 0, torch.full_like(norm, eps), norm)
    else:
        raise ValueError(eps_style)
    return signal / norm


def _default_sweeps(d, dtype):
    base = 6 if torch.finfo(_real_dtype(dtype)).bits <= 32 else 9
    if d > 8:
        base += 2
    return base


def _jacobi_rotate(A, V, p, q):
    """One batched Jacobi rotation zeroing A[:, p, q] (and [q, p]).
    A, V: (B, D, D); updated in place."""
    apq = A[:, p, q]
    absa = apq.abs()
    app = A[:, p, p].real
    aqq = A[:, q, q].real
    safe = torch.clamp(absa, min=_tiny(A.dtype))
    tau = (aqq - app) / (2 * safe)
    t = torch.where(
        tau == 0, torch.ones_like(tau),
        torch.sign(tau) / (tau.abs() + torch.sqrt(1 + tau * tau)))
    c = 1.0 / torch.sqrt(1 + t * t)
    sr = t * c
    s = sr * apq / safe if A.is_complex() else sr * torch.sign(apq)
    active = absa > 0
    c = torch.where(active, c, torch.ones_like(c))[:, None]
    s = torch.where(active, s, torch.zeros_like(s))[:, None]
    sc = s.conj()
    # A <- G^H A G: rows, then columns (order matters)
    rowp = A[:, p, :].clone()
    rowq = A[:, q, :].clone()
    A[:, p, :] = c * rowp - s * rowq
    A[:, q, :] = sc * rowp + c * rowq
    colp = A[:, :, p].clone()
    colq = A[:, :, q].clone()
    A[:, :, p] = c * colp - sc * colq
    A[:, :, q] = s * colp + c * colq
    vp = V[:, :, p].clone()
    vq = V[:, :, q].clone()
    V[:, :, p] = c * vp - sc * vq
    V[:, :, q] = s * vp + c * vq


def sort_ascending(w, v):
    """Sort eigenpairs ascending; ties keep the lower index first
    (stable sort)."""
    w, idx = torch.sort(w, dim=-1, stable=True)
    v = torch.gather(v, -1, idx.unsqueeze(-2).expand(v.shape))
    return w, v


def eigh_jacobi(a, *, sweeps=None, sort=True):
    """Batched Hermitian eigendecomposition via cyclic Jacobi sweeps
    (plain tensor code; the algorithm of the JAX package's
    ``eigh_jacobi``).

    Args:
        a: (..., D, D) Hermitian (complex) or real symmetric matrices.
        sweeps: cyclic sweeps; default from D and dtype (6 for f32).
        sort: sort eigenvalues ascending.
    Returns:
        (eigenvalues (..., D) real, eigenvectors (..., D, D) in
        columns).
    """
    d = a.shape[-1]
    assert a.shape[-2] == d, a.shape
    if sweeps is None:
        sweeps = _default_sweeps(d, a.dtype)
    batch_shape = a.shape[:-2]
    A = a.reshape(-1, d, d).clone()
    V = torch.eye(d, dtype=a.dtype, device=a.device).repeat(
        A.shape[0], 1, 1)
    if d > 1:
        for _ in range(sweeps):
            for p in range(d - 1):
                for q in range(p + 1, d):
                    _jacobi_rotate(A, V, p, q)
    w = torch.diagonal(A, dim1=-2, dim2=-1).real
    if sort:
        w, V = sort_ascending(w, V)
    return w.reshape(*batch_shape, d), V.reshape(*batch_shape, d, d)


def _kernel_eligible(a):
    """Where the JAX package launches its batched Jacobi (K1) and fused
    GEV (K3) kernels: an accelerator, f32/c64, D <= 16 and a batch of
    at least 64."""
    if a.device.type != 'cuda':
        return False
    if a.ndim < 3 or a.shape[-1] > 16:
        return False
    if a.dtype not in (torch.complex64, torch.float32):
        return False
    batch = 1
    for s in a.shape[:-2]:
        batch *= s
    return batch >= 64


def eigh(a, *, method='auto', sweeps=None, sort=True):
    """Batched Hermitian eigh; eigenvalues ascending (when ``sort``).

    ``method='auto'`` runs the plain Jacobi for D <= 16 and
    ``torch.linalg.eigh`` for larger matrices, except on CUDA for
    f32/c64 batches of at least 64 with D <= 16, where it launches the
    batched Jacobi kernel (:func:`pb_bss_tpu_torch.ops.eigh.eigh_jacobi`)
    as the JAX package launches its Pallas one. ``method='jacobi'``
    always runs the plain Jacobi; ``method='pallas'`` the kernel route
    (its plain twin on CPU tensors).
    """
    if method == 'auto':
        if _kernel_eligible(a):
            method = 'pallas'
        else:
            method = 'jacobi' if a.shape[-1] <= 16 else 'xla'
    if method == 'pallas':
        from .eigh import eigh_jacobi as eigh_kernel
        return eigh_kernel(a, sweeps=sweeps, sort=sort)
    if method == 'jacobi':
        return eigh_jacobi(a, sweeps=sweeps, sort=sort)
    if method == 'xla':
        return torch.linalg.eigh(a)
    raise ValueError(method)


def solve_pinv(a, b, *, rcond=None, hermitian=False):
    """Minimum-norm least-squares solve ``pinv(A) @ B``, batched, from
    the eigendecomposition of ``A`` (``hermitian=True``) or of ``A^H A``
    (the normal equations: ``pinv(A^H A) A^H B``), with eigenvalues
    below ``rcond * max|eig|`` taken as zero. Zero matrices give zero
    solutions.

    The eigensolver is :func:`eigh` at ``method='auto'``: on CUDA, for
    complex64 / float32 batches of at least 64 matrices with D <= 16,
    one launch of the batched Jacobi kernel (K1,
    :func:`pb_bss_tpu_torch.ops.eigh.eigh_jacobi`); elsewhere the plain
    cyclic Jacobi of :func:`eigh_jacobi`. The JAX package calls its
    XLA-level Jacobi here, whose algorithm both compute; run eagerly on
    the card, the plain Jacobi would be hundreds of small launches a
    call.
    """
    if rcond is None:
        rcond = torch.finfo(_real_dtype(a)).eps * a.shape[-1] * 10
    if hermitian:
        h, rhs = a, b
    else:
        h = torch.einsum('...da,...db->...ab', a.conj(), a)
        rhs = torch.einsum('...da,...dn->...an', a.conj(), b)
    w, v = eigh(h)
    cutoff = rcond * w.abs().amax(-1, keepdim=True)
    keep = w.abs() > cutoff
    w_inv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                        torch.zeros_like(w)).to(v.dtype)
    vhb = torch.einsum('...dk,...dn->...kn', v.conj(), rhs)
    return torch.einsum('...dk,...k,...kn->...dn', v, w_inv, vhb)


def _frobenius(m):
    return torch.sqrt(torch.sum((m * m.conj()).real, dim=(-2, -1)))


def stable_solve(a, b, *, hermitian=False):
    """Branchless ``solve`` with a per-matrix least-squares fallback.

    Solves every system by LU (``torch.linalg.solve_ex`` without its
    error check, so a singular matrix gives non-finite values instead
    of an exception, and CUDA no host sync), then takes the
    pseudo-inverse solution (:func:`solve_pinv`) for each matrix whose
    direct solution is not finite or leaves a relative residual above
    ``sqrt(eps)``. Both are computed for every matrix and selected with
    ``torch.where``: nothing is decided on the host. The solve and the
    residual run in full fp32 (no TF32).

    Args:
        a: (..., D, D)
        b: (..., D, N)
    Returns:
        x: (..., D, N) with ``a @ x ~= b``.
    """
    from ..models._precision import full_fp32  # models imports this module
    assert a.shape[:-2] == b.shape[:-2], (a.shape, b.shape)
    assert a.shape[-1] == b.shape[-2], (a.shape, b.shape)
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    with full_fp32():
        x, _ = torch.linalg.solve_ex(a, b, check_errors=False)
        finite = torch.isfinite(x.abs() if x.is_complex() else x).all(
            -1).all(-1)
        x_safe = torch.where(finite[..., None, None], x,
                             torch.zeros_like(x))
        residual = _frobenius(a @ x_safe - b)
        tol = torch.finfo(_real_dtype(a)).eps ** 0.5
        bad = ~finite | (residual > tol * torch.clamp(
            _frobenius(b), min=_tiny(a)))
        x_ls = solve_pinv(a, b, hermitian=hermitian)
        return torch.where(bad[..., None, None], x_ls, x_safe)


def get_pca(target_psd_matrix, return_all_vecs=False):
    """Dominant eigenvector and eigenvalue of batched Hermitian matrices
    (:func:`eigh` at ``method='auto'``: the Jacobi kernel K1 on CUDA
    batches it takes).

    Returns (vector (..., D), eigenvalue (...,)) or, with
    ``return_all_vecs``, all eigenvectors (columns) and eigenvalues,
    ascending.
    """
    w, v = eigh(target_psd_matrix)
    if return_all_vecs:
        return v, w
    return v[..., -1], w[..., -1]


def condition_hermitian(x, gamma=1e-10):
    """Diagonal loading ``(x + gamma tr(x)/D I) / (1 + gamma)``."""
    d = x.shape[-1]
    scale = gamma * torch.diagonal(x, dim1=-2, dim2=-1).sum(-1).real / d
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    return (x + eye * scale[..., None, None]) / (1 + gamma)


def cholesky_lower(a):
    """Unpivoted complex Cholesky ``a = L L^H`` (lower), column by
    column. A non-positive pivot gives NaN (sqrt of a negative number),
    never an exception: callers detect non-PD bins by non-finite
    output."""
    d = a.shape[-1]
    L = torch.zeros_like(a)
    for j in range(d):
        s = a[..., j, j].real - (L[..., j, :j].abs() ** 2).sum(-1)
        dj = torch.sqrt(s)
        L[..., j, j] = dj.to(a.dtype)
        if j + 1 < d:
            t = a[..., j + 1:, j] - torch.einsum(
                '...ik,...k->...i', L[..., j + 1:, :j],
                L[..., j, :j].conj())
            L[..., j + 1:, j] = t / dj[..., None]
    return L


def _forward_substitute(L, b):
    """Solve ``L x = b`` for lower-triangular L; b: (..., D, N)."""
    d = L.shape[-1]
    rows = []
    for i in range(d):
        r = b[..., i, :]
        for k in range(i):
            r = r - L[..., i, k, None] * rows[k]
        rows.append(r / L[..., i, i, None])
    return torch.stack(rows, dim=-2)


def _back_substitute_h(L, u):
    """Solve ``L^H x = u`` for lower-triangular L; u: (..., D)."""
    d = L.shape[-1]
    x = [None] * d
    for i in range(d - 1, -1, -1):
        r = u[..., i]
        for k in range(i + 1, d):
            r = r - L[..., k, i].conj() * x[k]
        x[i] = r / L[..., i, i].conj()
    return torch.stack(x, dim=-1)


def gev_staged(phi_xx, phi_nn, *, eigh_method='auto', sweeps=None):
    """Staged GEV: Cholesky-whiten the noise PSD, C = L^-1 phi_xx L^-H,
    hermitize, Jacobi eigh, pick the dominant eigenvector (first index
    among equal maxima) and back-substitute ``L^-H u``. B-normalized
    (``w^H phi_nn w = 1``); non-PD noise PSDs give non-finite vectors.
    All products run in the input precision (no TF32: they are
    elementwise ops, not matrix-unit products)."""
    L = cholesky_lower(phi_nn)
    tmp = _forward_substitute(L, phi_xx)
    c = _forward_substitute(
        L, tmp.conj().transpose(-1, -2)).conj().transpose(-1, -2)
    c = force_hermitian(c)
    w, v = eigh(c, method=eigh_method, sweeps=sweeps, sort=False)
    best = torch.argmax(w, dim=-1)  # first index among equal maxima
    u = torch.gather(
        v, -1, best[..., None, None].expand(*v.shape[:-1], 1))[..., 0]
    return _back_substitute_h(L, u)


def gev_max_eigvec(target_psd_matrix, noise_psd_matrix, *,
                   condition=0.0, method='auto'):
    """Dominant generalized eigenvector of the pencil (phi_xx, phi_nn).

    ``method='auto'`` launches the fused GEV kernel (K3,
    :func:`pb_bss_tpu_torch.ops.gev.gev`) on CUDA for f32/c64 batches
    of at least 64 pencils with D <= 16, and the staged plain path
    otherwise; ``method='pallas'`` forces the fused route (the plain
    twin on CPU tensors), ``method='xla'`` the staged path.

    Args:
        target_psd_matrix: (..., D, D) Hermitian.
        noise_psd_matrix: (..., D, D) Hermitian positive definite.
        condition: optional diagonal-loading gamma applied to the noise
            PSD first (0 disables).
    Returns:
        (..., D) B-normalized beamforming vectors.
    """
    phi_xx = target_psd_matrix
    phi_nn = noise_psd_matrix
    if condition:
        phi_nn = condition_hermitian(phi_nn, condition)
    if method == 'auto' and _kernel_eligible(phi_nn):
        method = 'pallas'
    if method == 'pallas':
        from .gev import gev
        return gev(phi_xx, phi_nn)
    if method in ('auto', 'xla'):
        return gev_staged(phi_xx, phi_nn)
    raise ValueError(method)
