"""Complex Bingham distribution.

Counterpart of ``pb_bss_tpu.models.complex_bingham``: the eigen-
parameterized density ``y^H V diag(lambda) V^H y - log c(lambda)``, the
cancellation-free log normalizer and the trainer that inverts the moment
equations ``grad log c(lambda) = scatter_eigenvalues`` per (bin, class).

The normalizer ``c / (2 pi^D)`` is the divided difference
``exp[lambda_1, ..., lambda_D]``, read off the bidiagonal ``expm``
(:func:`_expm_bidiagonal`, scaling and squaring: every intermediate is a
nonnegative confluent divided difference, so nothing cancels in f32).
Its gradient comes from the same cascade over the doubled nodes
(:func:`_grad_log_norm`). Every matrix product of the cascade runs in
full fp32 (:func:`~pb_bss_tpu_torch.models._precision.full_fp32`): a
low-precision cascade gives NaN posteriors.

:func:`find_eigenvalues` has two routes, as in the JAX package:

* **scan** (any device, any dtype): a cold solve is 50 damped
  Gauss-Newton steps from ``-1/s`` with a forward-mode Jacobian
  (``torch.func.jacfwd`` under ``torch.func.vmap``, the JAX package's
  ``jax.jacfwd``, so the CPU follows the same iterates); a warm solve is
  the chord Gauss-Newton with one Jacobian.
* **kernel** (CUDA tensors, f32, 2 <= D <= 8: the counterpart of the JAX
  package's TPU gate): the chord solve of
  :func:`pb_bss_tpu_torch.ops.bingham.bingham_chord_solve` (kernel K8,
  a finite-difference Jacobian per launch): three launches of 10 steps
  for a cold solve, one of ``iterations`` steps for a warm one.

Both keep the JAX package's guards: the domain cap ``|lambda| <= 32768``,
the diff bounds ``[-mc_eff, -spacing_eps]``, the step clip of 1e3, the
floor and re-spacing under a finite ``max_concentration`` and the inverse
permutation back to the input's order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._dtypes import real_dtype as _real_dtype, tiny as _tiny
from ..ops.linalg import eigh, force_hermitian
from ._precision import full_fp32
from .base import Model, modelclass
from .complex_watson import is_broadcast_compatible, normalize_observation

__all__ = [
    'ComplexBingham',
    'ComplexBinghamTrainer',
    'normalize_observation',
    'find_eigenvalues',
]

SQUARINGS = 15  # exact domain |lambda| <= 2 ** 15 = 32768
TAYLOR_TERMS = 13
CAP_TOTAL = 32768.0


def _default_spacing_eps(dtype):
    """Minimum eigenvalue spacing: 1e-8 at f64, 1e-3 at f32 (1e-8 is below
    the f32 ulp at concentration scale and leaves exact duplicates)."""
    return 1e-8 if torch.finfo(dtype).bits >= 64 else 1e-3


def _remove_duplicate_eigenvalues(covariance_eigenvalues, eps=None):
    """Sort ascending and force a minimum spacing of ``eps`` between
    adjacent eigenvalues.

    Returns (inverse_permutation, regularized_eigenvalues).
    """
    if eps is None:
        eps = _default_spacing_eps(covariance_eigenvalues.dtype)
    sorted_vals, permutation = torch.sort(covariance_eigenvalues, dim=-1,
                                          stable=True)
    diff = torch.clamp(torch.diff(sorted_vals, dim=-1), min=eps)
    regularized = torch.cat([
        sorted_vals[..., :1],
        sorted_vals[..., :1] + torch.cumsum(diff, dim=-1),
    ], dim=-1)
    inverse_permutation = torch.argsort(permutation, dim=-1, stable=True)
    return inverse_permutation, regularized


def _log_norm_distinct(eigenvalues):
    """log of ``2 pi^D sum_d exp(lambda_d) / prod_{d' != d}(lambda_d -
    lambda_d')`` (partial fractions). It cancels in f32 when eigenvalues
    are close: an f64 test oracle only."""
    D = eigenvalues.shape[-1]
    deltas = eigenvalues[..., None] - eigenvalues[..., None, :]
    eye = torch.eye(D, dtype=eigenvalues.dtype, device=eigenvalues.device)
    deltas = deltas * (1 - eye) + eye
    a = 1.0 / torch.prod(deltas, dim=-1)
    return math.log(2.0) + D * math.log(math.pi) + torch.log(
        torch.sum(a * torch.exp(eigenvalues), dim=-1))


def _expm_bidiagonal(nodes):
    """``expm`` of the upper-bidiagonal matrix with ``nodes`` on the
    diagonal and ones on the superdiagonal, by scaling and squaring (15
    squarings, 13 Taylor terms). Entry (j, k), j <= k, is the confluent
    divided difference ``exp[nodes_j, ..., nodes_k]``; exact for
    max-shifted ``|nodes| <= 32768``."""
    n = nodes.shape[-1]
    eye = torch.eye(n, dtype=nodes.dtype, device=nodes.device)
    superdiag = torch.ones(n - 1, dtype=nodes.dtype,
                           device=nodes.device).diag(1)
    J = superdiag + nodes[..., None] * eye
    A = J * (2.0 ** -SQUARINGS)
    E = eye + A
    term = A
    with full_fp32():
        for k in range(2, TAYLOR_TERMS + 1):
            term = (term @ A) / k
            E = E + term
        for _ in range(SQUARINGS):
            E = E @ E
    return E


def _log_norm_dd(eigenvalues):
    """Cancellation-free Bingham log norm: ``log 2 + D log pi + lmax +
    log exp[lambda - lmax]`` from the (0, D-1) entry of the bidiagonal
    ``expm``."""
    D = eigenvalues.shape[-1]
    lmax = torch.max(eigenvalues, dim=-1, keepdim=True).values
    E = _expm_bidiagonal(eigenvalues - lmax)
    dd = torch.clamp(E[..., 0, D - 1], min=_tiny(eigenvalues))
    return (math.log(2.0) + D * math.log(math.pi) + lmax[..., 0]
            + torch.log(dd))


@modelclass
class ComplexBingham(Model):
    covariance_eigenvectors: torch.Tensor = None  # (..., D, D)
    covariance_eigenvalues: torch.Tensor = None  # (..., D)
    # the frequency axis of each field as a mixture's component,
    # (..., F, K, ...): what a sharded fit gathers (_shard.py)
    bin_axes = {'covariance_eigenvectors': -4, 'covariance_eigenvalues': -3}

    @property
    def covariance(self):
        vectors = self.covariance_eigenvectors
        values = self.covariance_eigenvalues.to(vectors.dtype)
        with full_fp32():
            return (vectors * values[..., None, :]) \
                @ vectors.conj().transpose(-1, -2)

    def pdf(self, y):
        return torch.exp(self.log_pdf(y))

    def log_pdf(self, y):
        """y: (..., N, D) complex unit vectors (leading dims broadcast
        against the model's) -> (..., N)."""
        with full_fp32():
            result = torch.einsum('...td,...td->...t', y.conj(),
                                  y @ self.covariance.transpose(-1, -2))
        return result.real - self.log_norm()[..., None]

    def log_norm(self, remove_duplicate_eigenvalues=True, eps=None):
        eigenvalues = self.covariance_eigenvalues
        if remove_duplicate_eigenvalues:
            _, eigenvalues = _remove_duplicate_eigenvalues(eigenvalues,
                                                           eps=eps)
        return _log_norm_dd(eigenvalues)

    def norm(self, remove_duplicate_eigenvalues=True, eps=None):
        return torch.exp(self.log_norm(
            remove_duplicate_eigenvalues=remove_duplicate_eigenvalues,
            eps=eps))


def _grad_log_norm(eigenvalues):
    """Gradient of the log norm with respect to the eigenvalues:
    ``exp[lambda_1..lambda_D, lambda_i] / exp[lambda_1..lambda_D]``, both
    from one ``2D x 2D`` cascade over the doubled nodes (entry (i, i+D)
    and entry (0, D-1))."""
    D = eigenvalues.shape[-1]
    lmax = torch.max(eigenvalues, dim=-1, keepdim=True).values
    shifted = eigenvalues - lmax
    E = _expm_bidiagonal(torch.cat([shifted, shifted], dim=-1))
    dd = torch.clamp(E[..., 0, D - 1], min=_tiny(shifted))
    idx = torch.arange(D, device=eigenvalues.device)
    return E[..., idx, idx + D] / dd[..., None]


def _kernel_solver_default(s):
    """Where the chord kernel (K8) runs: a CUDA tensor, f32, 2 <= D <= 8
    (the JAX package's gate asks for a non-CPU backend)."""
    return (s.device.type == 'cuda' and s.dtype == torch.float32
            and 2 <= s.shape[-1] <= 8)


def _lam_of(u):
    """lambda_j = sum_{i >= j} of [u, 0]: ascending, max pinned to 0."""
    full = torch.cat([u, torch.zeros_like(u[..., :1])], dim=-1)
    return torch.flip(torch.cumsum(torch.flip(full, [-1]), -1), [-1])


def _bound(est, max_concentration, eps):
    """Floor at -max_concentration, then the minimum spacing again."""
    est = torch.clamp(est, min=-max_concentration)
    return _remove_duplicate_eigenvalues(est, eps=eps)[1]


def _scan_solve(flat, warm, *, iterations, lower, upper, cap_init):
    """The scan path over (B, D) sorted moments: cold damped Gauss-Newton
    (``warm`` None) or warm chord Gauss-Newton."""
    B, D = flat.shape
    dtype = flat.dtype
    eye = torch.eye(D - 1, dtype=dtype, device=flat.device)

    def residual_one(u, s):
        return _grad_log_norm(_lam_of(u)) - s

    def residual(u):
        return _grad_log_norm(_lam_of(u)) - flat

    def clip(u):
        return torch.clamp(torch.clamp(u, max=upper), min=lower)

    jac = torch.func.vmap(torch.func.jacfwd(residual_one))  # (B, D, D-1)

    if warm is None:
        x0 = -1.0 / torch.clamp(flat, min=1e-12)
        x0 = torch.cat([x0[:, :-1], torch.zeros_like(x0[:, :1])], dim=-1)
        x0 = torch.maximum(x0, -(cap_init - torch.arange(
            D, dtype=dtype, device=flat.device)))
    else:
        x0 = torch.sort(warm.to(dtype), dim=-1).values
    u = clip(-torch.diff(x0, dim=-1))

    def normal(J):
        with full_fp32():
            return J.transpose(-1, -2) @ J + 1e-12 * eye

    def jt(J, r):
        with full_fp32():
            return (J.transpose(-1, -2) @ r[..., None])[..., 0]

    if warm is not None:
        J0 = jac(u, flat)
        inverse = torch.linalg.inv(normal(J0))
        for _ in range(iterations):
            delta = (inverse @ jt(J0, residual(u))[..., None])[..., 0]
            u = clip(u - torch.clamp(delta, -1e3, 1e3))
        return _lam_of(u)

    for _ in range(iterations):
        r = residual(u)
        J = jac(u, flat)
        delta = torch.linalg.solve(normal(J), jt(J, r))
        delta = torch.clamp(delta, -1e3, 1e3)
        u_full = clip(u - delta)
        u_half = clip(u - 0.5 * delta)
        better = (residual(u_full) ** 2).sum(-1) \
            <= (residual(u_half) ** 2).sum(-1)
        u = torch.where(better[:, None], u_full, u_half)
    return _lam_of(u)


def _kernel_solve(chord, flat, warm, *, iterations, lower, upper,
                  cap_init):
    """The kernel route over (B, D) sorted moments: three chord launches
    of 10 steps from the ``-1/s`` start (cold), or one of ``iterations``
    steps from ``warm``. ``chord`` is the K8 wrapper or its twin."""
    D = flat.shape[-1]
    s32 = flat.to(torch.float32)
    if warm is None:
        x0 = -1.0 / torch.clamp(flat, min=1e-12)
        x0 = torch.cat([x0[:, :-1], torch.zeros_like(x0[:, :1])], dim=-1)
        x0 = torch.maximum(x0, -(cap_init - torch.arange(
            D, dtype=flat.dtype, device=flat.device)))
        est = x0.to(torch.float32)
        for _ in range(3):
            est = chord(s32, est, iterations=10, lower=lower, upper=upper)
    else:
        est = chord(s32, torch.sort(warm, dim=-1).values.to(torch.float32),
                    iterations=iterations, lower=lower, upper=upper)
    return est.to(flat.dtype)


def find_eigenvalues(scatter_eigenvalues, *, max_concentration=math.inf,
                     eps=None, iterations=50, warm_start=None,
                     use_pallas=None, _chord=None):
    """Invert the moment equations: Bingham eigenvalues ``lambda`` (max
    pinned to 0) with ``grad log c(lambda) = scatter_eigenvalues``.

    Args:
        scatter_eigenvalues: (..., D) nonnegative moments.
        warm_start: optional (..., D) previous solution (ascending, max
            pinned to 0): a chord solve of ``iterations`` steps from it.
        use_pallas: take the chord kernel route (K8; its plain twin on a
            CPU tensor). None = auto: CUDA, f32, 2 <= D <= 8.
        _chord: the chord solver of the kernel route (default the K8
            wrapper; the plain twins pass the kernel's twin).
    Returns:
        (..., D) Bingham eigenvalues in the input's element order.
    """
    s = torch.as_tensor(scatter_eigenvalues)
    if not s.is_floating_point() or torch.finfo(s.dtype).bits < 32:
        s = s.to(torch.float32)
    dtype = s.dtype
    D = s.shape[-1]
    inverse_permutation, s_sorted = _remove_duplicate_eigenvalues(s,
                                                                  eps=eps)
    upper = -_default_spacing_eps(dtype)
    max_concentration = float(max_concentration)
    lower = -min(max_concentration, CAP_TOTAL / (D - 1))
    cap_init = min(max_concentration, CAP_TOTAL)
    flat = s_sorted.reshape(-1, D)
    warm = None if warm_start is None else \
        torch.as_tensor(warm_start, device=s.device).reshape(-1, D)
    if use_pallas is None:
        use_pallas = _chord is not None or _kernel_solver_default(s)
    kw = dict(iterations=iterations, lower=lower, upper=upper,
              cap_init=cap_init)
    if use_pallas:
        if _chord is None:
            from ..ops.bingham import bingham_chord_solve as _chord
        solved = _kernel_solve(_chord, flat, warm, **kw)
    else:
        solved = _scan_solve(flat, warm, **kw)
    if np.isfinite(max_concentration):
        solved = _bound(solved, max_concentration, eps)
    solved = solved.reshape(s_sorted.shape)
    return torch.gather(solved, -1, inverse_permutation)


class ComplexBinghamTrainer:
    def __init__(self, dimension=None, max_concentration=np.inf,
                 eignevalue_eps=None):
        """
        Args:
            dimension: feature dimension (inferred at fit if None).
            max_concentration: bound on the eigenvalue spread.
            eignevalue_eps: duplicate-eigenvalue regularizer (the
                misspelling is the reference API's).
        """
        self.dimension = dimension
        assert max_concentration > 0, max_concentration
        self.max_concentration = max_concentration
        self.eignevalue_eps = eignevalue_eps

    @classmethod
    def find_eigenvalues_v3(cls, scatter_eigenvalues, eps=None,
                            max_concentration=np.inf):
        return find_eigenvalues(torch.as_tensor(scatter_eigenvalues),
                                max_concentration=float(max_concentration),
                                eps=eps)

    find_eigenvalues_v2 = find_eigenvalues_v3

    def fit(self, y, saliency=None) -> ComplexBingham:
        assert y.is_complex(), y.dtype
        assert y.shape[-1] > 1
        y = normalize_observation(y)
        if saliency is not None:
            saliency = torch.as_tensor(saliency, device=y.device)
            assert is_broadcast_compatible(y.shape[:-1], saliency.shape), (
                y.shape, saliency.shape)
        if self.dimension is None:
            self.dimension = y.shape[-1]
        else:
            assert self.dimension == y.shape[-1], (
                'You initialized the trainer with a different dimension '
                'than you are using to fit a model. Use a new trainer, '
                'when you change the dimension.')
        return self._fit(y, saliency=saliency)

    def _fit(self, y, saliency, warm_start=None,
             solver_iterations=None) -> ComplexBingham:
        """y (..., N, D) unit-norm; saliency broadcastable to (..., N)."""
        with full_fp32():
            if saliency is None:
                covariance = y.transpose(-1, -2) @ y.conj()
                denominator = torch.tensor(
                    y.shape[-2], dtype=_real_dtype(y), device=y.device)
            else:
                weighted = y * saliency[..., None].to(y.dtype)
                covariance = weighted.transpose(-1, -2) @ y.conj()
                denominator = saliency.sum(-1)[..., None, None]
        covariance = covariance / torch.clamp(
            denominator, min=_tiny(y)).to(covariance.dtype)
        scatter_eigenvalues, eigenvectors = eigh(force_hermitian(covariance))
        eigenvalues = find_eigenvalues(
            torch.clamp(scatter_eigenvalues, min=0.0),
            max_concentration=float(self.max_concentration),
            eps=self.eignevalue_eps,
            iterations=50 if solver_iterations is None
            else solver_iterations,
            warm_start=warm_start)
        return ComplexBingham(covariance_eigenvectors=eigenvectors,
                              covariance_eigenvalues=eigenvalues)
