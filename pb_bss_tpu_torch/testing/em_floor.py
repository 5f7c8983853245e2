"""Inputs that put the cACGMM EM at its eigenvalue floor.

A converged fit drives some class's smallest eigenvalue to the floor
(max-normalized, 1e-10) when that class's frames span fewer than D
dimensions. The quadratic form y^H C^-1 y then weighs a direction by
1e10. Taken as the projection, sum_i |v_i^H y|^2 / lambda_i, a frame in
the span of the other eigenvectors adds only its f32 rounding of
v_0^H y (~1e-7) squared over 1e-10, ~1e-4. Taken through the assembled
inverse covariance V diag(1/lambda) V^H, whose entries are ~1e10, the
f32 errors of the sum (~1e3) swamp a true q of O(1), and a q <= 0
floored at tiny weighs its frame ~1e37 in the next scatter.

Two input functions, numpy from a seed, so that the CPU tests and
``chip_smoke.py`` feed the same kind of input to the port's kernels,
their plain twins and the JAX package:

* :func:`model_at_floor` gives a model (the E-step's input: the streamed
  statistics pass, the frequency-constant step, the opt-in E-step
  kernels) with class 0's first eigenvalue exactly at the floor and the
  first third of the frames orthogonal to its eigenvector.
* :func:`affiliations_at_floor` gives initial affiliations (the first
  M-step's input: the whole-fit EM, the frequency-constant init) under
  which class 0 sits on frames that span a (D - 1)-dimensional subspace
  and is exactly 0 on the others (with ``affiliation_eps=0``), so its
  first M-step leaves one eigenvalue at the floor or within f32 rounding
  of zero.
"""
from __future__ import annotations

import numpy as np

__all__ = ['FLOOR', 'model_at_floor', 'affiliations_at_floor']

FLOOR = 1e-10  # the EM's default eigenvalue_floor


def _cn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _unit(y):
    return (y / np.linalg.norm(y, axis=-2, keepdims=True)).astype(
        np.complex64)


def _mixture(rng, N, D, T):
    """Two sources plus noise in every bin, (N, D, T) complex128."""
    return np.einsum('ndk,nkt->ndt', _cn(rng, N, D, 2), _cn(rng, N, 2, T)) \
        + 0.3 * _cn(rng, N, D, T)


def model_at_floor(N, D, K, T, seed):
    """N bins of T unit-norm frames and a cACG model at the floor.

    Returns a dict of numpy arrays: ``y`` (N, D, T) complex64;
    ``eigenvalues`` (N, K, D) float32, max-normalized, class 0's
    eigenvalue 0 exactly ``FLOOR``; ``eigenvectors`` (N, K, D, D)
    complex64 unitary, in columns; ``weight`` (N, K) float32 summing to
    1. The first T // 3 frames of every bin lie in the span of class 0's
    eigenvectors 1..D-1 (orthogonal to eigenvector 0 up to f32
    rounding)."""
    rng = np.random.default_rng(seed)
    y = _mixture(rng, N, D, T)
    vec = np.linalg.qr(_cn(rng, N, K, D, D))[0].astype(np.complex64)
    ev = rng.uniform(0.05, 1., (N, K, D))
    ev /= ev.max(-1, keepdims=True)
    ev = ev.astype(np.float32)
    ev[:, 0, 0] = FLOOR
    inside = T // 3
    y[..., :inside] = np.einsum('nde,net->ndt', vec[:, 0, :, 1:],
                                _cn(rng, N, D - 1, inside))
    weight = rng.uniform(0.2, 1., (N, K))
    weight /= weight.sum(-1, keepdims=True)
    return dict(y=_unit(y), eigenvalues=ev, eigenvectors=vec,
                weight=weight.astype(np.float32))


def affiliations_at_floor(N, D, K, T, seed):
    """N bins of T unit-norm frames and initial affiliations under which
    class 0's first M-step is rank-deficient.

    Returns a dict of numpy arrays: ``y`` (N, D, T) complex64 whose first
    T // 3 frames lie in a random (D - 1)-dimensional subspace of each
    bin; ``affiliation`` (N, K, T) float32 summing to 1 over the classes,
    class 0's in [0.3, 1) on those frames and exactly 0 on the others;
    ``quadratic_form`` (N, K, T) float32 ones."""
    rng = np.random.default_rng(seed)
    y = _mixture(rng, N, D, T)
    inside = T // 3
    basis = np.linalg.qr(_cn(rng, N, D, D - 1))[0]
    y[..., :inside] = np.einsum('nde,net->ndt', basis,
                                _cn(rng, N, D - 1, inside))
    rest = rng.uniform(0.1, 1., (N, K - 1, T))
    rest /= rest.sum(1, keepdims=True)
    own = np.zeros((N, 1, T))
    own[..., :inside] = rng.uniform(0.3, 1., (N, 1, inside))
    aff = np.concatenate([own, (1 - own) * rest], axis=1)
    return dict(y=_unit(y), affiliation=aff.astype(np.float32),
                quadratic_form=np.ones((N, K, T), np.float32))
