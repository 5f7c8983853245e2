"""The plain twin of the chord-solve kernel K8 (pb_bss_tpu_torch.ops.
bingham) against the JAX package's scan-path solver on the same warm
starts, judged as tests/test_ops/test_pallas_bingham.py judges the
Pallas kernel: the chord fixed point is grad log Z(lambda) = s whatever
the Jacobian, so the RESIDUAL of the returned solution is the criterion;
trajectories may differ in the saturated directions (moments <~ 1e-4).
Inputs are float32 on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_bss_tpu.models.complex_bingham import (
    _grad_log_norm,
    _remove_duplicate_eigenvalues,
    find_eigenvalues as jax_find_eigenvalues,
)
from pb_bss_tpu_torch.models.complex_bingham import find_eigenvalues
from pb_bss_tpu_torch.ops import bingham

torch.set_num_threads(2)


def _moments_and_warm(B, D, seed, perturb=0.05):
    """Sorted, spaced moments and a warm start: JAX's cold solution
    perturbed by 5%, re-sorted, maximum pinned to 0."""
    rng = np.random.default_rng(seed)
    s = np.sort(rng.dirichlet(np.full(D, 0.7), size=B), -1).astype(
        np.float32)
    s = np.asarray(_remove_duplicate_eigenvalues(jnp.asarray(s))[1],
                   np.float32)
    lam = np.sort(np.array(jax_find_eigenvalues(
        jnp.asarray(s), iterations=50, use_pallas=False), np.float32), -1)
    x0 = lam * (1 + perturb * rng.standard_normal((B, 1)).astype(np.float32))
    x0[:, -1] = 0.
    return s, np.sort(x0, -1)


def _residual(lam, s):
    g = np.asarray(jax.vmap(_grad_log_norm)(jnp.asarray(lam, jnp.float32)))
    return np.abs(g - s).max(-1)


@pytest.mark.parametrize('D', [3, 4, 6])
def test_twin_matches_the_jax_chord_quality(D):
    s, x0 = _moments_and_warm(37, D, seed=D)
    before = bingham.bingham_chord_solve.launches
    lam = bingham.bingham_chord_solve(
        torch.as_tensor(s), torch.as_tensor(x0), iterations=16,
        lower=-32768.0 / (D - 1), upper=-1e-3).numpy()
    assert bingham.bingham_chord_solve.launches == before  # CPU: the twin
    ref = np.sort(np.array(jax_find_eigenvalues(
        jnp.asarray(s), iterations=16, warm_start=jnp.asarray(x0),
        use_pallas=False)), -1)
    r_k, r_x = _residual(lam, s), _residual(ref, s)
    # converges at least as well as the chord with the exact Jacobian
    # (the same fixed point)
    assert np.median(r_k) < 2 * max(np.median(r_x), 1e-5)
    assert r_k.max() < 3 * max(r_x.max(), 1e-3)
    # the same solutions outside the saturated tail
    well = np.abs(ref).max(-1) < 300
    diff = (np.abs(lam - ref) / (1 + np.abs(ref))).max(-1)
    assert np.median(diff[well]) < 1e-3
    # structure: ascending, maximum pinned to 0
    assert lam.shape == (37, D) and np.isfinite(lam).all()
    assert (np.diff(lam, axis=-1) >= 0).all()
    np.testing.assert_array_equal(lam[:, -1], 0.)


def test_kernel_route_unsorted_and_bounded():
    """find_eigenvalues(use_pallas=True) through the twin: unsorted
    moments come back in their own order, and max_concentration=50
    bounds the spread."""
    rng = np.random.default_rng(11)
    B, D = 64, 6
    s = rng.dirichlet(np.full(D, 0.8), size=B).astype(np.float32)
    perm = rng.permuted(np.broadcast_to(np.arange(D), (B, D)), axis=-1)
    s_unsorted = np.take_along_axis(s, perm, axis=-1)
    ref = np.sort(np.array(jax_find_eigenvalues(
        jnp.asarray(np.sort(s_unsorted, -1)), iterations=50,
        use_pallas=False)), -1)
    warm = np.take_along_axis(
        ref, np.argsort(np.argsort(s_unsorted, -1), -1), axis=-1)
    out = find_eigenvalues(torch.as_tensor(s_unsorted), iterations=16,
                           warm_start=torch.as_tensor(warm),
                           use_pallas=True).numpy()
    np.testing.assert_array_equal(np.argsort(s_unsorted, -1),
                                  np.argsort(out, -1))
    assert np.median(_residual(np.sort(out, -1),
                               np.sort(s_unsorted, -1))) < 1e-3
    bounded = find_eigenvalues(torch.as_tensor(s_unsorted), iterations=16,
                               warm_start=torch.as_tensor(warm),
                               use_pallas=True,
                               max_concentration=50.).numpy()
    assert bounded.min() >= -50. - 1e-4
    jax_bounded = np.asarray(jax_find_eigenvalues(
        jnp.asarray(s_unsorted), iterations=16,
        warm_start=jnp.asarray(warm), use_pallas=False,
        max_concentration=50.))
    np.testing.assert_array_equal(np.argsort(bounded, -1),
                                  np.argsort(jax_bounded, -1))


@pytest.mark.parametrize('D', [2, 5, 8])
def test_block_frechet_cascade_matches_the_doubled_nodes(D):
    """The kernel's cascade form ([[E, X], [0, E]] in block-Frechet
    form) against JAX's doubled-node cascade: the same divided
    differences, 1e-5 relative; dd is exp[lambda]."""
    rng = np.random.default_rng(D)
    lam = -np.sort(rng.uniform(0., 200., (25, D)), -1)[:, ::-1].copy()
    lam[:, -1] = 0.
    lam[0, :] = 0.
    lam = lam.astype(np.float32)
    g, dd = bingham.grad_cascade(torch.as_tensor(lam))
    np.testing.assert_allclose(
        g.numpy(), np.asarray(jax.vmap(_grad_log_norm)(jnp.asarray(lam))),
        rtol=1e-5, atol=1e-7)
    assert (dd > 0).all()


def test_saturated_moments_stay_in_the_domain():
    """A zero moment gives -1/1e-12; the cold start is floored into the
    |lambda| <= 32768 domain and every value stays finite."""
    s = np.array([[0., 0.1, 0.2, 0.7], [0., 0., 0., 1.]], np.float32)
    lam = find_eigenvalues(torch.as_tensor(s), use_pallas=True).numpy()
    assert np.isfinite(lam).all()
    assert lam.min() >= -32768.
    np.testing.assert_array_equal(lam.argmax(-1), [3, 3])


def test_cascade_count():
    """Cold: 3 rounds of (1 + (D-1) + 10) cascades; warm: 1 + 5 + 16 at
    D=6. One cascade at D=6 is 12,180 flops over its nonzero entries: 15
    squarings of 56 multiply-adds for E E (E upper triangular) and 252 for
    E X + X E, and 2,940 in the banded Taylor terms."""
    assert bingham.solve_cascades(6, 3, 10) == 48
    assert bingham.solve_cascades(6, 1, 16) == 22
    squarings = 15 * 2 * (6 * 7 * 8 // 6 + 36 * 7)
    assert squarings == 9240
    assert bingham.cascade_flops(6) == squarings + 2940
    # a full (dense) Taylor phase would be 12 terms x 36 entries x (2 per
    # product term + 2) of T and X, well above the banded count
    assert bingham.cascade_flops(6) - squarings < 12 * 2 * 36 * 4


@pytest.mark.slow
def test_twin_matches_the_pallas_kernel_in_interpret_mode():
    """The twin against the JAX package's Pallas kernel (interpret mode)
    on the same inputs: the same algorithm, held by the residual."""
    from pb_bss_tpu.ops.pallas_bingham import bingham_chord_solve
    s, x0 = _moments_and_warm(37, 6, seed=6)
    lam_k = np.asarray(bingham_chord_solve(
        jnp.asarray(s), jnp.asarray(x0), iterations=16,
        lower=-32768.0 / 5, upper=-1e-3, interpret=True))
    lam_t = bingham.bingham_chord_solve(
        torch.as_tensor(s), torch.as_tensor(x0), iterations=16,
        lower=-32768.0 / 5, upper=-1e-3).numpy()
    assert np.median(_residual(lam_t, s)) < 2 * max(
        np.median(_residual(lam_k, s)), 1e-5)
    well = np.abs(lam_k).max(-1) < 300
    diff = (np.abs(lam_t - lam_k) / (1 + np.abs(lam_k))).max(-1)
    assert np.median(diff[well]) < 1e-4
