"""The complex Bingham distribution of the port (pb_bss_tpu_torch.models.
complex_bingham) against the JAX package on the same numpy inputs: the
log normalizer, its gradient, the duplicate-eigenvalue spacing, the
moment inversion on its scan path (cold, warm and bounded) and the
trainer. Inputs are float32 / complex64 on both sides (the shared
conftest turns on x64 in JAX)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models import complex_bingham as jcb
from pb_bss_tpu_torch.models import complex_bingham as tcb

torch.set_num_threads(2)


def _moments(B, D, seed):
    """(B, D) sorted, spaced float32 moments (unit trace)."""
    rng = np.random.default_rng(seed)
    s = np.sort(rng.dirichlet(np.full(D, 0.7), size=B), -1).astype(
        np.float32)
    return np.asarray(jcb._remove_duplicate_eigenvalues(jnp.asarray(s))[1],
                      np.float32)


def _eigenvalues(B, D, seed, spread=50.):
    """(B, D) ascending Bingham eigenvalues with the maximum at 0."""
    rng = np.random.default_rng(seed)
    lam = -np.sort(rng.uniform(0., spread, (B, D)), -1)[:, ::-1].copy()
    lam[:, -1] = 0.
    return lam


def _residual(lam, s):
    """max_d |grad log Z(lam) - s| per problem, by the JAX package."""
    g = np.asarray(jcb._grad_log_norm(jnp.asarray(lam, jnp.float32)))
    return np.abs(g - s).max(-1)


def _assert_same_solutions(ours, theirs, s):
    """Two f32 solves of the same moments: the iterates part by rounding
    in the saturated directions (a moment <~ 1e-3 leaves its eigenvalue
    exponentially flat), so the residual is the criterion, as in the JAX
    package's solver tests; the solutions agree to 1e-3 relative (to
    1 + |lambda|) at the median and 5e-3 where |lambda| < 300."""
    rel = (np.abs(ours - theirs) / (1 + np.abs(theirs))).max(-1)
    well = np.abs(theirs).max(-1) < 300
    assert np.median(rel) < 1e-3 and rel[well].max() < 5e-3, rel
    r_o, r_t = _residual(ours, s), _residual(theirs, s)
    assert np.median(r_o) < 2 * max(np.median(r_t), 1e-5)
    assert r_o.max() < 2 * max(r_t.max(), 1e-4)


def test_log_norm_matches_partial_fractions_in_f64():
    """The cascade against the partial-fraction form, which is exact in
    f64 for well-spaced eigenvalues: 1e-9 relative."""
    lam = _eigenvalues(20, 5, seed=0, spread=40.)
    lam[:, :-1] -= np.arange(4, 0, -1)  # spacing >= 1
    ours = tcb._log_norm_dd(torch.as_tensor(lam)).numpy()
    oracle = tcb._log_norm_distinct(torch.as_tensor(lam)).numpy()
    assert_allclose(ours, oracle, rtol=1e-9)
    assert_allclose(ours, np.asarray(jcb._log_norm_dd(jnp.asarray(lam))),
                    rtol=1e-12)


@pytest.mark.parametrize('D', [3, 6])
def test_log_norm_and_gradient_match_jax_in_f32(D):
    """f32 cascades in two frameworks: the same products in other
    summation orders, 1e-5 relative."""
    lam = _eigenvalues(30, D, seed=D).astype(np.float32)
    lam[0] = 0.  # all equal: the confluent limit
    lam[1, :-1] = -1e-3  # near-duplicates at the spacing guard
    ours = tcb._log_norm_dd(torch.as_tensor(lam)).numpy()
    assert_allclose(ours, np.asarray(jcb._log_norm_dd(jnp.asarray(lam))),
                    rtol=1e-5)
    grad = tcb._grad_log_norm(torch.as_tensor(lam)).numpy()
    assert_allclose(grad, np.asarray(jcb._grad_log_norm(jnp.asarray(lam))),
                    rtol=1e-5, atol=1e-7)
    # the gradient of log Z is a distribution over the directions
    assert_allclose(grad.sum(-1), 1., rtol=1e-5)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_remove_duplicate_eigenvalues_matches_jax(dtype):
    rng = np.random.default_rng(1)
    ev = rng.uniform(0., 1., (40, 5)).astype(dtype)
    ev[:10, 2] = ev[:10, 3]  # exact duplicates
    ev[10:20, 1] = ev[10:20, 4] + 1e-9
    perm, reg = tcb._remove_duplicate_eigenvalues(torch.as_tensor(ev))
    jperm, jreg = jcb._remove_duplicate_eigenvalues(jnp.asarray(ev))
    assert reg.dtype == torch.from_numpy(ev).dtype
    assert_allclose(reg.numpy(), np.asarray(jreg), rtol=1e-6)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    eps = tcb._default_spacing_eps(reg.dtype)
    # the cumulative sum rounds each step by an ulp of the running value
    assert (np.diff(reg.numpy(), axis=-1) >= 0.999 * eps).all()


@pytest.fixture(scope='module')
def cold():
    """Cold scan-path solves of the same moments in both packages."""
    s = _moments(24, 5, seed=2)
    theirs = np.asarray(jcb.find_eigenvalues(jnp.asarray(s), iterations=50,
                                             use_pallas=False))
    ours = tcb.find_eigenvalues(torch.as_tensor(s), iterations=50,
                                use_pallas=False).numpy()
    return s, ours, theirs


def test_find_eigenvalues_cold_matches_jax(cold):
    """50 damped Gauss-Newton steps with the forward-mode Jacobian."""
    s, ours, theirs = cold
    assert ours.dtype == np.float32 and ours.shape == s.shape
    _assert_same_solutions(ours, theirs, s)
    assert (ours[:, -1] == 0).all() and (np.diff(ours, axis=-1) > 0).all()


def test_find_eigenvalues_warm_matches_jax(cold):
    """16 chord steps from a perturbed solution."""
    s, lam, _ = cold
    rng = np.random.default_rng(3)
    warm = (lam * (1 + 0.05 * rng.standard_normal((len(s), 1)))).astype(
        np.float32)
    warm[:, -1] = 0.
    theirs = np.asarray(jcb.find_eigenvalues(
        jnp.asarray(s), iterations=16, warm_start=jnp.asarray(warm),
        use_pallas=False))
    ours = tcb.find_eigenvalues(torch.as_tensor(s), iterations=16,
                                warm_start=torch.as_tensor(warm),
                                use_pallas=False).numpy()
    _assert_same_solutions(ours, theirs, s)


def test_find_eigenvalues_bounded_and_unsorted_match_jax():
    """A finite max_concentration floors and re-spaces; unsorted moments
    come back in their own order (the inverse permutation)."""
    rng = np.random.default_rng(4)
    s = rng.dirichlet(np.full(4, 0.5), size=12).astype(np.float32)
    kw = dict(iterations=50, max_concentration=50.)
    theirs = np.asarray(jcb.find_eigenvalues(jnp.asarray(s),
                                             use_pallas=False, **kw))
    ours = tcb.find_eigenvalues(torch.as_tensor(s), use_pallas=False,
                                **kw).numpy()
    assert_allclose(ours, theirs, rtol=1e-3, atol=1e-3)
    assert ours.min() >= -50. - 1e-4
    np.testing.assert_array_equal(np.argsort(ours, -1), np.argsort(s, -1))


def test_moment_round_trip():
    """The moments of known eigenvalues invert back to them (the
    eigenvalues are well inside the domain and spaced)."""
    lam = _eigenvalues(16, 4, seed=5, spread=20.).astype(np.float32)
    lam[:, :-1] -= np.arange(3, 0, -1)
    s = tcb._grad_log_norm(torch.as_tensor(lam))
    back = tcb.find_eigenvalues(s, iterations=50, use_pallas=False).numpy()
    assert_allclose(back, lam, atol=5e-2 * (1 + np.abs(lam)).max())
    assert np.median(np.abs(back - lam) / (1 + np.abs(lam))) < 1e-3


def test_kernel_route_on_the_cpu_is_the_chord_twin():
    """use_pallas=True on a CPU tensor runs the chord solve's twin (three
    10-step rounds cold) and launches nothing: the same fixed point as
    the scan path, held by the residual."""
    from pb_bss_tpu_torch.ops.bingham import bingham_chord_solve
    s = _moments(24, 5, seed=2)
    before = bingham_chord_solve.launches
    ours = tcb.find_eigenvalues(torch.as_tensor(s), use_pallas=True).numpy()
    assert bingham_chord_solve.launches == before
    scan = np.asarray(jcb.find_eigenvalues(jnp.asarray(s), iterations=50,
                                           use_pallas=False))
    assert np.median(_residual(ours, s)) < 2 * max(
        np.median(_residual(scan, s)), 1e-5)


def _observations(F, N, D, seed):
    rng = np.random.default_rng(seed)
    mode = rng.standard_normal((F, 1, D)) + 1j * rng.standard_normal(
        (F, 1, D))
    y = mode + 0.4 * (rng.standard_normal((F, N, D))
                      + 1j * rng.standard_normal((F, N, D)))
    return y.astype(np.complex64)


@pytest.mark.parametrize('saliency', [False, True])
def test_trainer_fit_matches_jax(saliency):
    y = _observations(6, 80, 4, seed=6)
    sal = (np.random.default_rng(7).uniform(0.2, 1., y.shape[:-1])
           .astype(np.float32) if saliency else None)
    theirs = jcb.ComplexBinghamTrainer().fit(
        jnp.asarray(y), saliency=None if sal is None else jnp.asarray(sal))
    ours = tcb.ComplexBinghamTrainer().fit(
        torch.as_tensor(y), saliency=None if sal is None
        else torch.as_tensor(sal))
    ev, jev = (ours.covariance_eigenvalues.numpy(),
               np.asarray(theirs.covariance_eigenvalues))
    assert (np.abs(ev - jev) / (1 + np.abs(jev))).max() < 1e-3
    # the eigenvectors differ by a phase per column: compare covariances
    assert_allclose(ours.covariance.numpy(), np.asarray(theirs.covariance),
                    atol=1e-3 * np.abs(jev).max())
    yt = torch.as_tensor(tcb.normalize_observation(torch.as_tensor(y)))
    assert_allclose(ours.log_pdf(yt).numpy(), np.asarray(
        theirs.log_pdf(jnp.asarray(yt.numpy()))), rtol=1e-4, atol=1e-3)
