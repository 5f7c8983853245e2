"""The complex Watson distribution of the port
(pb_bss_tpu_torch.models.complex_watson) against the JAX package on the
same numpy inputs: the log-norms, the hyp1f1 table and its inverse, the
trainer and a JAX model carried across."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from scipy.special import hyp1f1

from pb_bss_tpu.models import complex_watson as jcw
from pb_bss_tpu_torch.models.complex_watson import (
    ComplexWatson,
    ComplexWatsonTrainer,
    _hypergeometric_ratio_grid,
    interp,
)

torch.set_num_threads(2)


def _exact_log_norm(kappa, D):
    """log of 2 pi^D 1F1(1; D; k) / (D - 1)! in float64 (scipy)."""
    kappa = np.asarray(kappa, np.float64)
    return np.log(hyp1f1(1, D, kappa) * 2 * np.pi ** D / math.factorial(D - 1))


def _grid(D):
    return np.array([0., 1e-3, 1e-2, 1 / D, 1 / D * 1.01, 0.2, 0.5, 1., 2.,
                     D - 1.5, D - 1., 20., 100., 500.], np.float32)


@pytest.mark.parametrize('D', [3, 6, 8, 16])
def test_log_norm_tran_vu_matches_jax_and_the_exact_norm(D):
    """Below 1/D and from D - 1 on the port computes what the JAX package
    computes; between them, where the JAX package's f32 Eq. 3 cancels
    (-inf at D=8, k=1/8), the series. Both held against the exact norm
    in float64 and against JAX where JAX's f32 is accurate."""
    kappa = _grid(D)
    ours = ComplexWatson.log_norm_tran_vu(torch.as_tensor(kappa), D)
    assert ours.dtype == torch.float32
    ours = ours.numpy()
    exact = _exact_log_norm(kappa, D)
    assert np.isfinite(ours).all()
    assert_allclose(ours, exact, rtol=1e-5, atol=1e-5)
    theirs = np.asarray(jcw.ComplexWatson.log_norm_tran_vu(
        jnp.asarray(kappa), D))
    accurate = np.abs(theirs - exact) <= 1e-5 * np.abs(exact) + 1e-5
    assert accurate[(kappa < 1 / D) | (kappa >= D - 1)].all()
    assert_allclose(ours[accurate], theirs[accurate], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('D', [3, 6])
def test_low_medium_high_match_jax(D):
    kappa = np.array([0.01, 0.05, 5., 20., 200.], np.float32)
    for name in ('log_norm_low_concentration',
                 'log_norm_medium_concentration',
                 'log_norm_high_concentration'):
        ours = getattr(ComplexWatson, name)(torch.as_tensor(kappa), D).numpy()
        theirs = np.asarray(getattr(jcw.ComplexWatson, name)(
            jnp.asarray(kappa), D))
        sel = np.isfinite(theirs)
        assert_allclose(ours[sel], theirs[sel], rtol=1e-5, atol=1e-6)


def test_log_norm_is_finite_over_a_dense_grid_in_f32():
    kappa = torch.cat([torch.zeros(1), torch.logspace(-4, np.log10(500), 400)])
    for D in (2, 3, 4, 6, 8, 12, 16):
        assert torch.isfinite(ComplexWatson.log_norm_tran_vu(kappa, D)).all()


@pytest.mark.parametrize('D', [3, 6])
def test_hyp1f1_grid_equals_jax(D):
    ours = _hypergeometric_ratio_grid(D, 500., 1000)
    theirs = jcw._hypergeometric_ratio_grid(D, 500, 1000)
    for a, b in zip(ours, theirs):
        assert_allclose(a, np.asarray(b), rtol=0, atol=0)


def test_ratio_inverse_matches_jnp_interp_with_both_clamps():
    D = 5
    ratios = np.array([0., 0.1, 1 / 5, 1 / 5 + 1e-4, 0.3, 0.7, 0.9599999,
                       0.999, 1., 1.5], np.float32)
    ours = ComplexWatsonTrainer(D).hypergeometric_ratio_inverse(
        torch.as_tensor(ratios))
    theirs = np.asarray(jcw.ComplexWatsonTrainer(D)
                        .hypergeometric_ratio_inverse(jnp.asarray(ratios)))
    assert ours.dtype == torch.float32
    assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-6)
    # below 1/D: kappa 0; above the last marker: max_concentration
    assert ours[0] == 0 and ours[1] == 0
    assert ours[-1] == 500 and ours[-2] == 500


def test_interp_matches_jnp_interp_on_random_points():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(size=50))
    xp[10] = xp[11]  # a zero-width interval takes its left value
    fp = rng.standard_normal(50)
    x = rng.uniform(-0.2, 1.2, size=300)
    ours = interp(torch.as_tensor(x), torch.as_tensor(xp),
                  torch.as_tensor(fp)).numpy()
    assert_allclose(ours, np.asarray(jnp.interp(x, xp, fp)), atol=1e-12)


def _cacg_samples(covariance, n, seed):
    """Unit-norm complex Gaussian samples with the given covariance
    (cACG samples)."""
    rng = np.random.default_rng(seed)
    D = covariance.shape[-1]
    L = np.linalg.cholesky(covariance)
    z = (rng.standard_normal((n, D)) + 1j * rng.standard_normal((n, D))) \
        / np.sqrt(2)
    x = z @ L.T
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize('with_saliency', [False, True])
def test_trainer_fit_matches_jax(with_saliency):
    covariance = np.array([[10, 1 + 1j, 1 + 1j], [1 - 1j, 5, 1],
                           [1 - 1j, 1, 2]])
    rng = np.random.default_rng(3)
    x = np.stack([_cacg_samples(covariance, 400, s) for s in range(4)]
                 ).astype(np.complex64)  # (4, 400, 3)
    saliency = rng.uniform(0.2, 1., x.shape[:-1]).astype(np.float32) \
        if with_saliency else None
    ours = ComplexWatsonTrainer().fit(
        torch.as_tensor(x),
        None if saliency is None else torch.as_tensor(saliency))
    theirs = jcw.ComplexWatsonTrainer().fit(
        jnp.asarray(x), None if saliency is None else jnp.asarray(saliency))
    overlap = np.abs(np.einsum('...d,...d->...', ours.mode.numpy().conj(),
                               np.asarray(theirs.mode)))
    assert overlap.min() > 1 - 1e-5
    assert_allclose(ours.concentration.numpy(),
                    np.asarray(theirs.concentration), rtol=1e-4)


def test_mode_recovery():
    """The fitted mode aligns with the dominant eigenvector of the
    scatter."""
    covariance = np.array([[10, 1 + 1j, 1 + 1j], [1 - 1j, 5, 1],
                           [1 - 1j, 1, 2]])
    x = _cacg_samples(covariance, 5000, 0)
    model = ComplexWatsonTrainer().fit(torch.as_tensor(x))
    assert model.mode.shape == (3,) and model.concentration.shape == ()
    scatter = x.T @ x.conj() / len(x)
    _, v = np.linalg.eigh(scatter)
    assert np.abs(model.mode.numpy().conj() @ v[:, -1]) > 0.99


def test_jax_model_carried_across_gives_the_same_log_pdf():
    rng = np.random.default_rng(1)
    mode = rng.standard_normal((5, 2, 4)) + 1j * rng.standard_normal(
        (5, 2, 4))
    mode = (mode / np.linalg.norm(mode, axis=-1, keepdims=True)
            ).astype(np.complex64)
    kappa = rng.uniform(3., 30., (5, 2)).astype(np.float32)
    jax_model = jcw.ComplexWatson(mode=jnp.asarray(mode),
                                  concentration=jnp.asarray(kappa))
    model = ComplexWatson.from_dict(
        jax.tree_util.tree_map(np.asarray, jax_model.to_dict()))
    assert isinstance(model.mode, torch.Tensor)
    y = rng.standard_normal((5, 2, 30, 4)) + 1j * rng.standard_normal(
        (5, 2, 30, 4))
    y = (y / np.linalg.norm(y, axis=-1, keepdims=True)).astype(np.complex64)
    assert_allclose(model.log_pdf(torch.as_tensor(y)).numpy(),
                    np.asarray(jax_model.log_pdf(jnp.asarray(y))),
                    rtol=1e-5, atol=1e-5)
    assert_allclose(model.pdf(torch.as_tensor(y)).numpy(),
                    np.asarray(jax_model.pdf(jnp.asarray(y))), rtol=1e-4)


@pytest.mark.parametrize('D', [3, 6])
def test_hypergeometric_ratio_matches_jax_and_its_inverse(D):
    """The forward ratio equals the JAX package's, and the table inverse
    undoes it inside the grid."""
    kappa = np.array([0.5, 2., 10., 50., 300.])
    ours = ComplexWatsonTrainer(D).hypergeometric_ratio(kappa)
    theirs = np.asarray(jcw.ComplexWatsonTrainer(D).hypergeometric_ratio(
        jnp.asarray(kappa)))
    assert_allclose(ours, theirs, rtol=1e-12)
    back = ComplexWatsonTrainer(D).hypergeometric_ratio_inverse(
        torch.as_tensor(ours))
    assert_allclose(back.numpy(), kappa, rtol=2e-3)
