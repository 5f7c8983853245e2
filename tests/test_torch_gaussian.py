"""The port's real Gaussians (pb_bss_tpu_torch.models.gaussian: full,
diagonal and spherical covariance) against the JAX package's on the same
numpy inputs: the weighted ML fit with and without saliency and the
log-pdf, in float64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.gaussian import GaussianTrainer as JaxTrainer
from pb_bss_tpu_torch.models.gaussian import (
    DiagonalGaussian,
    Gaussian,
    GaussianTrainer,
    SphericalGaussian,
)

TYPES = {'full': Gaussian, 'diagonal': DiagonalGaussian,
         'spherical': SphericalGaussian}


def _data(seed=0, batch=(2,), N=200, D=5):
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((*batch, D, D)) * 0.5 + np.eye(D)
    y = np.einsum('...de,...ne->...nd', mix,
                  rng.standard_normal((*batch, N, D))) + 1.5
    return y, rng.uniform(0.1, 1.0, (*batch, 3, N))


@pytest.mark.parametrize('covariance_type', list(TYPES))
@pytest.mark.parametrize('saliency', [False, True])
def test_fit_and_log_pdf_match_jax(covariance_type, saliency):
    y, sal = _data()
    # three classes share the observations, each with its own saliency
    y3 = y[..., None, :, :]
    sal = sal if saliency else None
    ours = GaussianTrainer().fit(
        torch.as_tensor(y3), None if sal is None else torch.as_tensor(sal),
        covariance_type=covariance_type)
    theirs = JaxTrainer().fit(
        jnp.asarray(y3), None if sal is None else jnp.asarray(sal),
        covariance_type=covariance_type)
    assert isinstance(ours, TYPES[covariance_type])
    assert_allclose(ours.mean.numpy(), np.asarray(theirs.mean), rtol=1e-12)
    assert_allclose(ours.covariance.numpy(), np.asarray(theirs.covariance),
                    rtol=1e-11)
    points = np.random.default_rng(3).standard_normal((2, 1, 40, 5)) + 1.
    assert_allclose(ours.log_pdf(torch.as_tensor(points)).numpy(),
                    np.asarray(theirs.log_pdf(jnp.asarray(points))),
                    rtol=1e-11, atol=1e-10)


def test_full_precision_cholesky_matches_jax():
    y, _ = _data(seed=4, batch=())
    ours = GaussianTrainer().fit(torch.as_tensor(y))
    theirs = JaxTrainer().fit(jnp.asarray(y))
    assert_allclose(ours.precision_cholesky.numpy(),
                    np.asarray(theirs.precision_cholesky), rtol=1e-10,
                    atol=1e-12)
    assert_allclose(ours.log_det_precision_cholesky.numpy(),
                    np.asarray(theirs.log_det_precision_cholesky), rtol=1e-12)
    # P P^T is the precision
    p = ours.precision_cholesky.numpy()
    assert_allclose(p @ p.T, np.linalg.inv(ours.covariance.numpy()),
                    rtol=1e-9, atol=1e-12)


def test_unknown_covariance_type_raises():
    y, _ = _data(batch=())
    with pytest.raises(ValueError, match='Unknown covariance type'):
        GaussianTrainer().fit(torch.as_tensor(y), covariance_type='tied')
