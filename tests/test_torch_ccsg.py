"""The port's complex circular-symmetric Gaussian (pb_bss_tpu_torch.
models.complex_circular_symmetric_gaussian) against the JAX package's on
the same seeded numpy inputs: the log-pdf (complex128 and complex64),
the weighted trainer, and the sampler held by its moments."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.complex_circular_symmetric_gaussian import (
    ComplexCircularSymmetricGaussian as JaxCCSG,
    ComplexCircularSymmetricGaussianTrainer as JaxTrainer,
)
from pb_bss_tpu_torch.models import (
    ComplexCircularSymmetricGaussian,
    ComplexCircularSymmetricGaussianTrainer,
)

torch.set_num_threads(2)


def _covariance(rng, *batch, D=3):
    a = rng.standard_normal((*batch, D, D)) + 1j * rng.standard_normal(
        (*batch, D, D))
    return a @ np.conj(np.swapaxes(a, -1, -2)) + 0.5 * np.eye(D)


def _observations(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize('dtype,atol', [(np.complex128, 1e-10),
                                        (np.complex64, 2e-4)])
@pytest.mark.parametrize('batch', [(), (4,)])
def test_log_pdf_matches_jax(dtype, atol, batch):
    rng = np.random.default_rng(0)
    cov = _covariance(rng, *batch).astype(dtype)
    y = _observations(rng, *batch, 50, 3).astype(dtype)
    ours = ComplexCircularSymmetricGaussian(
        covariance=torch.as_tensor(cov)).log_pdf(torch.as_tensor(y))
    theirs = JaxCCSG(covariance=jnp.asarray(cov)).log_pdf(jnp.asarray(y))
    assert ours.shape == (*batch, 50)
    # complex64: an LU solve and a log-determinant in f32 on each side
    assert_allclose(ours.numpy(), np.asarray(theirs), atol=atol, rtol=atol)


@pytest.mark.parametrize('saliency', [False, True])
def test_trainer_matches_jax(saliency):
    rng = np.random.default_rng(1)
    y = _observations(rng, 5, 80, 3)
    sal = rng.random((5, 80)) if saliency else None
    ours = ComplexCircularSymmetricGaussianTrainer().fit(
        torch.as_tensor(y), None if sal is None else torch.as_tensor(sal))
    theirs = JaxTrainer().fit(jnp.asarray(y), sal)
    assert_allclose(ours.covariance.numpy(), np.asarray(theirs.covariance),
                    atol=1e-12)
    assert_allclose(ours.covariance.numpy(),
                    np.conj(np.swapaxes(ours.covariance.numpy(), -1, -2)))


def test_sampler_moments():
    """The sample covariance of 40,000 draws against the model's (the
    standard error of an entry is ~|Sigma| / sqrt(N) ~ 0.5%), the
    generator's draws reproducible, and the JAX sampler's draws of the
    same model alike in their moments."""
    rng = np.random.default_rng(2)
    cov = _covariance(rng)
    model = ComplexCircularSymmetricGaussian(covariance=torch.as_tensor(cov))
    x = model.sample(40000, generator=torch.Generator().manual_seed(3))
    assert x.shape == (40000, 3) and x.dtype == torch.complex128
    scale = np.abs(cov).max()
    sample_cov = (x.T @ x.conj()).numpy() / len(x)
    assert_allclose(sample_cov, cov, atol=0.03 * scale)
    assert_allclose(x.mean(0).abs().numpy(), 0, atol=0.03 * np.sqrt(scale))
    again = model.sample((40000,), generator=torch.Generator().manual_seed(3))
    assert torch.equal(x, again)
    jax_x = np.asarray(JaxCCSG(covariance=jnp.asarray(cov)).sample(40000))
    assert_allclose(jax_x.T @ np.conj(jax_x) / len(jax_x), sample_cov,
                    atol=0.05 * scale)
    with pytest.raises(AssertionError, match='batched'):
        ComplexCircularSymmetricGaussian(
            covariance=torch.as_tensor(_covariance(rng, 2))).sample(3)
