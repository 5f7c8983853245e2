"""The port's von Mises-Fisher distribution (pb_bss_tpu_torch.models.
von_mises_fisher) against the JAX package's and scipy on the same numpy
inputs: ``log_ive`` (the 512-term log-domain series), the log normalizer,
the log-pdf and the closed-form trainer, in float64 (float32 where
stated)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from scipy.special import ive

from pb_bss_tpu.models.von_mises_fisher import (
    VonMisesFisher as JaxVonMisesFisher,
    VonMisesFisherTrainer as JaxTrainer,
    log_ive as jax_log_ive,
)
from pb_bss_tpu_torch.models.von_mises_fisher import (
    VonMisesFisher,
    VonMisesFisherTrainer,
    log_ive,
)

KAPPA = np.concatenate([np.logspace(-10, np.log10(500), 200),
                        np.linspace(1e-3, 500, 200)])


@pytest.mark.parametrize('E', [2, 6, 20])
def test_log_ive_matches_scipy_and_jax(E):
    nu = E / 2 - 1
    ours = log_ive(nu, torch.as_tensor(KAPPA)).numpy()
    # float64: the series against scipy to ~1e-12 relative
    assert_allclose(ours, np.log(ive(nu, KAPPA)), rtol=1e-11, atol=1e-11)
    assert_allclose(ours, np.asarray(jax_log_ive(nu, jnp.asarray(KAPPA))),
                    rtol=1e-13, atol=1e-12)


def test_log_ive_float32_matches_jax():
    kappa = KAPPA.astype(np.float32)
    ours = log_ive(9, torch.as_tensor(kappa))
    assert ours.dtype == torch.float32
    # float32 logsumexp over 512 terms in two orders, less kappa: a few
    # ulps of kappa (<= 500, ulp 3e-5) at the top of the range
    assert_allclose(ours.numpy(),
                    np.asarray(jax_log_ive(9, jnp.asarray(kappa))),
                    rtol=2e-6, atol=3e-4)


def _model(E, seed=0):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal((3, E))
    mean /= np.linalg.norm(mean, axis=-1, keepdims=True)
    concentration = rng.uniform(1e-3, 400, 3)
    return mean, concentration


@pytest.mark.parametrize('E', [2, 6, 20])
def test_log_norm_and_log_pdf_match_jax(E):
    mean, concentration = _model(E)
    ours = VonMisesFisher(mean=torch.as_tensor(mean),
                          concentration=torch.as_tensor(concentration))
    theirs = JaxVonMisesFisher(mean=jnp.asarray(mean),
                               concentration=jnp.asarray(concentration))
    assert_allclose(ours.log_norm().numpy(), np.asarray(theirs.log_norm()),
                    rtol=1e-12)
    assert_allclose(ours.norm().numpy(), np.asarray(theirs.norm()),
                    rtol=1e-10)
    y = np.random.default_rng(1).standard_normal((3, 50, E))
    assert_allclose(ours.log_pdf(torch.as_tensor(y)).numpy(),
                    np.asarray(theirs.log_pdf(jnp.asarray(y))), rtol=1e-11,
                    atol=1e-9)
    assert_allclose(ours.pdf(torch.as_tensor(y)).numpy(),
                    np.asarray(theirs.pdf(jnp.asarray(y))), rtol=1e-9)


def test_sample_is_not_implemented():
    mean, concentration = _model(6)
    with pytest.raises(NotImplementedError, match='libdirectional'):
        VonMisesFisher(mean=torch.as_tensor(mean),
                       concentration=torch.as_tensor(concentration)).sample(3)


@pytest.mark.parametrize('saliency', [False, True])
def test_trainer_matches_jax(saliency):
    rng = np.random.default_rng(2)
    mu = rng.standard_normal((2, 1, 6))
    y = mu + 0.4 * rng.standard_normal((2, 300, 6))
    sal = rng.uniform(size=(2, 300)) if saliency else None
    ours = VonMisesFisherTrainer().fit(
        torch.as_tensor(y), None if sal is None else torch.as_tensor(sal))
    theirs = JaxTrainer().fit(jnp.asarray(y),
                              None if sal is None else jnp.asarray(sal))
    assert_allclose(ours.mean.numpy(), np.asarray(theirs.mean), rtol=1e-12,
                    atol=1e-14)
    assert_allclose(ours.concentration.numpy(),
                    np.asarray(theirs.concentration), rtol=1e-11)
    # the fitted mean points along the planted direction
    cos = np.einsum('bd,bd->b', ours.mean.numpy(), mu[:, 0]) \
        / np.linalg.norm(mu[:, 0], axis=-1)
    assert (cos > 0.9).all(), cos


def test_trainer_clips_the_concentration():
    y = np.tile(np.eye(4)[:1], (50, 1))  # all frames equal: r_bar = 1
    ours = VonMisesFisherTrainer().fit(torch.as_tensor(y),
                                       max_concentration=123.)
    theirs = JaxTrainer().fit(jnp.asarray(y), max_concentration=123.)
    assert float(ours.concentration) == float(theirs.concentration) == 123.
