"""The port's von Mises-Fisher mixture (pb_bss_tpu_torch.models.vmfmm)
against the JAX package's on the same seeded numpy inputs, float64: EM
from the same explicit initialization (with saliency and independent
dimensions), predict of the same model, and the random start recovering
planted directions."""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.vmfmm import (
    VMFMM as JaxVMFMM,
    VMFMMTrainer as JaxTrainer,
)
from pb_bss_tpu_torch.models import VMFMM, VMFMMTrainer

torch.set_num_threads(2)


def _directions(seed, independent=(), N=200, D=3, K=2, kappa=20.0):
    """(..., N, D) float64 points scattered around K random directions
    and a random (..., K, N) initialization."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((K, D))
    means /= np.linalg.norm(means, axis=-1, keepdims=True)
    labels = rng.integers(0, K, size=(*independent, N))
    x = means[labels] + rng.standard_normal((*independent, N, D)) / np.sqrt(
        kappa)
    init = rng.random((*independent, K, N))
    return x, means, labels, init / init.sum(-2, keepdims=True)


@pytest.mark.parametrize('independent', [(), (4,)])
@pytest.mark.parametrize('saliency', [False, True])
def test_fit_from_the_same_initialization_matches_jax(independent, saliency):
    x, _, _, init = _directions(0, independent)
    sal = (np.random.default_rng(1).random(x.shape[:-1]) if saliency
           else None)
    jax_model = JaxTrainer().fit(x, initialization=init, iterations=6,
                                 saliency=sal)
    model = VMFMMTrainer().fit(
        torch.as_tensor(x), initialization=torch.as_tensor(init),
        iterations=6, saliency=None if sal is None else torch.as_tensor(sal))
    # float64 EM through the 512-term log-Bessel series on both sides
    assert_allclose(model.weight.numpy(), np.asarray(jax_model.weight),
                    atol=1e-9)
    assert_allclose(model.vmf.mean.numpy(), np.asarray(jax_model.vmf.mean),
                    atol=1e-9)
    assert_allclose(model.vmf.concentration.numpy(),
                    np.asarray(jax_model.vmf.concentration), rtol=1e-8)
    assert_allclose(model.predict(torch.as_tensor(x)).numpy(),
                    np.asarray(jax_model.predict(x)), atol=1e-9)


def test_predict_of_the_same_model_matches_jax():
    x, means, _, _ = _directions(2, K=3, D=4)
    weight = np.array([[0.2], [0.5], [0.3]])
    concentration = np.array([5.0, 40.0, 300.0])
    jax_model = JaxVMFMM.from_dict({'vmf': {
        'mean': means, 'concentration': concentration}, 'weight': weight})
    model = VMFMM.from_dict({'vmf': {
        'mean': means, 'concentration': concentration}, 'weight': weight})
    assert_allclose(model.predict(torch.as_tensor(x)).numpy(),
                    np.asarray(jax_model.predict(x)), atol=1e-10)


def test_random_start_recovers_the_directions():
    x, means, _, _ = _directions(3, N=1000, kappa=50.0)
    model = VMFMMTrainer().fit(torch.as_tensor(x), num_classes=2,
                               iterations=30)
    est = model.vmf.mean.numpy()
    scores = np.abs(est @ means.T)
    perm = [0, 1] if scores[0, 0] + scores[1, 1] >= \
        scores[0, 1] + scores[1, 0] else [1, 0]
    for k_est, k_true in zip(perm, range(2)):
        assert abs(est[k_est] @ means[k_true]) > 0.99
    assert_allclose(model.weight.numpy().sum(), 1.0, rtol=1e-10)
    aff = VMFMMTrainer().fit_predict(torch.as_tensor(x), num_classes=2,
                                     iterations=3)
    assert aff.shape == (2, 1000)
    with pytest.raises(AssertionError, match='not both'):
        VMFMMTrainer().fit(torch.as_tensor(x))
