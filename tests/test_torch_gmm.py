"""The port's GMM, k-means and BinaryGMM (pb_bss_tpu_torch.models.gmm)
against the JAX package's on the same seeded numpy inputs, float64: EM
fits from the same explicit initialization for every covariance type,
with a fixed covariance and through fit_predict; k-means held by its
partition up to a label permutation on well-separated data; BinaryGMM's
hard assignment and boolean saliency."""
import itertools

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.gmm import (
    BinaryGMM as JaxBinaryGMM,
    BinaryGMMTrainer as JaxBinaryTrainer,
    GMMTrainer as JaxTrainer,
)
from pb_bss_tpu_torch.models import GMM, BinaryGMM
from pb_bss_tpu_torch.models.gmm import BinaryGMMTrainer, GMMTrainer, kmeans

torch.set_num_threads(2)


def _clusters(seed, independent=(), N=300, D=2, K=2, spread=0.5):
    """(..., N, D) float64 points around K separated centers, the
    labels and a random (..., K, N) initialization."""
    rng = np.random.default_rng(seed)
    centers = 4 * rng.standard_normal((K, D))
    labels = rng.integers(0, K, size=(*independent, N))
    x = centers[labels] + spread * rng.standard_normal((*independent, N, D))
    init = rng.random((*independent, K, N))
    return x, labels, init / init.sum(-2, keepdims=True)


def _same_partition(a, b):
    """True when two label vectors agree up to a relabeling."""
    K = int(max(a.max(), b.max())) + 1
    return any(np.array_equal(np.asarray(p)[a], b)
               for p in itertools.permutations(range(K)))


@pytest.mark.parametrize('covariance_type', ['full', 'diagonal', 'spherical'])
@pytest.mark.parametrize('independent', [(), (3,)])
def test_fit_from_the_same_initialization_matches_jax(covariance_type,
                                                      independent):
    x, _, init = _clusters(0, independent)
    jax_model = JaxTrainer().fit(x, initialization=init, iterations=8,
                                 covariance_type=covariance_type)
    model = GMMTrainer().fit(torch.as_tensor(x),
                             initialization=torch.as_tensor(init),
                             iterations=8, covariance_type=covariance_type)
    # float64 EM, 8 iterations: the two packages' rounding only
    assert_allclose(model.weight.numpy(), np.asarray(jax_model.weight),
                    atol=1e-10)
    assert_allclose(model.gaussian.mean.numpy(),
                    np.asarray(jax_model.gaussian.mean), atol=1e-9)
    assert_allclose(model.gaussian.covariance.numpy(),
                    np.asarray(jax_model.gaussian.covariance), atol=1e-9)
    assert_allclose(model.predict(torch.as_tensor(x)).numpy(),
                    np.asarray(jax_model.predict(x)), atol=1e-9)


def test_fixed_covariance_and_weight_axes_match_jax():
    x, _, init = _clusters(1)
    fixed = np.tile(0.3 * np.eye(2), (2, 1, 1))
    jax_aff = JaxTrainer().fit_predict(x, initialization=init, iterations=5,
                                       fixed_covariance=fixed)
    aff = GMMTrainer().fit_predict(torch.as_tensor(x),
                                   initialization=torch.as_tensor(init),
                                   iterations=5,
                                   fixed_covariance=torch.as_tensor(fixed))
    assert_allclose(aff.numpy(), np.asarray(jax_aff), atol=1e-10)
    model = GMMTrainer().fit(torch.as_tensor(x),
                             initialization=torch.as_tensor(init),
                             iterations=3, fixed_covariance=fixed)
    assert_allclose(model.gaussian.covariance.numpy(), fixed)
    with pytest.raises(AssertionError):
        GMMTrainer().fit(torch.as_tensor(x), iterations=2, num_classes=2,
                         fixed_covariance=np.eye(3))


def _two_cluster_data(samples=1000, seed=0):
    """The JAX tests' two Gaussian clusters (weights 0.3 / 0.7)."""
    rng = np.random.RandomState(seed)
    labels = rng.choice(2, size=(samples,), p=np.array([0.3, 0.7]))
    mean = np.array([[-1.0, -1.0], [1.0, 1.0]])
    x = np.zeros((samples, 2))
    for k in range(2):
        x[labels == k] = rng.multivariate_normal(
            mean[k], 0.25 * np.eye(2), size=(np.sum(labels == k),))
    return x, labels, mean


def test_random_initialization_is_seeded_and_recovers_the_clusters():
    """The JAX test's recovery at the default 100 iterations from the
    default random start (a generator seeded 0)."""
    x, labels, mean = _two_cluster_data()
    x = torch.as_tensor(x)
    a = GMMTrainer().fit(x, num_classes=2)
    b = GMMTrainer().fit(x, num_classes=2,
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.gaussian.mean, b.gaussian.mean)
    est = a.gaussian.mean.numpy()
    p = min(itertools.permutations(range(2)),
            key=lambda p: np.sum((est[list(p)] - mean) ** 2))
    assert_allclose(est[list(p)], mean, atol=0.2)
    assert_allclose(a.gaussian.covariance.numpy()[list(p)],
                    np.tile(0.25 * np.eye(2), (2, 1, 1)), atol=0.2)
    with pytest.raises(AssertionError, match='not both'):
        GMMTrainer().fit(x, num_classes=2,
                         initialization=np.ones((2, 1000)))


@pytest.mark.parametrize('K,D', [(2, 2), (3, 4), (4, 3)])
def test_kmeans_partition_matches_jax(K, D):
    """Well-separated clusters: both packages' k-means find the planted
    partition (their random first centers differ, the partition does
    not)."""
    x, labels, _ = _clusters(3 + K, N=400, D=D, K=K, spread=0.2)
    centers = kmeans(torch.as_tensor(x), K)
    jax_centers = np.asarray(JaxBinaryTrainer().fit(x, K).means)
    ours = BinaryGMM(means=centers).predict(torch.as_tensor(x))
    theirs = np.asarray(JaxBinaryGMM(means=jax_centers).predict(x))
    assert _same_partition(ours.numpy().argmax(0), labels)
    assert _same_partition(ours.numpy().argmax(0), theirs.argmax(0))


def test_binary_gmm_predict_matches_jax_on_the_same_means():
    x, _, _ = _clusters(4, N=200, D=3, K=3)
    means = np.random.default_rng(5).standard_normal((3, 3))
    ours = BinaryGMM(means=torch.as_tensor(means)).predict(torch.as_tensor(x))
    assert_allclose(ours.numpy(), np.asarray(JaxBinaryGMM(means=means)
                                             .predict(x)))
    assert_allclose(ours.numpy().sum(0), 1.0)


def test_binary_gmm_trainer_saliency_excludes_points():
    x, labels, _ = _clusters(6, N=300, K=2, spread=0.2)
    outliers = np.full((20, 2), 50.0)
    x_all = np.concatenate([x, outliers])
    saliency = np.concatenate([np.ones(300, bool), np.zeros(20, bool)])
    model = BinaryGMMTrainer().fit(torch.as_tensor(x_all), 2,
                                   saliency=saliency)
    assert np.abs(model.means.numpy()).max() < 20
    assert _same_partition(
        model.predict(torch.as_tensor(x)).numpy().argmax(0), labels)
    with pytest.raises(AssertionError, match='boolean'):
        BinaryGMMTrainer().fit(torch.as_tensor(x_all), 2,
                               saliency=saliency.astype(float))


def test_gmm_dict_round_trip():
    x, _, init = _clusters(7)
    model = GMMTrainer().fit(torch.as_tensor(x),
                             initialization=torch.as_tensor(init),
                             iterations=2)
    back = GMM.from_dict({'weight': model.weight.numpy(), 'gaussian': {
        k: v.numpy() for k, v in model.gaussian.to_dict().items()}})
    assert torch.equal(back.gaussian.covariance, model.gaussian.covariance)
