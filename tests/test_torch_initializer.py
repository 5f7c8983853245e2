"""The port's iid affiliation initializers (pb_bss_tpu_torch.initializer.
iid) against the JAX package's: shapes, normalization over the classes,
permutation-free broadcasting, the generator's reproducibility, and the
draws held by their moments against the distributions' (and the JAX
draws')."""
import doctest

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.initializer import iid as jax_iid
from pb_bss_tpu_torch.initializer import iid

torch.set_num_threads(2)

FUNCTIONS = ['uniform_normalized', 'dirichlet_uniform', 'one_hot']
Y = np.ones([4, 5, 3])


@pytest.mark.parametrize('name', FUNCTIONS)
@pytest.mark.parametrize('permutation_free', [False, True])
def test_shapes_normalization_and_broadcast(name, permutation_free):
    ours = getattr(iid, name)(Y, 2, permutation_free=permutation_free)
    theirs = np.asarray(getattr(jax_iid, name)(
        Y, 2, permutation_free=permutation_free))
    assert ours.shape == theirs.shape == (4, 2, 5)
    assert ours.dtype == torch.float64  # Y's real dtype, as the JAX side
    assert_allclose(ours.sum(-2).numpy(), 1.0, rtol=1e-12)
    if permutation_free:
        for f in range(1, 4):
            assert torch.equal(ours[f], ours[0])


@pytest.mark.parametrize('name', FUNCTIONS)
def test_generator_reproducibility(name):
    fn = getattr(iid, name)
    Yt = torch.zeros((6, 30, 2), dtype=torch.complex64)
    a = fn(Yt, 3, generator=torch.Generator().manual_seed(1))
    b = fn(Yt, 3, generator=torch.Generator().manual_seed(1))
    c = fn(Yt, 3, generator=torch.Generator().manual_seed(2))
    assert a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(fn(Yt, 3), fn(Yt, 3, generator=torch.Generator()
                                     .manual_seed(0)))


@pytest.mark.parametrize('alpha', [0.3, 1, 10])
def test_dirichlet_moments(alpha):
    """Mean 1/K and variance (1/K)(1 - 1/K) / (K alpha + 1) per class
    over 40,000 draws, beside the JAX sampler's."""
    K, N = 3, 40000
    Yn = np.zeros((1, N, 2))
    ours = iid.dirichlet(Yn, K, alpha=alpha)[0].numpy()
    theirs = np.asarray(jax_iid.dirichlet(Yn, K, alpha=alpha,
                                          key=jax.random.key(3)))[0]
    mean = 1 / K
    var = mean * (1 - mean) / (K * alpha + 1)
    for draws in (ours, theirs):
        assert_allclose(draws.mean(-1), mean, atol=4 * np.sqrt(var / N))
        assert_allclose(draws.var(-1), var, rtol=0.05)
    assert (ours > 0).all()


def test_one_hot_is_hard_and_uniform():
    ours = iid.one_hot(np.zeros((1, 30000, 2)), 3)[0].numpy()
    assert set(np.unique(ours)) <= {0.0, 1.0}
    assert_allclose(ours.mean(-1), 1 / 3, atol=0.01)


def test_uniform_normalized_moments():
    """Each class's share of two uniforms: mean 1/2, as the JAX draws."""
    ours = iid.uniform_normalized(np.zeros((1, 40000, 2)), 2)[0].numpy()
    theirs = np.asarray(jax_iid.uniform_normalized(
        np.zeros((1, 40000, 2)), 2, key=jax.random.key(4)))[0]
    assert_allclose(ours.mean(-1), 0.5, atol=0.005)
    assert_allclose(ours.var(-1), theirs.var(-1), rtol=0.05)


def test_doctests():
    result = doctest.testmod(iid)
    assert result.attempted > 0 and result.failed == 0, result
