"""The port's GCACGMM / GCACGMMTrainer against the JAX package's on the
same numpy inputs and initialization: the weight-shape sweep of every
weight_constant_axis (tests/test_models/test_integration_models.py), the
three covariance types and fixed_covariance, separation, the inline
K!-permutation alignment, the per-iteration kernel route ('step', its
plain twin here) against the scan at the JAX suite's tolerances
(tests/test_ops/test_pallas_integration_em.py), saliency, the batched fold
and the polymorphic ``gaussian`` of from_dict."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.gcacgmm import GCACGMMTrainer as JaxTrainer
from pb_bss_tpu_torch.models import (
    GCACGMM,
    DiagonalGaussian,
    Gaussian,
    GCACGMMTrainer,
    SphericalGaussian,
)
from test_torch_vmfcacgmm import (
    _j,
    _problem,
    _t,
    decision_accuracy,
    separable_data,
)

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def data():
    rng = np.random.RandomState(0)
    obs = (rng.normal(size=(15, 100, 3))
           + 1j * rng.normal(size=(15, 100, 3))).astype(np.complex64)
    emb = rng.normal(size=(15, 100, 10)).astype(np.float32)
    init = rng.uniform(size=(15, 2, 100)).astype(np.float32)
    return obs, emb, init / init.sum(1, keepdims=True)


@pytest.mark.parametrize('weight_constant_axis,shape', [
    ((-3, -2, -1), ()), ((-3, -1), (2,)), ((-1,), (15, 2)),
    ((-3,), (2, 100))])
def test_weight_shapes_match_jax(data, weight_constant_axis, shape):
    obs, emb, init = data
    kw = dict(iterations=3, weight_constant_axis=weight_constant_axis)
    model = GCACGMMTrainer().fit(*_t(obs, emb),
                                 initialization=torch.as_tensor(init), **kw)
    assert tuple(model.weight.shape) == shape
    ref = JaxTrainer().fit(*_j(obs, emb), initialization=jnp.asarray(init),
                           **kw)
    assert_allclose(model.weight.numpy(), np.asarray(ref.weight), atol=1e-4)


@pytest.mark.parametrize('covariance_type,shape', [
    ('spherical', (2,)), ('diagonal', (2, 10)), ('full', (2, 10, 10))])
def test_covariance_types_match_jax(data, covariance_type, shape):
    obs, emb, init = data
    kw = dict(iterations=2, covariance_type=covariance_type)
    model = GCACGMMTrainer().fit(*_t(obs, emb),
                                 initialization=torch.as_tensor(init), **kw)
    assert tuple(model.gaussian.covariance.shape) == shape
    ref = JaxTrainer().fit(*_j(obs, emb), initialization=jnp.asarray(init),
                           **kw)
    assert_allclose(model.gaussian.mean.numpy(),
                    np.asarray(ref.gaussian.mean), atol=1e-5)
    assert_allclose(model.gaussian.covariance.numpy(),
                    np.asarray(ref.gaussian.covariance), rtol=1e-4,
                    atol=1e-6)
    assert_allclose(model.predict(*_t(obs, emb)).numpy(),
                    np.asarray(ref.predict(*_j(obs, emb))), atol=1e-3)


@pytest.mark.parametrize('fused', [False, True])
def test_fixed_covariance(data, fused):
    obs, emb, init = data
    fixed = np.ones((2,), np.float32)
    kw = dict(iterations=3, covariance_type='spherical')
    model = GCACGMMTrainer().fit(
        *_t(obs, emb), initialization=torch.as_tensor(init),
        fixed_covariance=torch.as_tensor(fixed), use_fused_em=fused, **kw)
    assert_allclose(model.gaussian.covariance.numpy(), fixed)
    ref = JaxTrainer().fit(*_j(obs, emb), initialization=jnp.asarray(init),
                           fixed_covariance=jnp.asarray(fixed), **kw)
    assert_allclose(model.gaussian.mean.numpy(),
                    np.asarray(ref.gaussian.mean), atol=1e-4)


def test_separates_as_jax_does():
    obs, emb, active, init = separable_data()
    model = GCACGMMTrainer().fit(*_t(obs, emb),
                                 initialization=torch.as_tensor(init),
                                 iterations=20)
    ours = decision_accuracy(model.predict(*_t(obs, emb)), active)
    ref = JaxTrainer().fit(*_j(obs, emb), initialization=jnp.asarray(init),
                           iterations=20)
    theirs = decision_accuracy(ref.predict(*_j(obs, emb)), active)
    assert ours.min() > 0.9, ours
    assert_allclose(ours, theirs, atol=0.02)


def test_inline_permutation_alignment_matches_jax():
    obs, emb, _, init = separable_data(seed=2)
    kw = dict(iterations=5, inline_permutation_alignment=True)
    model = GCACGMMTrainer().fit(*_t(obs, emb),
                                 initialization=torch.as_tensor(init), **kw)
    aff = model.predict(*_t(obs, emb)).numpy()
    assert aff.shape == (8, 2, 120)
    assert_allclose(aff.sum(1), 1.0, rtol=1e-5)
    ref = JaxTrainer().fit(*_j(obs, emb), initialization=jnp.asarray(init),
                           **kw)
    assert np.abs(aff - np.asarray(ref.predict(*_j(obs, emb)))).mean() < 1e-3


def _assert_step_matches_scan(m_f, m_s):
    """The JAX suite's fused-vs-scan tolerances."""
    assert_allclose(np.asarray(m_f.weight, np.float64),
                    np.asarray(m_s.weight, np.float64), atol=1e-4)
    assert_allclose(np.asarray(m_f.cacg.covariance_eigenvalues, np.float64),
                    np.asarray(m_s.cacg.covariance_eigenvalues, np.float64),
                    atol=1e-3)
    assert_allclose(np.asarray(m_f.gaussian.mean, np.float64),
                    np.asarray(m_s.gaussian.mean, np.float64), atol=1e-4)
    assert_allclose(np.asarray(m_f.gaussian.covariance, np.float64),
                    np.asarray(m_s.gaussian.covariance, np.float64),
                    rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize('covariance_type', ['spherical', 'diagonal'])
@pytest.mark.parametrize('saliency', [False, True])
def test_step_route_matches_the_scan(covariance_type, saliency):
    obs, emb, init = _problem(F=9, T=32)
    emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    sal = (np.random.default_rng(8).uniform(0.3, 1.0, (9, 32)).astype(
        np.float32) if saliency else None)
    kw = dict(iterations=4, covariance_type=covariance_type)
    port = dict(initialization=torch.as_tensor(init),
                saliency=None if sal is None else torch.as_tensor(sal), **kw)
    m_f = GCACGMMTrainer().fit(*_t(obs, emb), use_fused_em=True, **port)
    m_s = GCACGMMTrainer().fit(*_t(obs, emb), use_fused_em=False, **port)
    m_j = JaxTrainer().fit(*_j(obs, emb), initialization=jnp.asarray(init),
                           saliency=None if sal is None else jnp.asarray(sal),
                           use_fused_em=False, **kw)
    _assert_step_matches_scan(m_f, m_s)
    _assert_step_matches_scan(m_f, m_j)
    aff = m_f.predict(*_t(obs, emb)).numpy()
    assert_allclose(aff, m_s.predict(*_t(obs, emb)).numpy(), atol=2e-2)


def test_batched_fit_folds_into_bins():
    rng = np.random.default_rng(5)
    B, F, T, D, E, K = 2, 9, 32, 3, 6, 2
    obs = (rng.standard_normal((B, F, T, D))
           + 1j * rng.standard_normal((B, F, T, D))).astype(np.complex64)
    obs /= np.linalg.norm(obs, axis=-1, keepdims=True)
    emb = rng.standard_normal((B, F, T, E)).astype(np.float32)
    init = rng.uniform(size=(B, F, K, T)).astype(np.float32)
    init /= init.sum(-2, keepdims=True)
    kw = dict(iterations=3, covariance_type='spherical')
    m4 = GCACGMMTrainer().fit(*_t(obs, emb),
                              initialization=torch.as_tensor(init),
                              use_fused_em=True, **kw)
    assert m4.weight.shape == (B, F, K)
    assert m4.gaussian.covariance.shape == (B, K)
    ref = JaxTrainer().fit(*_j(obs, emb), initialization=jnp.asarray(init),
                           use_fused_em=False, **kw)
    assert_allclose(m4.weight.numpy(), np.asarray(ref.weight), atol=1e-4)
    for b in range(B):
        m3 = GCACGMMTrainer().fit(*_t(obs[b], emb[b]),
                                  initialization=torch.as_tensor(init[b]),
                                  use_fused_em=True, **kw)
        assert_allclose(m4.weight[b].numpy(), m3.weight.numpy(), atol=1e-6)


@pytest.mark.parametrize('covariance_type,cls', [
    ('spherical', SphericalGaussian), ('diagonal', DiagonalGaussian),
    ('full', Gaussian)])
def test_from_dict_restores_the_polymorphic_gaussian(data, covariance_type,
                                                      cls):
    """A JAX model's to_dict() loads in the port with the Gaussian variant
    identified by its covariance rank; its posterior is the JAX model's,
    and a fit started from it follows the JAX fit."""
    obs, emb, init = data
    ref = JaxTrainer().fit(*_j(obs, emb), initialization=jnp.asarray(init),
                           iterations=2, covariance_type=covariance_type)

    def to_numpy(d):
        return {k: to_numpy(v) if isinstance(v, dict)
                else np.asarray(v) if hasattr(v, 'shape') else v
                for k, v in d.items()}
    model = GCACGMM.from_dict(to_numpy(ref.to_dict()))
    assert isinstance(model.gaussian, cls)
    aff = model.predict(*_t(obs, emb))
    ref_aff = ref.predict(*_j(obs, emb))
    assert_allclose(aff.numpy(), np.asarray(ref_aff), atol=1e-4)
    ours = GCACGMMTrainer().fit(*_t(obs, emb), initialization=aff,
                                iterations=2, covariance_type=covariance_type)
    theirs = JaxTrainer().fit(*_j(obs, emb), initialization=ref_aff,
                              iterations=2, covariance_type=covariance_type)
    assert_allclose(ours.weight.numpy(), np.asarray(theirs.weight),
                    atol=1e-3)
