"""The complex Bingham mixture model of the port (pb_bss_tpu_torch.models.
cbmm, scan path) against the JAX package on the same numpy inputs
(complex64 / float32 on both sides).

Posteriors are exponentially sensitive to small differences in the
fitted Bingham eigenvalues, and the moment inversion's iterates part by
f32 rounding in saturated directions, so fits are held as the JAX suite
holds its kernel against its scan path (tests/test_ops/
test_pallas_cbmm_loop.py): tight on the weights, eigenvalues at rtol
5e-2 / atol 0.5, posteriors loose elementwise and tight on average."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models import complex_bingham as jcb
from pb_bss_tpu.models.cbmm import CBMM as JaxCBMM
from pb_bss_tpu.models.cbmm import CBMMTrainer as JaxTrainer
from pb_bss_tpu.permutation_alignment import (
    GreedyPermutationAlignment as JaxGreedy,
)
from pb_bss_tpu_torch.models.cbmm import CBMM, CBMMTrainer
from pb_bss_tpu_torch.models.complex_bingham import ComplexBingham
from pb_bss_tpu_torch.permutation_alignment import (
    GreedyPermutationAlignment,
)

torch.set_num_threads(2)

F, T, D, K = 5, 48, 4, 2


def _mixture(seed=0, noise=0.2):
    """(F, T, D) unit-norm observations around K planted axes per bin,
    a random global phase per frame (irrelevant to the Bingham model),
    and a random (F, K, T) initial affiliation."""
    rng = np.random.default_rng(seed)
    modes = rng.standard_normal((F, K, D)) + 1j * rng.standard_normal(
        (F, K, D))
    lab = np.arange(T) % K
    y = modes[:, lab] + noise * (rng.standard_normal((F, T, D))
                                 + 1j * rng.standard_normal((F, T, D)))
    y *= np.exp(2j * np.pi * rng.uniform(size=(F, T, 1)))
    y /= np.linalg.norm(y, axis=-1, keepdims=True)
    aff = rng.uniform(size=(F, K, T))
    aff /= aff.sum(1, keepdims=True)
    return y.astype(np.complex64), aff.astype(np.float32)


def _convert(kwargs, to):
    return {k: (to(v) if isinstance(v, np.ndarray) else v)
            for k, v in kwargs.items()}


def _fit_both(y, aff, iterations, jax_extra=None, **kwargs):
    """The scan-path fit in both packages; ``jax_extra`` overrides knobs
    on the JAX side (its own aligner objects)."""
    theirs = JaxTrainer().fit(
        jnp.asarray(y), initialization=jnp.asarray(aff),
        iterations=iterations, use_fused_em=False,
        **_convert({**kwargs, **(jax_extra or {})}, jnp.asarray))
    ours = CBMMTrainer().fit(
        torch.as_tensor(y), initialization=torch.as_tensor(aff),
        iterations=iterations, use_fused_em=False,
        **_convert(kwargs, torch.as_tensor))
    return ours, theirs


def _assert_models_close(ours, theirs, y, *, weight=5e-3, posterior=True):
    assert_allclose(ours.weight.numpy(), np.asarray(theirs.weight),
                    atol=weight)
    assert_allclose(ours.complex_bingham.covariance_eigenvalues.numpy(),
                    np.asarray(theirs.complex_bingham.covariance_eigenvalues),
                    rtol=5e-2, atol=0.5)
    if posterior:
        d = np.abs(ours.predict(torch.as_tensor(y)).numpy()
                   - np.asarray(theirs.predict(jnp.asarray(y))))
        assert d.mean() < 5e-3 and d.max() < 0.2, (d.mean(), d.max())


@pytest.mark.parametrize('knobs', [
    dict(), dict(weight_constant_axis=(-3, -1)), dict(saliency=True)],
    ids=['per_bin', 'fc', 'saliency'])
def test_one_m_step_matches_jax(knobs):
    """One M-step from the same affiliations: the weights to 1e-6 (sums
    in another order); the moment inversion's cold solve as in
    test_torch_complex_bingham."""
    knobs = dict(knobs)
    y, aff = _mixture(seed=1)
    if knobs.pop('saliency', False):
        knobs['saliency'] = np.random.default_rng(2).uniform(
            0.2, 1., y.shape[:-1]).astype(np.float32)
    ours, theirs = _fit_both(y, aff, 1, **knobs)
    _assert_models_close(ours, theirs, y, weight=1e-6)
    # the eigenvectors carry a phase per column: compare covariances
    ev = np.asarray(theirs.complex_bingham.covariance_eigenvalues)
    assert_allclose(ours.complex_bingham.covariance.numpy(),
                    np.asarray(theirs.complex_bingham.covariance),
                    atol=5e-2 * (1 + np.abs(ev).max()))


@pytest.mark.parametrize('affiliation_eps', [0., 1e-3])
def test_one_e_step_on_a_fixed_model_matches_jax(affiliation_eps):
    """CBMM.predict of the same model, with the posterior clip: the
    quadratic form and the cascade's log norm in two frameworks,
    1e-5."""
    y, _ = _mixture(seed=3)
    rng = np.random.default_rng(4)
    vec = np.linalg.qr(rng.standard_normal((F, K, D, D))
                       + 1j * rng.standard_normal((F, K, D, D)))[0]
    lam = -np.sort(rng.uniform(0., 30., (F, K, D)), -1)[..., ::-1].copy()
    lam[..., -1] = 0.
    weight = rng.uniform(0.2, 1., (F, K, 1))
    weight /= weight.sum(1, keepdims=True)
    vec, lam, weight = (vec.astype(np.complex64), lam.astype(np.float32),
                        weight.astype(np.float32))
    ours = CBMM(weight=torch.as_tensor(weight),
                complex_bingham=ComplexBingham(
                    covariance_eigenvectors=torch.as_tensor(vec),
                    covariance_eigenvalues=torch.as_tensor(lam)))
    theirs = JaxCBMM(weight=jnp.asarray(weight),
                     complex_bingham=jcb.ComplexBingham(
                         covariance_eigenvectors=jnp.asarray(vec),
                         covariance_eigenvalues=jnp.asarray(lam)))
    out = ours.predict(torch.as_tensor(y), affiliation_eps=affiliation_eps)
    assert out.shape == (F, K, T) and out.dtype == torch.float32
    assert_allclose(out.numpy(), np.asarray(theirs.predict(
        jnp.asarray(y), affiliation_eps=affiliation_eps)), atol=1e-5)
    if affiliation_eps:
        assert out.min() >= affiliation_eps


@pytest.mark.parametrize('knobs', [
    dict(), dict(saliency=True, affiliation_eps=1e-3),
    dict(weight_constant_axis=(-3, -1), aligner='greedy')],
    ids=['per_bin', 'saliency+eps', 'fc+greedy'])
def test_scan_fit_matches_jax(knobs):
    """Three EM iterations (a cold first M-step, warm 16-step solves
    after it) under the knobs of the scan path: per-bin and
    frequency-constant weights, saliency, the posterior clip and the
    inline Greedy aligner."""
    knobs = dict(knobs)
    y, aff = _mixture(seed=5)
    if knobs.pop('saliency', False):
        knobs['saliency'] = np.random.default_rng(6).uniform(
            0.3, 1., y.shape[:-1]).astype(np.float32)
    jax_extra = {}
    if knobs.pop('aligner', None):
        knobs['inline_permutation_aligner'] = GreedyPermutationAlignment(
            'cos')
        jax_extra['inline_permutation_aligner'] = JaxGreedy('cos')
    ours, theirs = _fit_both(y, aff, 3, jax_extra=jax_extra, **knobs)
    _assert_models_close(ours, theirs, y)


def test_jax_model_loads_through_from_dict():
    """A JAX model's to_dict(), its arrays converted by np.asarray, loads
    into the port and predicts the same affiliations."""
    y, aff = _mixture(seed=7)
    theirs = JaxTrainer().fit(jnp.asarray(y), initialization=jnp.asarray(
        aff), iterations=2, use_fused_em=False)

    def numpy_tree(d):
        return {k: numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
                for k, v in d.items()}
    ours = CBMM.from_dict(numpy_tree(theirs.to_dict()))
    assert isinstance(ours.complex_bingham, ComplexBingham)
    assert isinstance(ours.weight, torch.Tensor)
    assert_allclose(ours.predict(torch.as_tensor(y)).numpy(),
                    np.asarray(theirs.predict(jnp.asarray(y))), atol=1e-5)


@pytest.mark.parametrize('use_fused_em', [False, True])
def test_fit_predict_returns_the_fitted_models_prediction(use_fused_em):
    y, aff = _mixture(seed=8)
    Y = torch.as_tensor(y)
    kwargs = dict(initialization=torch.as_tensor(aff), iterations=2,
                  use_fused_em=use_fused_em)
    model, posterior = CBMMTrainer().fit(Y, _return_affiliation=True,
                                         **kwargs)
    torch.testing.assert_close(CBMMTrainer().fit_predict(Y, **kwargs),
                               posterior, atol=0, rtol=0)
    # the whole-fit twin's last, unclipped E-step is the model's predict
    torch.testing.assert_close(posterior, model.predict(Y), atol=1e-5,
                               rtol=0)


def test_random_init_draws_from_the_generator():
    y, _ = _mixture(seed=9)
    Y = torch.as_tensor(y[:2, :20])
    kw = dict(num_classes=2, iterations=1, use_fused_em=True)
    a = CBMMTrainer().fit(Y, **kw)
    b = CBMMTrainer().fit(Y, generator=torch.Generator().manual_seed(0),
                          **kw)
    c = CBMMTrainer().fit(Y, generator=torch.Generator().manual_seed(1),
                          **kw)
    assert torch.equal(a.weight, b.weight)
    assert not torch.equal(a.weight, c.weight)
    assert a.weight.shape == (2, 2, 1)
    assert a.complex_bingham.covariance_eigenvectors.shape == (2, 2, D, D)
