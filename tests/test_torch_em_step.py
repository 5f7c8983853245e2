"""The frequency-constant-weight EM of the port (pb_bss_tpu_torch.ops.
em_step, kernels K5; their plain twins on the CPU) against the JAX
package on the same numpy inputs. The cases mirror the JAX suite of the
per-iteration kernels (tests/test_ops/test_pallas_em_step.py) with its
tolerances: the port's route (``use_fused_em=True``, the twins on the
CPU) against the JAX scan path (``use_fused_em=False``) from the same
explicit initialization."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.cacgmm import CACGMM as JaxCACGMM
from pb_bss_tpu.models.cacgmm import CACGMMTrainer as JaxTrainer
from pb_bss_tpu.permutation_alignment import (
    GreedyPermutationAlignment as JaxGreedy,
)
from pb_bss_tpu_torch.models import cacgmm as mc
from pb_bss_tpu_torch.models.cacgmm import CACGMM, CACGMMTrainer
from pb_bss_tpu_torch.ops import em_step
from pb_bss_tpu_torch.permutation_alignment import (
    GreedyPermutationAlignment,
)

torch.set_num_threads(2)

WCA = (-3, -1)


def _mixture(F=17, D=4, T=40, seed=0):
    """(F, T, D) complex64 two-source mixture (the JAX suite's)."""
    rng = np.random.default_rng(seed)
    atf = rng.standard_normal((F, D, 2)) + 1j * rng.standard_normal(
        (F, D, 2))
    s = rng.standard_normal((F, 2, T)) + 1j * rng.standard_normal((F, 2, T))
    y = np.einsum('fdk,fkt->fdt', atf, s) + 0.3 * (
        rng.standard_normal((F, D, T)) + 1j * rng.standard_normal((F, D, T)))
    return np.ascontiguousarray(np.swapaxes(y, -2, -1).astype(np.complex64))


def _init(shape, seed=0):
    """The JAX trainer's own random initialization for
    ``key=jax.random.key(seed)``, as numpy for both packages."""
    aff = jax.random.uniform(jax.random.key(seed), shape, jnp.float32)
    return np.array(aff / aff.sum(-2, keepdims=True))


def _numpy_dict(model):
    return jax.tree_util.tree_map(np.asarray, model.to_dict())


def _to(convert, kwargs):
    return {k: convert(v) if isinstance(v, np.ndarray) else v
            for k, v in kwargs.items()}


def _fit_pair(y, initialization, iterations=3, **kwargs):
    """The port's fc route and the JAX scan path from the same init (an
    affiliation array or a JAX model, carried across by from_dict)."""
    if isinstance(initialization, JaxCACGMM):
        init_t = CACGMM.from_dict(_numpy_dict(initialization))
        init_j = initialization
    else:
        init_t = torch.as_tensor(initialization)
        init_j = jnp.asarray(initialization)
    jax_kwargs = _to(jnp.asarray, kwargs)
    if isinstance(kwargs.get('inline_permutation_aligner'),
                  GreedyPermutationAlignment):
        jax_kwargs['inline_permutation_aligner'] = JaxGreedy(
            kwargs['inline_permutation_aligner'].similarity_metric)
    fc = CACGMMTrainer().fit(
        torch.as_tensor(y), initialization=init_t, iterations=iterations,
        weight_constant_axis=WCA, use_fused_em=True,
        **_to(torch.as_tensor, kwargs))
    scan = JaxTrainer().fit(
        jnp.asarray(y), initialization=init_j, iterations=iterations,
        weight_constant_axis=WCA, use_fused_em=False, **jax_kwargs)
    return fc, scan


def _assert_models_close(m_a, m_b, atol=1e-4):
    """The JAX suite's comparison: weights and eigenvalues within atol,
    the reassembled covariances within 10 atol (the eigenbasis is not
    unique in near-degenerate eigenspaces)."""
    weight_a = np.asarray(m_a.weight, np.float64)
    weight_b = np.asarray(m_b.weight, np.float64)
    assert weight_a.shape == weight_b.shape, (weight_a.shape, weight_b.shape)
    assert_allclose(weight_a, weight_b, atol=atol)
    assert_allclose(np.asarray(m_a.cacg.covariance_eigenvalues, np.float64),
                    np.asarray(m_b.cacg.covariance_eigenvalues, np.float64),
                    atol=atol)

    def cov(m):
        v = np.asarray(m.cacg.covariance_eigenvectors)
        lam = np.asarray(m.cacg.covariance_eigenvalues)
        return np.einsum('...de,...e,...ge->...dg', v, lam, v.conj())
    assert_allclose(cov(m_a), cov(m_b), atol=10 * atol)


@pytest.fixture
def fc_route(monkeypatch):
    """Count the fits that take the frequency-constant route and the
    kernel launches (none on the CPU)."""
    calls = []
    real = mc._fit_fused_fc

    def counted(*args, **kwargs):
        calls.append(kwargs.get('aligner'))
        return real(*args, **kwargs)

    monkeypatch.setattr(mc, '_fit_fused_fc', counted)
    before = (em_step.m_init.launches, em_step.em_step.launches)
    yield calls
    assert (em_step.m_init.launches, em_step.em_step.launches) == before


@pytest.mark.parametrize('T', [40, 37])
def test_fc_parity_with_scan(fc_route, T):
    y = _mixture(T=T)
    fc, scan = _fit_pair(y, _init((17, 3, T)))
    assert len(fc_route) == 1
    assert fc.weight.shape == (1, 3, 1)
    _assert_models_close(fc, scan)


def test_fc_parity_saliency(fc_route):
    y = _mixture(seed=1)
    saliency = np.random.default_rng(11).uniform(
        0.2, 1.0, size=(17, 40)).astype(np.float32)
    fc, scan = _fit_pair(y, _init((17, 3, 40), seed=1), saliency=saliency)
    _assert_models_close(fc, scan)


def test_fc_parity_source_activity_mask(fc_route):
    y = _mixture(seed=2)
    rng = np.random.default_rng(12)
    sam = rng.uniform(size=(17, 3, 40)) > 0.2
    sam[..., 0, :] |= ~sam.any(-2)
    fc, scan = _fit_pair(y, _init((17, 3, 40), seed=2),
                         source_activity_mask=sam)
    # gated classes sharpen posteriors: more warm-vs-cold Jacobi
    # sensitivity (the JAX suite's tolerance)
    _assert_models_close(fc, scan, atol=2e-3)


def test_fc_silenced_class_stays_finite_at_d6(fc_route):
    """The guard ladder at D=6: a source-activity mask that silences a
    class in every frame of some bins, with affiliation_eps=0, makes that
    class's affiliation sum exactly 0 there. The covariance is then
    0 / tiny = 0 (a division; D / tiny overflows to inf at D >= 5 and
    0 * inf is NaN), as on the JAX scan path."""
    y = _mixture(F=9, D=6, T=40, seed=13)
    sam = np.ones((9, 3, 40), bool)
    sam[2:5, 1] = False
    fc, scan = _fit_pair(y, _init((9, 3, 40), seed=13), iterations=2,
                         source_activity_mask=sam, affiliation_eps=0.)
    assert all(bool(torch.isfinite(x).all()) for x in (
        fc.weight, fc.cacg.covariance_eigenvalues,
        fc.cacg.covariance_eigenvectors))
    _assert_models_close(fc, scan, atol=2e-3)


def test_fc_resume_from_jax_model(fc_route):
    """Resume from a JAX fc model with weight (1, K, 1), carried across
    by from_dict."""
    y = _mixture(seed=3)
    m0 = JaxTrainer().fit(jnp.asarray(y), num_classes=3, iterations=2,
                          weight_constant_axis=WCA, use_fused_em=False)
    assert m0.weight.shape == (1, 3, 1)
    fc, scan = _fit_pair(y, m0, iterations=2)
    assert len(fc_route) == 1
    _assert_models_close(fc, scan)


def test_fc_batched_matches_per_example(fc_route):
    """(B, F, T, D) input: the kernels fold the batch into bins but the
    weight reduction stays per utterance."""
    ys = [_mixture(seed=s, F=11, T=32) for s in (4, 5)]
    aff0 = _init((2, 11, 3, 32), seed=40)
    trainer = CACGMMTrainer()
    mb = trainer.fit(torch.as_tensor(np.stack(ys)),
                     initialization=torch.as_tensor(aff0), iterations=3,
                     weight_constant_axis=WCA, use_fused_em=True)
    assert mb.weight.shape == (2, 1, 3, 1)
    for b, y in enumerate(ys):
        m1 = trainer.fit(torch.as_tensor(y),
                         initialization=torch.as_tensor(aff0[b]),
                         iterations=3, weight_constant_axis=WCA,
                         use_fused_em=True)
        assert_allclose(mb.weight[b].numpy(), m1.weight.numpy(), atol=1e-6)
        assert_allclose(mb.cacg.covariance_eigenvalues[b].numpy(),
                        m1.cacg.covariance_eigenvalues.numpy(), atol=1e-6)


@pytest.mark.parametrize('shared', [True, False],
                         ids=['broadcast_weight', 'batched_weight'])
def test_fc_batched_resume(fc_route, shared):
    """A batched resume from a JAX model whose weight is broadcast over
    the batch ((1, K, 1)) or batched ((B, 1, K, 1))."""
    ys = np.stack([_mixture(seed=s, F=11, T=32) for s in (7, 8)])
    m0 = JaxTrainer().fit(
        jnp.asarray(ys), initialization=jnp.asarray(_init((2, 11, 3, 32),
                                                          seed=41)),
        iterations=2, weight_constant_axis=WCA, use_fused_em=False)
    assert m0.weight.shape == (2, 1, 3, 1)
    if shared:
        m0 = JaxCACGMM(weight=jnp.mean(m0.weight, axis=0), cacg=m0.cacg)
        assert m0.weight.shape == (1, 3, 1)
    fc, scan = _fit_pair(ys, m0, iterations=2)
    assert fc.weight.shape == (2, 1, 3, 1)
    _assert_models_close(fc, scan)


def test_fc_inline_aligner_matches_scan(fc_route):
    """The inline aligner runs between launches on the emitted
    posterior and permutes the per-class state: the scan path's
    align-then-M."""
    y = _mixture(seed=20)  # F=17, odd as the aligner expects
    fc, scan = _fit_pair(y, _init((17, 3, 40), seed=20),
                         inline_permutation_aligner=(
                             GreedyPermutationAlignment()))
    assert len(fc_route) == 1 and fc_route[0] is not None
    _assert_models_close(fc, scan, atol=2e-3)


def test_fc_inline_aligner_resume_from_model(fc_route):
    y = _mixture(seed=21)
    m0 = JaxTrainer().fit(jnp.asarray(y), num_classes=3, iterations=2,
                          weight_constant_axis=WCA, use_fused_em=False)
    fc, scan = _fit_pair(y, m0, iterations=2,
                         inline_permutation_aligner=(
                             GreedyPermutationAlignment()))
    _assert_models_close(fc, scan, atol=2e-3)


def test_fc_fit_predict(fc_route):
    y = torch.as_tensor(_mixture(seed=6))
    init = torch.as_tensor(_init((17, 3, 40), seed=6))
    trainer = CACGMMTrainer()
    model, aff = trainer.fit_predict_model(
        y, initialization=init, iterations=3, weight_constant_axis=WCA,
        use_fused_em=True)
    torch.testing.assert_close(aff, model.predict(y), atol=1e-6, rtol=0)
    torch.testing.assert_close(aff.sum(-2), torch.ones(17, 40), atol=1e-5,
                               rtol=0)


def test_fc_auto_gate_off_on_cpu(monkeypatch):
    """'auto' on CPU tensors takes the scan path: the same model as
    use_fused_em=False, bit for bit."""
    monkeypatch.setattr(mc, '_fit_fused_fc', None)  # never reached
    y = torch.as_tensor(_mixture(F=7, T=24))
    init = torch.as_tensor(_init((7, 3, 24)))
    kwargs = dict(initialization=init, iterations=2,
                  weight_constant_axis=WCA)
    auto = CACGMMTrainer().fit(y, **kwargs)
    scan = CACGMMTrainer().fit(y, use_fused_em=False, **kwargs)
    assert torch.equal(auto.cacg.covariance_eigenvalues,
                       scan.cacg.covariance_eigenvalues)


def test_kernel_gate():
    assert em_step.max_frames(6, 3) == 3190
    assert em_step.fits(6, 3, 3190) and not em_step.fits(6, 3, 3191)
    assert em_step.fits(16, 3, 300) and not em_step.fits(17, 3, 10)
    assert em_step.fits(6, 3, 304) and em_step.fits(6, 3, 300)
    assert not em_step.fits(6, 3, 100000)
    assert em_step.smem_bytes(6, 3, 304) < 48 * 1024


def test_one_step_matches_jax_scan():
    """Init and one iteration, held tightly: with 6 warm sweeps the
    warm-started Jacobi converges as the scan path's cold one does, so
    the eigenvalues agree within 1e-5 of the largest (1 after the
    max-normalization) and the weights to rounding."""
    y = _mixture(F=9, D=6, T=50, seed=30)
    init = _init((9, 3, 50), seed=30)
    yn = mc.normalize_observation(torch.as_tensor(y))
    weight, ev, vec = em_step.cacgmm_em_fc_reference(
        yn, torch.as_tensor(init), torch.ones(9, 3, 50), iterations=2,
        sweeps=6, warm_sweeps=6)
    scan = JaxTrainer().fit(jnp.asarray(y), initialization=jnp.asarray(init),
                            iterations=2, weight_constant_axis=WCA,
                            use_fused_em=False)
    assert_allclose(weight.numpy(), np.asarray(scan.weight)[0, :, 0],
                    atol=1e-6)
    lam = np.asarray(scan.cacg.covariance_eigenvalues)
    assert np.abs(ev.numpy() - lam).max() <= 1e-5 * lam.max()
    assert vec.shape == (9, 3, 6, 6) and vec.dtype == torch.complex64


def test_aligner_requires_unbatched_input():
    y = torch.as_tensor(np.stack([_mixture(F=9, T=20)] * 2))
    with pytest.raises(AssertionError, match='real frequency axis'):
        em_step.cacgmm_em_fc(
            mc.normalize_observation(y),
            torch.as_tensor(_init((2, 9, 3, 20))), torch.ones(2, 9, 3, 20),
            iterations=2, aligner=GreedyPermutationAlignment())


@pytest.mark.slow
def test_twin_matches_pallas_interpret():
    """The port's twin against the JAX per-iteration Pallas kernels
    themselves (interpret mode), F=5, T=24, 3 iterations."""
    from pb_bss_tpu.ops.pallas_em_step import cacgmm_em_fc as jax_em_fc
    y = np.swapaxes(_mixture(F=5, T=24, seed=31), -2, -1)
    y = y / np.linalg.norm(y, axis=-2, keepdims=True)
    init = _init((5, 3, 24), seed=31)
    qf = np.ones_like(init)
    ref = jax_em_fc(jnp.asarray(y.real, jnp.float32),
                    jnp.asarray(y.imag, jnp.float32), jnp.asarray(init),
                    jnp.asarray(qf), iterations=3, interpret=True)
    out = em_step.cacgmm_em_fc_reference(
        torch.as_tensor(y.astype(np.complex64)), torch.as_tensor(init),
        torch.as_tensor(qf), iterations=3)
    assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-5)
    assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=1e-4)
