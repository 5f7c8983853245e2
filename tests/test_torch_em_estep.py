"""The opt-in E-step kernels of the port (pb_bss_tpu_torch.ops.em_estep,
kernels K11; their plain twins on the CPU) against the JAX package's
references on the same numpy inputs, and ``fit(use_pallas_em=True)``
against the JAX scan path (the comparisons of the JAX suite,
tests/test_ops/test_pallas_em.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.cacgmm import CACGMMTrainer as JaxTrainer
from pb_bss_tpu.ops import pallas_em
from pb_bss_tpu_torch.models import cacgmm as mc
from pb_bss_tpu_torch.models.cacgmm import CACGMM, CACGMMTrainer
from pb_bss_tpu_torch.models.complex_angular_central_gaussian import (
    ComplexAngularCentralGaussian,
)
from pb_bss_tpu_torch.ops import em_estep

torch.set_num_threads(2)


def _data(F=7, D=6, T=32, K=3, seed=0):
    """The JAX suite's inputs: y planes, unitary eigenvector planes,
    eigenvalues in [0.1, 1), uniform weights."""
    rng = np.random.default_rng(seed)
    y_re = rng.standard_normal((F, D, T)).astype(np.float32)
    y_im = rng.standard_normal((F, D, T)).astype(np.float32)
    a = rng.standard_normal((F, K, D, D)) \
        + 1j * rng.standard_normal((F, K, D, D))
    q, _ = np.linalg.qr(a)
    ev = rng.uniform(0.1, 1.0, (F, K, D)).astype(np.float32)
    return (y_re, y_im, q.real.astype(np.float32),
            q.imag.astype(np.float32), (1 / ev).astype(np.float32),
            np.log(ev).sum(-1).astype(np.float32),
            np.full((F, K), 1 / K, np.float32))


def _both(fn_t, fn_j, args):
    out = fn_t(*[torch.as_tensor(a) for a in args])
    ref = fn_j(*[jnp.asarray(a) for a in args])
    return [x.numpy() for x in out], [np.asarray(x) for x in ref]


@pytest.mark.parametrize('seed,T', [(0, 32), (1, 700)])
def test_e_step_matches_jax_reference(seed, T):
    before = em_estep.cacgmm_e_step.launches
    (aff, qf), (aff_r, qf_r) = _both(
        em_estep.cacgmm_e_step, pallas_em.cacgmm_e_step_reference,
        _data(seed=seed, T=T))
    assert em_estep.cacgmm_e_step.launches == before  # CPU: the twin
    assert aff.shape == qf.shape == (7, 3, T) and aff.dtype == np.float32
    # the same f32 operations in both packages: rounding only
    assert_allclose(qf, qf_r, rtol=1e-5)
    assert_allclose(aff, aff_r, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('seed,T', [(3, 32), (4, 1100)])
def test_em_scatter_matches_jax_reference(seed, T):
    before = em_estep.cacgmm_em_scatter.launches
    out, ref = _both(em_estep.cacgmm_em_scatter,
                     pallas_em.cacgmm_em_scatter_reference,
                     _data(seed=seed, T=T))
    assert em_estep.cacgmm_em_scatter.launches == before
    assert out[0].shape == out[1].shape == (7, 3, 6, 6)
    scale = np.abs(ref[0]).max()
    for o, r in zip(out[:2], ref[:2]):
        assert np.abs(o - r).max() <= 1e-5 * scale
    assert_allclose(out[2], ref[2], rtol=1e-5)


def test_e_step_matches_model_e_step():
    """The op computes the posterior of the port's CACGMM._predict."""
    y_re, y_im, v_re, v_im, inv, logdet, weight = [
        torch.as_tensor(a) for a in _data(seed=1)]
    aff, qf = em_estep.cacgmm_e_step(y_re, y_im, v_re, v_im, inv, logdet,
                                     weight)
    model = CACGMM(weight=weight[..., None],
                   cacg=ComplexAngularCentralGaussian(
                       covariance_eigenvectors=torch.complex(v_re, v_im),
                       covariance_eigenvalues=1.0 / inv))
    aff_m, qf_m, _ = model._predict(torch.complex(y_re, y_im))
    torch.testing.assert_close(aff, aff_m, atol=2e-4, rtol=0)
    torch.testing.assert_close(qf, qf_m, rtol=2e-4, atol=0)
    torch.testing.assert_close(aff.sum(1), torch.ones(7, 32), rtol=1e-5,
                               atol=0)


def _fit_both(seed, iterations=4, **kwargs):
    rng = np.random.default_rng(seed)
    F, T, D, K = 5, 40, 3, 2
    y = (rng.standard_normal((F, T, D))
         + 1j * rng.standard_normal((F, T, D))).astype(np.complex64)
    init = np.asarray(jax.random.uniform(jax.random.key(0), (F, K, T),
                                         jnp.float32))
    init = np.array(init / init.sum(1, keepdims=True))
    m_pl = CACGMMTrainer().fit(
        torch.as_tensor(y), initialization=torch.as_tensor(init),
        iterations=iterations, use_pallas_em=True, **kwargs)
    m_xla = JaxTrainer().fit(jnp.asarray(y), initialization=jnp.asarray(init),
                             iterations=iterations, **kwargs)
    return m_pl, m_xla


def test_trainer_use_pallas_em_matches_jax_scan():
    """fit(use_pallas_em=True) reproduces the JAX scan path over 4
    iterations (the JAX suite's comparison and tolerance)."""
    before = em_estep.cacgmm_em_scatter.launches
    m_pl, m_xla = _fit_both(4, affiliation_eps=0)
    assert em_estep.cacgmm_em_scatter.launches == before
    assert_allclose(m_pl.cacg.covariance_eigenvalues.numpy(),
                    np.asarray(m_xla.cacg.covariance_eigenvalues),
                    rtol=1e-3, atol=1e-5)
    assert_allclose(m_pl.weight.numpy(), np.asarray(m_xla.weight),
                    rtol=1e-3, atol=1e-5)


def test_use_pallas_em_runs_the_scatter_once_per_step(monkeypatch):
    """The first M-step comes from the initialization; every later
    E-step and scatter is one scatter call."""
    calls = []
    real = em_estep.cacgmm_em_scatter

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(em_estep, 'cacgmm_em_scatter', counted)
    y = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (5, 40, 3)).astype(np.complex64))
    CACGMMTrainer().fit(y, num_classes=2, iterations=4,
                        affiliation_eps=1e-10, use_pallas_em=True)
    assert calls == [(5, 3, 40)] * 3


@pytest.fixture
def route_of(monkeypatch):
    """The route a fit takes on the accelerator (nothing computed)."""
    class _Route(Exception):
        pass

    monkeypatch.setattr(mc, '_on_accelerator', lambda y: True)

    def sentinel(name):
        def fn(*args, **kwargs):
            raise _Route(name, kwargs.get('use_pallas_em'))
        return fn

    for attr, name in (('_fit_fused', 'whole'), ('_fit_fused_fc', 'fc'),
                       ('_fit_fused_stream', 'stream'),
                       ('_fit_em_t_blocked', 't_blocked'),
                       ('_fit_em', 'scan')):
        monkeypatch.setattr(mc, attr, sentinel(name))

    def run(T, **kwargs):
        y = torch.ones((9, T, 6), dtype=torch.complex64)
        with pytest.raises(_Route) as e:
            CACGMMTrainer().fit(y, num_classes=3, iterations=2, **kwargs)
        return e.value.args
    return run


def test_use_pallas_em_turns_auto_kernel_routes_off(route_of):
    """'auto' takes no kernel route under use_pallas_em (JAX
    cacgmm.py:900-913)."""
    assert route_of(300, use_pallas_em=True) == ('scan', True)


def test_use_pallas_em_turns_auto_t_block_off(route_of):
    """t_block='auto' resolves to None under use_pallas_em, whatever T
    (JAX cacgmm.py:984-989)."""
    T = mc.T_BLOCK_AUTO_THRESHOLD + 8
    assert route_of(T, use_pallas_em=True,
                    use_fused_em=False) == ('scan', True)


def test_use_pallas_em_accepts_tiny_affiliation_eps(route_of):
    assert route_of(300, use_pallas_em=True,
                    affiliation_eps=1e-10) == ('scan', True)


@pytest.mark.parametrize('kwargs,match', [
    (dict(batch=2), 'requires \\(F, N, D\\)'),
    (dict(affiliation_eps=1e-3), 'does not clip'),
    (dict(weight_constant_axis=(-3, -1)), '\\(-3, -1\\)'),
], ids=['batched', 'eps', 'fc_weights'])
def test_use_pallas_em_asserts(kwargs, match):
    batch = kwargs.pop('batch', None)
    shape = (9, 40, 3) if batch is None else (batch, 9, 40, 3)
    y = torch.ones(shape, dtype=torch.complex64)
    with pytest.raises(AssertionError, match=match):
        CACGMMTrainer().fit(y, num_classes=2, iterations=2,
                            use_pallas_em=True, **kwargs)


def test_scatter_gate():
    assert em_estep.scatter_fits(6, 3) and em_estep.scatter_fits(16, 8)
    assert not em_estep.scatter_fits(17, 3)
    assert not em_estep.scatter_fits(16, 19)


@pytest.mark.slow
def test_twins_match_pallas_interpret():
    """The port's twins against the JAX Pallas kernels themselves
    (interpret mode)."""
    args = _data(seed=2)
    (aff, qf), (aff_p, qf_p) = _both(
        em_estep.cacgmm_e_step,
        lambda *a: pallas_em.cacgmm_e_step(*a, interpret=True), args)
    assert_allclose(aff, aff_p, atol=1e-5)
    assert_allclose(qf, qf_p, rtol=1e-5)
    out, ref = _both(em_estep.cacgmm_em_scatter,
                     lambda *a: pallas_em.cacgmm_em_scatter(
                         *a, interpret=True), args)
    for o, r in zip(out, ref):
        assert_allclose(o, r, atol=1e-4)
