"""The streamed cACGMM EM of the port (pb_bss_tpu_torch.ops.em_stream,
kernel K4; its plain twins on the CPU) against the JAX package on the
same numpy inputs: one statistics pass against the JAX time-blocked
EM's per-block statistics, and whole streamed fits against the JAX scan
path with the JAX stream suite's cases and tolerances
(tests/test_ops/test_pallas_em_stream.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.cacgmm import CACGMM as JaxCACGMM
from pb_bss_tpu.models.cacgmm import CACGMMTrainer as JaxTrainer
from pb_bss_tpu.models.complex_angular_central_gaussian import (
    ComplexAngularCentralGaussian as JaxCACG,
)
from pb_bss_tpu_torch.models import cacgmm as mc
from pb_bss_tpu_torch.models.cacgmm import CACGMM, CACGMMTrainer
from pb_bss_tpu_torch.ops import em_stream

torch.set_num_threads(2)

F, D, T, K = 9, 3, 1200, 2
TINY = float(np.finfo(np.float32).tiny)


def _unit(y):
    return (y / np.linalg.norm(y, axis=-2, keepdims=True)).astype(
        np.complex64)


def _stats_inputs(N=7, D=6, K=3, T=333, seed=0):
    """Unit-norm y (N, D, T), a model (eigenvalues (N, K, D) with max 1,
    unitary eigenvectors, weights), initial posteriors, saliency and a
    source-activity mask."""
    rng = np.random.default_rng(seed)

    def cn(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    y = _unit(cn(N, D, T))
    vec = np.linalg.qr(cn(N, K, D, D))[0].astype(np.complex64)
    ev = rng.uniform(0.05, 1., (N, K, D)).astype(np.float32)
    ev /= ev.max(-1, keepdims=True)
    weight = rng.uniform(0.2, 1., (N, K)).astype(np.float32)
    weight /= weight.sum(-1, keepdims=True)
    aff = rng.uniform(size=(N, K, T)).astype(np.float32)
    aff /= aff.sum(1, keepdims=True)
    qf = rng.uniform(0.5, 2., (N, K, T)).astype(np.float32)
    sal = rng.uniform(0.2, 1., (N, T)).astype(np.float32)
    mask = rng.uniform(size=(N, K, T)) > 0.2
    mask[:, 0] |= ~mask.any(1)
    return dict(y=y, eigenvalues=ev, eigenvectors=vec, weight=weight,
                affiliation=aff, quadratic_form=qf, saliency=sal,
                mask=mask)


def _jax_block_stats(x, mode, extras):
    """The JAX time-blocked EM's per-block statistics
    (pb_bss_tpu/models/cacgmm.py, ``_fit_em_t_blocked.block_stats``) on
    the same posteriors: the E-step of the JAX model (model mode), then
    saliency, w = aff / max(qf, 10 tiny) and the sums."""
    y = jnp.asarray(x['y'])
    if mode == 'model':
        model = JaxCACGMM(
            weight=jnp.asarray(x['weight'])[..., None],
            cacg=JaxCACG(
                covariance_eigenvectors=jnp.asarray(x['eigenvectors']),
                covariance_eigenvalues=jnp.asarray(x['eigenvalues'])))
        aff, qf, _ = model._predict(
            y, source_activity_mask=(jnp.asarray(x['mask']) if extras
                                     else None),
            affiliation_eps=1e-10)
    else:
        aff = jnp.asarray(x['affiliation'])
        qf = jnp.asarray(x['quadratic_form'])
    if extras:
        aff = aff * jnp.asarray(x['saliency'])[:, None, :]
    w = aff / jnp.maximum(qf, 10 * TINY)
    scatter = jnp.einsum('...kt,...dt,...et->...kde', w.astype(y.dtype), y,
                         y.conj(), precision=jax.lax.Precision.HIGHEST)
    return np.asarray(scatter), np.asarray(jnp.sum(aff, axis=-1))


@pytest.mark.parametrize('extras', [False, True],
                         ids=['plain', 'saliency+mask'])
@pytest.mark.parametrize('mode', ['from_init', 'model'])
def test_one_pass_matches_jax_block_stats(mode, extras):
    x = _stats_inputs()
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    kwargs = (dict(affiliation=t['affiliation'],
                   quadratic_form=t['quadratic_form'])
              if mode == 'from_init' else
              dict(eigenvalues=t['eigenvalues'],
                   eigenvectors=t['eigenvectors'], weight=t['weight'],
                   affiliation_eps=1e-10))
    if extras:
        kwargs.update(saliency=t['saliency'],
                      source_activity_mask=t['mask'].float())
    before = em_stream.e_stats.launches
    scatter, asum = em_stream.e_stats(t['y'], **kwargs)
    assert em_stream.e_stats.launches == before  # CPU: the plain twin
    ref_scatter, ref_asum = _jax_block_stats(x, mode, extras)
    assert scatter.shape == (7, 3, 6, 6) and asum.shape == (7, 3)
    # the same f32 operations in both packages: rounding only
    assert np.abs(scatter.numpy() - ref_scatter).max() \
        <= 1e-5 * np.abs(ref_scatter).max()
    assert_allclose(asum.numpy(), ref_asum, rtol=1e-5)


def _mixture(seed=0, T=T, F=F, D=D, K=2):
    rng = np.random.default_rng(seed)
    atf = rng.standard_normal((F, D, K)) + 1j * rng.standard_normal(
        (F, D, K))
    s = rng.standard_normal((F, K, T)) + 1j * rng.standard_normal(
        (F, K, T))
    y = np.einsum('fdk,fkt->fdt', atf, s) + 0.3 * (
        rng.standard_normal((F, D, T)) + 1j * rng.standard_normal((F, D, T)))
    return np.ascontiguousarray(np.swapaxes(y, -2, -1).astype(np.complex64))


def _init(shape, seed=42):
    aff = np.random.default_rng(seed).uniform(size=shape).astype(np.float32)
    return aff / aff.sum(-2, keepdims=True)


@pytest.fixture
def stream_route(monkeypatch):
    """Send use_fused_em=True past the whole-fit and the
    frequency-constant gates whatever T, so that these small shapes take
    the streamed route (the JAX stream suite picks T past its own,
    smaller gates instead); count the streamed fits."""
    monkeypatch.setattr(mc.em_loop, 'fits', lambda *args, **kwargs: False)
    monkeypatch.setattr(mc.em_step, 'fits', lambda *args, **kwargs: False)
    calls = []
    real = mc._fit_fused_stream

    def counted(*args, **kwargs):
        calls.append(kwargs['weight_mode'])
        return real(*args, **kwargs)

    monkeypatch.setattr(mc, '_fit_fused_stream', counted)
    return calls


def _assert_close(m_a, m_b, atol=2e-4):
    """The JAX stream suite's comparison: weights and eigenvalues within
    ``atol``, covariances within 10 atol."""
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


def _fit_pair(y, init, iterations=3, **kwargs):
    def converted(to):
        return {k: to(v) if isinstance(v, np.ndarray) else v
                for k, v in kwargs.items()}
    stream = CACGMMTrainer().fit(
        torch.as_tensor(y), initialization=torch.as_tensor(init),
        iterations=iterations, use_fused_em=True, t_block=None,
        **converted(torch.as_tensor))
    scan = JaxTrainer().fit(
        jnp.asarray(y), initialization=jnp.asarray(init),
        iterations=iterations, use_fused_em=False, t_block=None,
        **converted(jnp.asarray))
    return stream, scan


@pytest.mark.parametrize('seed,T_', [(0, T), (5, 1536)],
                         ids=['T1200', 'T1536'])
def test_stream_per_bin_matches_jax_scan(stream_route, seed, T_):
    y = _mixture(seed=seed, T=T_)
    stream, scan = _fit_pair(y, _init((F, K, T_)))
    assert stream_route == ['per_bin']
    assert stream.weight.shape == (F, K, 1)
    _assert_close(stream, scan)


def test_stream_fc_matches_jax_scan(stream_route):
    stream, scan = _fit_pair(_mixture(seed=1), _init((F, K, T)),
                             weight_constant_axis=(-3, -1))
    assert stream_route == ['fc']
    assert stream.weight.shape == (1, K, 1)
    _assert_close(stream, scan)


def test_stream_saliency_and_mask_match_jax_scan(stream_route):
    rng = np.random.default_rng(2)
    saliency = rng.uniform(0.2, 1.0, size=(F, T)).astype(np.float32)
    sam = rng.uniform(size=(F, K, T)) > 0.2
    sam[..., 0, :] |= ~sam.any(-2)
    stream, scan = _fit_pair(_mixture(seed=2), _init((F, K, T)),
                             saliency=saliency, source_activity_mask=sam)
    assert stream_route == ['per_bin']
    _assert_close(stream, scan)


def _numpy_dict(model):
    return jax.tree_util.tree_map(np.asarray, model.to_dict())


def test_stream_resume_from_jax_model(stream_route):
    y = _mixture(seed=3)
    m0 = JaxTrainer().fit(jnp.asarray(y), num_classes=K, iterations=2,
                          use_fused_em=False, t_block=None)
    stream = CACGMMTrainer().fit(
        torch.as_tensor(y), initialization=CACGMM.from_dict(_numpy_dict(m0)),
        iterations=2, use_fused_em=True, t_block=None)
    scan = JaxTrainer().fit(jnp.asarray(y), initialization=m0, iterations=2,
                            use_fused_em=False, t_block=None)
    assert stream_route == ['per_bin']
    _assert_close(stream, scan)


def test_stream_fc_batched_resume_from_broadcast_weight(stream_route):
    """A batched frequency-constant resume from a (1, K, 1) weight: the
    weight broadcasts over the batch."""
    yb = np.stack([_mixture(seed=s) for s in (6, 7)])
    m0 = JaxTrainer().fit(
        jnp.asarray(yb), initialization=jnp.asarray(_init((2, F, K, T))),
        iterations=2, weight_constant_axis=(-3, -1), use_fused_em=False,
        t_block=None)
    m_shared = JaxCACGMM(weight=jnp.mean(m0.weight, axis=0), cacg=m0.cacg)
    assert m_shared.weight.shape == (1, K, 1)
    stream = CACGMMTrainer().fit(
        torch.as_tensor(yb),
        initialization=CACGMM.from_dict(_numpy_dict(m_shared)),
        iterations=2, weight_constant_axis=(-3, -1), use_fused_em=True,
        t_block=None)
    scan = JaxTrainer().fit(
        jnp.asarray(yb), initialization=m_shared, iterations=2,
        weight_constant_axis=(-3, -1), use_fused_em=False, t_block=None)
    assert stream_route == ['fc']
    assert stream.weight.shape == (2, 1, K, 1)
    _assert_close(stream, scan)


def test_stream_bench_shape_matches_jax_scan(stream_route):
    """D=6, K=3 at T=700, 2 iterations (the JAX suite's bench-shape
    case and tolerance)."""
    y = _mixture(seed=11, F=4, D=6, K=3, T=700)
    stream, scan = _fit_pair(y, _init((4, 3, 700)), iterations=2)
    _assert_close(stream, scan, atol=5e-4)


def test_stream_fit_predict_equals_predict(stream_route):
    y = torch.as_tensor(_mixture(seed=4))
    init = torch.as_tensor(_init((F, K, T)))
    model, aff = CACGMMTrainer().fit_predict_model(
        y, initialization=init, iterations=2, use_fused_em=True,
        t_block=None)
    # the same E-step formulas on the same parameters
    torch.testing.assert_close(aff, model.predict(y), atol=1e-6, rtol=0)


def test_chunking_covers_every_frame_once():
    """The streamed kernel's partition: every (bin, frame) falls to
    exactly one CTA, the CTAs' spans are equal and make whole waves (no
    nearly empty last wave), a bin's pieces take distinct slots below
    ``slots``, and the walk is in a fixed order (CTA by CTA, frames
    ascending)."""
    for N, T_, capacity in ((1028, 3753, 660), (257, 3753, 660),
                            (1, 100, 660), (9, 1200, 132), (65, 1000, 528),
                            (3, 7, 5), (40, 300, 1)):
        ctas, span, slots = em_stream._partition(N, T_, capacity)
        assert ctas <= em_stream._WAVES * capacity or span == em_stream.TILE
        assert (ctas - 1) * span < N * T_ <= ctas * span
        segments = em_stream._segments(N, T_, span)
        assert [s[0] for s in segments] == sorted(s[0] for s in segments)
        seen = np.zeros((N, T_), int)
        slot_of = {}
        for g, n, t0, t1, slot in segments:
            assert 0 <= t0 < t1 <= T_ and 0 <= slot < slots
            assert g * span <= n * T_ + t0 and n * T_ + t1 <= (g + 1) * span
            seen[n, t0:t1] += 1
            assert slot_of.setdefault((n, slot), g) == g
        assert (seen == 1).all()
    # at the long path's shape: whole waves of the 528 resident CTAs, every
    # CTA but the last over the same span
    ctas, span, _ = em_stream._partition(1028, 3753, 528)
    assert ctas == em_stream._WAVES * 528
    assert span == -(-1028 * 3753 // ctas)
    # the streamed Watson / Bingham kernel walks the shared plan: spans of
    # whole tiles that cover its frames, on the same 528 resident CTAs
    from pb_bss_tpu_torch.ops import _plan, mm_stream
    for N, T_ in ((257, 3753), (1028, 3753), (1, 100), (9, 1200),
                  (5000, 20000)):
        ctas, span, slots = _plan.partition(N, T_, 528, mm_stream.TILE)
        assert span >= mm_stream.TILE and ctas <= _plan.WAVES * 528
        assert (ctas - 1) * span < N * T_ <= ctas * span
        assert slots <= -(-T_ // span) + 1  # the CTAs a bin can touch
    assert _plan.partition(257, 3753, 528, mm_stream.TILE) == (2111, 457, 10)
    assert _plan.partition(5000, 20000, 528, mm_stream.TILE) \
        == (2112, 47349, 2)
    assert em_stream.fits(16, 19) and not em_stream.fits(17, 3)


@pytest.mark.parametrize('D', em_stream.DIMS)
def test_kernel_instantiations_cover_the_gate(D):
    """The kernel is instantiated for every D the gate admits, and its own
    shared memory stays within the card's limit for every K the gate
    admits at that D."""
    from pb_bss_tpu_torch.ops._build import SMEM_LIMIT
    assert em_stream.fits(D, 1) and not em_stream.fits(17, 1)
    K = 1
    while em_stream.fits(D, K):
        assert em_stream.kernel_smem_bytes(D, K) <= SMEM_LIMIT
        K += 1
    assert K > 19


@pytest.mark.slow
def test_stream_matches_pallas_interpret():
    """The port's streamed route against the JAX streamed Pallas kernel
    itself (interpret mode); T=1200 at D=3, K=2 is past the JAX
    whole-fit kernel's gate."""
    y = _mixture(seed=0)
    init = _init((F, K, T))
    ref = JaxTrainer().fit(jnp.asarray(y), initialization=jnp.asarray(init),
                           iterations=3, use_fused_em=True, t_block=None)
    out = mc._fit_fused_stream(
        mc.normalize_observation(torch.as_tensor(y)), None,
        torch.as_tensor(init), torch.ones(F, K, T), iterations=3,
        eigenvalue_floor=1e-10, affiliation_eps=1e-10, eigh_sweeps=None,
        weight_mode='per_bin')
    _assert_close(out, ref)
