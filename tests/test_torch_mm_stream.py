"""The streamed complex Watson EM of the port (ops/mm_stream.py: the plain
twin of kernel K7's statistics pass, the whole streamed fit and the
trainer's streamed route on the CPU) against the JAX package on the same
numpy inputs, with the JAX suite's tolerances
(tests/test_ops/test_pallas_mm_stream.py). The streamed route inverts
the eigenvalue ratio through the scan path's log-spaced table, so it is
held against the JAX scan path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from numpy.testing import assert_allclose

from pb_bss_tpu.models import complex_watson as jcw
from pb_bss_tpu.models.cwmm import CWMM as JaxCWMM
from pb_bss_tpu.models.cwmm import CWMMTrainer as JaxTrainer
from pb_bss_tpu.ops import pallas_mm_stream
from pb_bss_tpu_torch.models.cwmm import CWMMTrainer
from pb_bss_tpu_torch.ops import mm_stream

torch.set_num_threads(2)

F, D, K = 9, 3, 2


def _mixture(seed=0, T=100, batch=None):
    """Unit-norm (..., F, T, D) complex64 two-source mixture."""
    rng = np.random.default_rng(seed)
    lead = (F,) if batch is None else (batch, F)
    atf = rng.standard_normal((*lead, D, 2)) + 1j * rng.standard_normal(
        (*lead, D, 2))
    s = rng.standard_normal((*lead, 2, T)) + 1j * rng.standard_normal(
        (*lead, 2, T))
    y = np.einsum('...dk,...kt->...td', atf, s) + 0.3 * (
        rng.standard_normal((*lead, T, D))
        + 1j * rng.standard_normal((*lead, T, D)))
    y /= np.linalg.norm(y, axis=-1, keepdims=True)
    return y.astype(np.complex64)


def _aff0(seed, T=100, lead=(F,)):
    rng = np.random.default_rng(seed)
    aff = rng.uniform(size=(*lead, K, T)).astype(np.float32)
    return aff / aff.sum(-2, keepdims=True)


def _assert_modes_aligned(m_a, m_b, atol=1e-3):
    overlap = np.abs(np.einsum('...d,...d->...', np.asarray(m_a),
                               np.asarray(m_b).conj()))
    assert_allclose(overlap, 1.0, atol=atol)


def _stream(y, aff0, iterations, weight_mode='per_bin', saliency=None):
    """The port's cwmm_em_long on CPU tensors (the statistics twin and the
    plain Jacobi)."""
    before = mm_stream.mm_stats.launches
    out = mm_stream.cwmm_em_long(
        torch.as_tensor(y).transpose(-1, -2), torch.as_tensor(aff0),
        iterations=iterations, weight_mode=weight_mode,
        saliency=None if saliency is None else torch.as_tensor(saliency))
    assert mm_stream.mm_stats.launches == before  # CPU: no launch
    return [x.numpy() for x in out]


def _scan(y, aff0, iterations, **kwargs):
    return JaxTrainer().fit(jnp.asarray(y), initialization=jnp.asarray(aff0),
                            iterations=iterations, use_fused_em=False,
                            **kwargs)


@pytest.mark.parametrize('T', [100, 1100])  # 1100: three 512-frame tiles
def test_per_bin_matches_jax_scan(T):
    y, aff0 = _mixture(seed=0, T=T), _aff0(10, T=T)
    weight, mode, kappa = _stream(y, aff0, 3)
    scan = _scan(y, aff0, 3)
    assert_allclose(weight, np.asarray(scan.weight[..., 0]), atol=1e-4)
    assert_allclose(kappa, np.asarray(scan.complex_watson.concentration),
                    rtol=5e-3, atol=1e-2)
    _assert_modes_aligned(mode, scan.complex_watson.mode)


def test_fc_matches_jax_scan():
    y, aff0 = _mixture(seed=1), _aff0(11)
    weight, mode, kappa = _stream(y, aff0, 3, weight_mode='fc')
    scan = _scan(y, aff0, 3, weight_constant_axis=(-3, -1))
    assert weight.shape == (K,)
    assert_allclose(weight, np.asarray(scan.weight)[0, :, 0], atol=1e-4)
    assert_allclose(kappa, np.asarray(scan.complex_watson.concentration),
                    rtol=5e-3, atol=1e-2)
    _assert_modes_aligned(mode, scan.complex_watson.mode)


@pytest.mark.parametrize('weight_mode', ['per_bin', 'fc'])
def test_saliency_matches_jax_scan(weight_mode):
    y, aff0 = _mixture(seed=2), _aff0(12)
    saliency = np.random.default_rng(13).uniform(
        0.2, 1., (F, 100)).astype(np.float32)
    weight, mode, kappa = _stream(y, aff0, 3, weight_mode=weight_mode,
                                  saliency=saliency)
    scan = _scan(y, aff0, 3, saliency=jnp.asarray(saliency),
                 weight_constant_axis=(-1,) if weight_mode == 'per_bin'
                 else (-3, -1))
    ref_weight = np.asarray(scan.weight)[..., 0]
    assert_allclose(weight, ref_weight if weight_mode == 'per_bin'
                    else ref_weight[0], atol=1e-4)
    assert_allclose(kappa, np.asarray(scan.complex_watson.concentration),
                    rtol=5e-3, atol=1e-2)
    _assert_modes_aligned(mode, scan.complex_watson.mode)


@pytest.mark.parametrize('weight_mode', ['per_bin', 'fc'])
def test_batched_matches_per_example(weight_mode):
    y = _mixture(seed=3, batch=2)
    aff0 = _aff0(14, lead=(2, F))
    wb, mb, kb = _stream(y, aff0, 2, weight_mode=weight_mode)
    assert wb.shape == ((2, F, K) if weight_mode == 'per_bin' else (2, K))
    for b in range(2):
        w1, m1, k1 = _stream(y[b], aff0[b], 2, weight_mode=weight_mode)
        assert_allclose(wb[b], w1, atol=1e-6)
        assert_allclose(kb[b], k1, rtol=1e-5, atol=1e-4)
        _assert_modes_aligned(mb[b], m1, 1e-5)
        scan = _scan(y[b], aff0[b], 2, weight_constant_axis=(
            (-1,) if weight_mode == 'per_bin' else (-3, -1)))
        assert_allclose(k1, np.asarray(scan.complex_watson.concentration),
                        rtol=5e-3, atol=1e-2)


@pytest.mark.parametrize('mode', ['from_init', 'step'])
def test_one_pass_matches_the_jax_statistics(mode):
    """One statistics pass against the JAX package's E-step and a direct
    sum: sum_t a s y y^H and sum_t a s."""
    y, aff0 = _mixture(seed=4, T=60), _aff0(15, T=60)
    saliency = np.random.default_rng(16).uniform(
        0.2, 1., (F, 60)).astype(np.float32)
    y_dt = torch.as_tensor(y).transpose(-1, -2).contiguous()
    if mode == 'from_init':
        kwargs = dict(affiliation=torch.as_tensor(aff0))
        aff = aff0
    else:
        rng = np.random.default_rng(17)
        m = rng.standard_normal((F, K, D)) + 1j * rng.standard_normal(
            (F, K, D))
        m = (m / np.linalg.norm(m, axis=-1, keepdims=True)
             ).astype(np.complex64)
        kappa = rng.uniform(3., 30., (F, K)).astype(np.float32)
        weight = rng.uniform(0.2, 1., (F, K)).astype(np.float32)
        weight /= weight.sum(-1, keepdims=True)
        log_norm = np.asarray(jcw.ComplexWatson.log_norm_tran_vu(
            jnp.asarray(kappa), D))
        kwargs = dict(mode=torch.as_tensor(m),
                      concentration=torch.as_tensor(kappa),
                      log_norm=torch.as_tensor(log_norm.copy()),
                      weight=torch.as_tensor(weight))
        aff = np.asarray(JaxCWMM(
            weight=jnp.asarray(weight[..., None]),
            complex_watson=jcw.ComplexWatson(
                mode=jnp.asarray(m), concentration=jnp.asarray(kappa))
        )._predict(jnp.asarray(y)))
    scatter, asum = mm_stream.mm_stats(
        y_dt, saliency=torch.as_tensor(saliency), **kwargs)
    a = aff * saliency[:, None, :]
    ref = np.einsum('fkt,ftd,fte->fkde', a, y, y.conj())
    assert_allclose(asum.numpy(), a.sum(-1), rtol=1e-5)
    assert np.abs(scatter.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_fc_weight_rows_are_shared_by_their_bins():
    """bins_per_weight: bin n takes weight row n // bins_per_weight, as
    the frequency-constant route passes one row per utterance."""
    y = torch.as_tensor(_mixture(seed=5, T=40, batch=2)).transpose(-1, -2)
    y = y.reshape(2 * F, D, 40)
    rng = np.random.default_rng(18)
    m = torch.as_tensor(rng.standard_normal((2 * F, K, D))
                        + 1j * rng.standard_normal((2 * F, K, D)),
                        dtype=torch.complex64)
    m = m / torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    kappa = torch.full((2 * F, K), 8.)
    log_norm = torch.full((2 * F, K), 3.)
    weight = torch.tensor([[0.3, 0.7], [0.6, 0.4]])
    shared = mm_stream.mm_stats(y, mode=m, concentration=kappa,
                                log_norm=log_norm, weight=weight,
                                bins_per_weight=F)
    per_bin = mm_stream.mm_stats(y, mode=m, concentration=kappa,
                                 log_norm=log_norm,
                                 weight=weight.repeat_interleave(F, 0))
    for a, b in zip(shared, per_bin):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_mirror_rebuilds_the_hermitian_matrix():
    rng = np.random.default_rng(19)
    a = rng.standard_normal((3, 5, 5)) + 1j * rng.standard_normal((3, 5, 5))
    h = a @ a.conj().transpose(0, 2, 1)
    h = torch.as_tensor((h + h.conj().transpose(0, 2, 1)) / 2)
    rows, cols = torch.triu_indices(5, 5)
    upper = h[:, rows, cols]
    torch.testing.assert_close(mm_stream._mirror(upper, 5), h, atol=0,
                               rtol=0)


def test_trainer_long_route_on_the_cpu_is_the_streamed_twin():
    """use_fused_em=True past the whole-fit gate (T=3828 at D=6, K=3)
    takes the streamed route: the twin, no launch."""
    rng = np.random.default_rng(20)
    Y = torch.as_tensor((rng.standard_normal((2, 3828, 6))
                         + 1j * rng.standard_normal((2, 3828, 6))
                         ).astype(np.complex64))
    before = mm_stream.mm_stats.launches
    model = CWMMTrainer().fit(Y, num_classes=3, iterations=2,
                              use_fused_em=True)
    scan = CWMMTrainer().fit(Y, num_classes=3, iterations=2,
                             use_fused_em=False)
    assert mm_stream.mm_stats.launches == before
    torch.testing.assert_close(model.weight, scan.weight, atol=1e-4, rtol=0)
    torch.testing.assert_close(model.complex_watson.concentration,
                               scan.complex_watson.concentration,
                               rtol=5e-3, atol=1e-2)


def test_kernel_gate():
    assert mm_stream.fits(6, 3) and mm_stream.fits(16, 19)
    assert mm_stream.fits(6, 3, has_sal=True)
    assert not mm_stream.fits(17, 3)


@pytest.mark.parametrize('family', ['watson', 'bingham'])
@pytest.mark.parametrize('D', mm_stream.DIMS)
def test_kernel_instantiations_cover_the_gate(D, family):
    """The kernel is instantiated for every D the gate admits, and its own
    shared memory stays within the card's limit for every K the gate
    admits at that D, in each family."""
    from pb_bss_tpu_torch.ops._build import SMEM_LIMIT
    assert not mm_stream.fits(D, 1 + max(
        k for k in range(1, 200) if mm_stream.fits(D, k, family=family)),
        family=family)
    for k in range(1, 200):
        if mm_stream.fits(D, k, family=family):
            assert mm_stream.kernel_smem_bytes(D, k, family) <= SMEM_LIMIT
    assert mm_stream.kernel_smem_bytes(D, 3, 'bingham') \
        == mm_stream.kernel_smem_bytes(D, 3) + 4 * 2 * 3 * (D * D - D)


@settings(max_examples=80, deadline=None)
@given(N=st.integers(1, 300), T=st.integers(1, 4500),
       capacity=st.integers(1, 1200))
def test_stream_plan_covers_every_frame_once(N, T, capacity):
    """K7's plan (ops/_plan.py, shared with K4): every (bin, frame) falls
    to exactly one CTA; the spans are equal and make whole waves; the
    walk runs CTA by CTA, frames ascending; a bin's pieces take the slots
    0, 1, ... below ``slots`` in the order of their frames, each slot
    written by the CTA that the kernel computes for it."""
    from pb_bss_tpu_torch.ops import _plan
    ctas, span, slots = _plan.partition(N, T, capacity, mm_stream.TILE)
    assert span >= mm_stream.TILE
    assert ctas <= _plan.WAVES * capacity or span == mm_stream.TILE
    assert (ctas - 1) * span < N * T <= ctas * span
    segments = _plan.segments(N, T, span)
    assert [s[0] for s in segments] == sorted(s[0] for s in segments)
    pieces = {}
    for g, n, t0, t1, slot in segments:
        assert 0 <= t0 < t1 <= T and 0 <= slot < slots
        assert g * span <= n * T + t0 and n * T + t1 <= (g + 1) * span
        assert g == n * T // span + slot
        pieces.setdefault(n, []).append((t0, t1, slot))
    assert sorted(pieces) == list(range(N))
    for n, parts in pieces.items():
        assert [p[2] for p in parts] == list(range(len(parts)))
        assert parts[0][0] == 0 and parts[-1][1] == T
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))


def test_stream_plan_at_the_timing_cell():
    """One recording of 513 bins and 4000 frames on a card holding 528
    CTAs: four whole waves, every CTA but the last over the same span, and
    the plan cached per shape."""
    from pb_bss_tpu_torch.ops import _plan
    ctas, span, slots = _plan.partition(513, 4000, 528, mm_stream.TILE)
    assert ctas == _plan.WAVES * 528
    assert span == -(-513 * 4000 // ctas) and slots == 6
    assert _plan.partition(513, 4000, 528, mm_stream.TILE) \
        is _plan.partition(513, 4000, 528, mm_stream.TILE)


@pytest.mark.slow
@pytest.mark.parametrize('weight_mode', ['per_bin', 'fc'])
def test_matches_pallas_interpret(weight_mode):
    """The port's streamed fit against the JAX streamed kernel (interpret
    mode, several time blocks), with saliency."""
    T = 100
    y, aff0 = _mixture(seed=6, T=T), _aff0(21, T=T)
    saliency = np.random.default_rng(22).uniform(
        0.2, 1., (F, T)).astype(np.float32)
    y_dt = np.swapaxes(y, -1, -2)
    ref = pallas_mm_stream.cwmm_em_long(
        jnp.asarray(y_dt.real), jnp.asarray(y_dt.imag), jnp.asarray(aff0),
        iterations=3, tile_t=64, tile_f=128, interpret=True,
        weight_mode=weight_mode, saliency=jnp.asarray(saliency))
    weight, mode, kappa = _stream(y, aff0, 3, weight_mode=weight_mode,
                                  saliency=saliency)
    assert_allclose(weight, np.asarray(ref[0]), atol=1e-4)
    assert_allclose(kappa, np.asarray(ref[2]), rtol=5e-3, atol=1e-2)
    _assert_modes_aligned(mode, ref[1])


# ---- the Bingham family ------------------------------------------------

def _bingham_model(seed):
    """A fixed Bingham model on (F, K): eigenvectors (F, K, D, D),
    ascending eigenvalues with the maximum at 0, weights."""
    rng = np.random.default_rng(seed)
    vec = np.linalg.qr(rng.standard_normal((F, K, D, D))
                       + 1j * rng.standard_normal((F, K, D, D)))[0]
    lam = -np.sort(rng.uniform(0., 30., (F, K, D)), -1)[..., ::-1].copy()
    lam[..., -1] = 0.
    weight = rng.uniform(0.2, 1., (F, K))
    weight /= weight.sum(-1, keepdims=True)
    return (vec.astype(np.complex64), lam.astype(np.float32),
            weight.astype(np.float32))


@pytest.mark.parametrize('mode', ['from_init', 'step'])
def test_bingham_pass_matches_the_jax_statistics(mode):
    """One Bingham statistics pass against the JAX package's E-step
    (with the posterior clip) and a direct sum: sum_t a s y y^H and
    sum_t a s."""
    from pb_bss_tpu.models.cbmm import CBMM as JaxCBMM
    from pb_bss_tpu.models.complex_bingham import ComplexBingham as JaxCB
    from pb_bss_tpu_torch.models.complex_bingham import ComplexBingham
    y, aff0 = _mixture(seed=30, T=60), _aff0(31, T=60)
    saliency = np.random.default_rng(32).uniform(
        0.2, 1., (F, 60)).astype(np.float32)
    y_dt = torch.as_tensor(y).transpose(-1, -2).contiguous()
    if mode == 'from_init':
        kwargs = dict(affiliation=torch.as_tensor(aff0))
        aff = aff0
    else:
        vec, lam, weight = _bingham_model(33)
        log_c = ComplexBingham(
            covariance_eigenvectors=torch.as_tensor(vec),
            covariance_eigenvalues=torch.as_tensor(lam)).log_norm()
        kwargs = dict(eigenvectors=torch.as_tensor(vec),
                      eigenvalues=torch.as_tensor(lam), log_norm=log_c,
                      weight=torch.as_tensor(weight), affiliation_eps=1e-3)
        aff = np.asarray(JaxCBMM(
            weight=jnp.asarray(weight[..., None]),
            complex_bingham=JaxCB(covariance_eigenvectors=jnp.asarray(vec),
                                  covariance_eigenvalues=jnp.asarray(lam))
        )._predict(jnp.asarray(y), affiliation_eps=1e-3))
    before = mm_stream.mm_stats.launches
    scatter, asum = mm_stream.mm_stats(
        y_dt, saliency=torch.as_tensor(saliency), **kwargs)
    assert mm_stream.mm_stats.launches == before  # CPU: the twin
    a = aff * saliency[:, None, :]
    ref = np.einsum('fkt,ftd,fte->fkde', a, y, y.conj())
    assert_allclose(asum.numpy(), a.sum(-1), rtol=1e-4)
    assert np.abs(scatter.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def _assert_bingham_close(weight, lam, ref_weight, ref_lam):
    """The JAX suite's kernel-against-scan tolerances: weights 5e-3,
    eigenvalues rtol 5e-2 / atol 0.5."""
    assert_allclose(weight, ref_weight, atol=5e-3)
    assert_allclose(lam, ref_lam, rtol=5e-2, atol=0.5)


@pytest.mark.parametrize('weight_mode', ['per_bin', 'fc'])
@pytest.mark.parametrize('twin', [False, True], ids=['cpu_route', 'twin'])
def test_cbmm_stream_matches_jax_scan(weight_mode, twin):
    """The streamed Bingham fit with saliency and the posterior clip
    against the JAX scan path: on the CPU (the scan path's solver) and
    the twin of the card's route (the chord solve's twin)."""
    from pb_bss_tpu.models.cbmm import CBMMTrainer as JaxCBMMTrainer
    y, aff0 = _mixture(seed=34, T=60), _aff0(35, T=60)
    saliency = np.random.default_rng(36).uniform(
        0.3, 1., (F, 60)).astype(np.float32)
    fit = mm_stream.cbmm_em_long_reference if twin \
        else mm_stream.cbmm_em_long
    before = mm_stream.mm_stats.launches
    weight, lam, vec = fit(
        torch.as_tensor(y).transpose(-1, -2), torch.as_tensor(aff0),
        iterations=3, weight_mode=weight_mode, spacing_eps=1e-8,
        affiliation_eps=1e-3, saliency=torch.as_tensor(saliency))
    assert mm_stream.mm_stats.launches == before
    scan = JaxCBMMTrainer().fit(
        jnp.asarray(y), initialization=jnp.asarray(aff0), iterations=3,
        use_fused_em=False, saliency=jnp.asarray(saliency),
        affiliation_eps=1e-3, weight_constant_axis=(
            (-1,) if weight_mode == 'per_bin' else (-3, -1)))
    ref_weight = np.asarray(scan.weight)[..., 0]
    assert weight.shape == ((F, K) if weight_mode == 'per_bin' else (K,))
    assert vec.shape == (F, K, D, D) and lam.shape == (F, K, D)
    _assert_bingham_close(
        weight.numpy(), lam.numpy(),
        ref_weight if weight_mode == 'per_bin' else ref_weight[0],
        np.asarray(scan.complex_bingham.covariance_eigenvalues))


def test_cbmm_trainer_long_route_on_the_cpu_is_the_streamed_path():
    """use_fused_em=True past the whole-fit gate (T=3751 at D=6, K=3)
    takes the streamed route: no launch, and the scan path's model."""
    from pb_bss_tpu_torch.models.cbmm import CBMMTrainer
    rng = np.random.default_rng(37)
    Y = torch.as_tensor((rng.standard_normal((2, 3751, 6))
                         + 1j * rng.standard_normal((2, 3751, 6))
                         ).astype(np.complex64))
    before = mm_stream.mm_stats.launches
    model = CBMMTrainer().fit(Y, num_classes=3, iterations=2,
                              use_fused_em=True)
    scan = CBMMTrainer().fit(Y, num_classes=3, iterations=2,
                             use_fused_em=False)
    assert mm_stream.mm_stats.launches == before
    # the E-step and the sums over 3751 frames in two formulas and orders
    _assert_bingham_close(
        model.weight.numpy(), model.complex_bingham.covariance_eigenvalues
        .numpy(), scan.weight.numpy(),
        scan.complex_bingham.covariance_eigenvalues.numpy())


def test_bingham_kernel_gate():
    assert mm_stream.fits(6, 3, family='bingham')
    assert mm_stream.fits(8, 4, has_sal=True, family='bingham')
    assert mm_stream.smem_bytes(6, 3, 'bingham') \
        == mm_stream.smem_bytes(6, 3) + 8 * 3 * 36


@pytest.mark.slow
@pytest.mark.parametrize('weight_mode', ['per_bin', 'fc'])
def test_cbmm_matches_pallas_interpret(weight_mode):
    """The port's streamed Bingham fit against the JAX streamed kernel
    (interpret mode, several time blocks), with saliency and the
    posterior clip."""
    T = 100
    y, aff0 = _mixture(seed=38, T=T), _aff0(39, T=T)
    saliency = np.random.default_rng(40).uniform(
        0.3, 1., (F, T)).astype(np.float32)
    y_dt = np.swapaxes(y, -1, -2)
    ref = pallas_mm_stream.cbmm_em_long(
        jnp.asarray(y_dt.real), jnp.asarray(y_dt.imag), jnp.asarray(aff0),
        iterations=3, tile_t=64, tile_f=128, interpret=True,
        weight_mode=weight_mode, affiliation_eps=1e-3,
        saliency=jnp.asarray(saliency))
    weight, lam, _ = mm_stream.cbmm_em_long(
        torch.as_tensor(y_dt), torch.as_tensor(aff0), iterations=3,
        weight_mode=weight_mode, affiliation_eps=1e-3,
        saliency=torch.as_tensor(saliency))
    _assert_bingham_close(weight.numpy(), lam.numpy(), np.asarray(ref[0]),
                          np.asarray(ref[1]))
