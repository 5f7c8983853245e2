"""cACGMM EM of the port (pb_bss_tpu_torch.models.cacgmm and the plain
twin of the whole-fit kernel, ops/em_loop.py) against the JAX package
on the same numpy inputs.

Fit trajectories are exponentially sensitive to f32 rounding in
ambiguous bins, so single steps are held tightly and fits by
oracle-mask quality."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.cacgmm import CACGMMTrainer as JaxTrainer
from pb_bss_tpu.models.cacgmm import _m_step as jax_m_step
from pb_bss_tpu.ops import pallas_em_loop
from pb_bss_tpu.testing.dummy_data import low_reverberation_data
from pb_bss_tpu.transform import stft as jstft
from pb_bss_tpu_torch.models.cacgmm import CACGMM, CACGMMTrainer, _m_step
from pb_bss_tpu_torch.ops import em_loop

torch.set_num_threads(2)


def _mixture(F=9, D=6, T=40, K=3, seed=0):
    rng = np.random.default_rng(seed)
    atf = rng.standard_normal((F, D, 2)) + 1j * rng.standard_normal(
        (F, D, 2))
    s = rng.standard_normal((F, 2, T)) + 1j * rng.standard_normal((F, 2, T))
    y = np.einsum('fdk,fkt->fdt', atf, s) + 0.3 * (
        rng.standard_normal((F, D, T)) + 1j * rng.standard_normal((F, D, T)))
    y = (y / np.linalg.norm(y, axis=1, keepdims=True)).astype(np.complex64)
    aff0 = rng.uniform(size=(F, K, T)).astype(np.float32)
    aff0 /= aff0.sum(1, keepdims=True)
    qf0 = np.ones((F, K, T), np.float32)
    return y, aff0, qf0


def _run_both(iterations, **mixture):
    y, aff0, qf0 = _mixture(**mixture)
    ref = pallas_em_loop.cacgmm_em_full_reference(
        jnp.asarray(y.real, jnp.float32), jnp.asarray(y.imag, jnp.float32),
        jnp.asarray(aff0), jnp.asarray(qf0), iterations=iterations,
        sweeps=6)
    out = em_loop.cacgmm_em_full(
        torch.as_tensor(y), torch.as_tensor(aff0), torch.as_tensor(qf0),
        iterations=iterations, sweeps=6, warm_sweeps=2)
    return [np.asarray(x) for x in ref], [x.numpy() for x in out]


def test_one_step_matches_jax():
    """One M-step + E-step from a shared initial affiliation at D=6
    (where padded-lane 0*inf bugs would show)."""
    ref, out = _run_both(1)
    # weights: means of the same affiliations (summation order only)
    assert_allclose(out[0], ref[0], atol=1e-6)
    # eigenvalues: two f32 Jacobi runs of the same algorithm
    assert_allclose(out[1], ref[1], atol=2e-5)
    # eigenvectors up to a per-vector phase
    overlap = np.abs(np.einsum('fkde,fkde->fkd', out[2].conj(), ref[2]))
    assert overlap.min() > 1 - 1e-4
    # affiliations: exponentially sensitive to eigenvalue rounding
    assert_allclose(out[3], ref[3], atol=1e-4)
    assert out[3].dtype == np.float32 and out[2].dtype == np.complex64


@pytest.mark.parametrize('knobs', [
    dict(weight_constant_axis=(-3, -1), covariance_norm='eigenvalue'),
    dict(weight_constant_axis=-2, covariance_norm='eigenvalue'),
    dict(weight_constant_axis=(-1,), covariance_norm='trace'),
    dict(weight_constant_axis=(-1,), covariance_norm='eigenvalue',
         saliency=True),
])
def test_scan_m_and_e_step_match_jax(knobs):
    """One M-step and one E-step of the plain loop under the knobs the
    whole-fit route does not take (frequency-constant or fixed weights,
    trace normalization, saliency)."""
    knobs = dict(knobs)
    y, aff0, qf0 = _mixture()
    saliency = None
    if knobs.pop('saliency', False):
        saliency = np.random.default_rng(5).uniform(
            0.2, 1., size=(y.shape[0], y.shape[-1])).astype(np.float32)
    common = dict(hermitize=True, eigenvalue_floor=1e-10, **knobs)
    ref = jax_m_step(
        jnp.asarray(y), jnp.asarray(qf0), jnp.asarray(aff0),
        None if saliency is None else jnp.asarray(saliency), **common)
    out = _m_step(
        torch.as_tensor(y), torch.as_tensor(qf0), torch.as_tensor(aff0),
        None if saliency is None else torch.as_tensor(saliency), **common)
    assert_allclose(out.weight.numpy(), np.asarray(ref.weight), atol=1e-6)
    assert_allclose(out.cacg.covariance_eigenvalues.numpy(),
                    np.asarray(ref.cacg.covariance_eigenvalues), atol=2e-5)
    aff_ref, qf_ref, _ = ref._predict(jnp.asarray(y), affiliation_eps=1e-10)
    aff, qf, _ = out._predict(torch.as_tensor(y), affiliation_eps=1e-10)
    assert_allclose(qf.numpy(), np.asarray(qf_ref), rtol=1e-4)
    assert_allclose(aff.numpy(), np.asarray(aff_ref), atol=1e-4)


@pytest.mark.slow
def test_plain_twin_matches_pallas_interpret():
    """The port's plain twin against the Pallas kernel itself
    (interpret mode, cold Jacobi every iteration like the twin),
    5 iterations, ragged T."""
    y, aff0, qf0 = _mixture(T=37)
    ref = pallas_em_loop.cacgmm_em_full(
        jnp.asarray(y.real, jnp.float32), jnp.asarray(y.imag, jnp.float32),
        jnp.asarray(aff0), jnp.asarray(qf0), iterations=5, sweeps=6,
        interpret=True)
    out = em_loop.cacgmm_em_full_reference(
        torch.as_tensor(y), torch.as_tensor(aff0), torch.as_tensor(qf0),
        iterations=5, sweeps=6)
    assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=5e-5)
    assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=5e-5)
    assert_allclose(out[3].numpy(), np.asarray(ref[3]), atol=5e-3)


def _scenario(F_step=16, T=300):
    """A dummy-data STFT (every 16th bin, 300 frames) with its oracle
    labels (speaker 1, speaker 2, noise) and the speech-dominated
    points (one speaker 6 dB above the noise) where they are scored."""
    data = low_reverberation_data(0)

    def spec(x):
        X = np.asarray(jstft(jnp.asarray(x, jnp.float32)))
        return X[..., :T, ::F_step]  # (..., T, F)

    Y = spec(data['observation']).transpose(2, 1, 0)  # (F, T, D)
    energies = np.stack([
        np.abs(spec(data['speech_image'][0, 0])) ** 2,
        np.abs(spec(data['speech_image'][1, 0])) ** 2,
        np.abs(spec(data['noise_image'][0])) ** 2]).transpose(0, 2, 1)
    oracle = energies.argmax(0)  # (F, T)
    scored = (oracle != 2) & (energies[:2].max(0) > 4 * energies[2])
    return np.ascontiguousarray(Y, np.complex64), oracle, scored


def _oracle_accuracy(affiliation, oracle, scored):
    """Per-bin best-permutation agreement of argmax(affiliation) with
    the oracle class on the scored points, averaged over bins."""
    labels = affiliation.argmax(1)  # (F, T)
    accs = []
    for f in range(labels.shape[0]):
        if scored[f].any():
            accs.append(max(
                np.mean(np.asarray(perm)[labels[f]][scored[f]]
                        == oracle[f][scored[f]])
                for perm in itertools.permutations(range(3))))
    return float(np.mean(accs))


def test_fit_quality_matches_jax():
    """10-iteration fits from the same explicit initialization, held by
    oracle-mask accuracy."""
    Y, oracle, scored = _scenario()
    F, T, _ = Y.shape
    rng = np.random.default_rng(4)
    init = rng.uniform(size=(F, 3, T)).astype(np.float32)
    init /= init.sum(1, keepdims=True)
    aff_j = np.asarray(JaxTrainer().fit_predict(
        jnp.asarray(Y), initialization=jnp.asarray(init), iterations=10))
    aff_t = CACGMMTrainer().fit_predict(
        torch.as_tensor(Y), initialization=torch.as_tensor(init),
        iterations=10).numpy()
    acc_j = _oracle_accuracy(aff_j, oracle, scored)
    acc_t = _oracle_accuracy(aff_t, oracle, scored)
    assert acc_j > 0.65, acc_j  # the fit separates at all
    # trajectories may part in ambiguous bins; quality must not
    assert abs(acc_t - acc_j) < 0.03, (acc_t, acc_j)


def test_fused_route_on_cpu_equals_scan_path():
    """use_fused_em=True on the CPU runs the kernel's plain twin, which
    performs the same operations as the scan path."""
    y, aff0, _ = _mixture(F=5, T=30)
    Y = torch.as_tensor(y).transpose(-1, -2)
    kwargs = dict(initialization=torch.as_tensor(aff0), iterations=3)
    a = CACGMMTrainer().fit_predict(Y, use_fused_em=False, **kwargs)
    before = em_loop.cacgmm_em_full.launches
    b = CACGMMTrainer().fit_predict(Y, use_fused_em=True, **kwargs)
    assert em_loop.cacgmm_em_full.launches == before  # CPU: no launch
    assert_allclose(b.numpy(), a.numpy(), atol=1e-6)


@pytest.mark.parametrize('use_fused_em', [False, True])
def test_saliency_and_source_activity_mask_match_jax(use_fused_em):
    """Saliency-weighted statistics and boolean class gating, through
    the plain loop and through the kernel's plain twin, against the
    JAX scan path from the same initialization."""
    rng = np.random.default_rng(6)
    Y = (rng.standard_normal((5, 40, 4))
         + 1j * rng.standard_normal((5, 40, 4))).astype(np.complex64)
    saliency = rng.uniform(0.2, 1., (5, 40)).astype(np.float32)
    mask = rng.uniform(size=(5, 3, 40)) > 0.2
    mask[:, 0] |= ~mask.any(1)  # no frame with every class gated
    init = rng.uniform(size=(5, 3, 40)).astype(np.float32)
    init /= init.sum(1, keepdims=True)
    ref = np.asarray(JaxTrainer().fit_predict(
        jnp.asarray(Y), initialization=jnp.asarray(init), iterations=3,
        saliency=jnp.asarray(saliency),
        source_activity_mask=jnp.asarray(mask), use_fused_em=False))
    out = CACGMMTrainer().fit_predict(
        torch.as_tensor(Y), initialization=torch.as_tensor(init),
        iterations=3, saliency=torch.as_tensor(saliency),
        source_activity_mask=torch.as_tensor(mask),
        use_fused_em=use_fused_em).numpy()
    # the same operations in f32 on both sides; rounding only
    assert_allclose(out, ref, atol=1e-5)
    assert np.all(out[~mask] == 0)


def _jax_model_to_numpy_dict(model):
    """A JAX model's to_dict() with every array converted by
    np.asarray — the form the port's from_dict takes."""
    return jax.tree_util.tree_map(np.asarray, model.to_dict())


def test_jax_model_carried_across_predicts_the_same():
    y, _, _ = _mixture(F=7, T=50)
    Y = np.ascontiguousarray(y.transpose(0, 2, 1))  # (F, T, D)
    jax_model = JaxTrainer().fit(
        jnp.asarray(Y), num_classes=3, iterations=4,
        key=jax.random.key(1))
    model = CACGMM.from_dict(_jax_model_to_numpy_dict(jax_model))
    assert isinstance(model.cacg.covariance_eigenvalues, torch.Tensor)
    ref = np.asarray(jax_model.predict(jnp.asarray(Y)))
    out = model.predict(torch.as_tensor(Y)).numpy()
    # same formulas on the same f32 parameters; rounding only
    assert_allclose(out, ref, atol=1e-5)
    back = CACGMM.from_dict(model.to_dict())
    assert torch.equal(back.weight, model.weight)


def test_kernel_gate():
    assert em_loop.max_frames(6, 3) == 3178
    assert em_loop.fits(6, 3, 3178) and not em_loop.fits(6, 3, 3179)
    assert em_loop.fits(16, 3, 300) and not em_loop.fits(17, 3, 10)
    assert em_loop.smem_bytes(6, 3, 304) < 48 * 1024


@pytest.mark.parametrize('kwargs', [
    dict(use_fused_em=True, weight_constant_axis=(-3, -1)),
    dict(use_pallas_em=True),
], ids=['fc_route', 'use_pallas_em'])
def test_kernel_routes_run_their_twins_like_the_scan_path(kwargs):
    """The frequency-constant route (K5's plain twins) and the
    use_pallas_em route (K11's scatter twin) on the CPU launch nothing
    and agree with the port's scan path over one M-step, E-step and
    M-step (two f32 formulas of the same statistics; K5 warm-starts its
    Jacobi, whose rounding later E-steps amplify in ambiguous bins)."""
    from pb_bss_tpu_torch.ops import em_estep, em_step
    y, aff0, _ = _mixture(F=3, T=20)
    Y = torch.as_tensor(y).transpose(-1, -2)
    common = dict(initialization=torch.as_tensor(aff0), iterations=2,
                  affiliation_eps=0,
                  weight_constant_axis=kwargs.get('weight_constant_axis',
                                                  (-1,)))
    before = (em_step.m_init.launches, em_step.em_step.launches,
              em_estep.cacgmm_em_scatter.launches)
    out = CACGMMTrainer().fit(Y, **{**common, **kwargs})
    scan = CACGMMTrainer().fit(Y, use_fused_em=False, **common)
    assert (em_step.m_init.launches, em_step.em_step.launches,
            em_estep.cacgmm_em_scatter.launches) == before
    torch.testing.assert_close(out.weight, scan.weight, atol=1e-6, rtol=0)
    torch.testing.assert_close(out.cacg.covariance_eigenvalues,
                               scan.cacg.covariance_eigenvalues, atol=1e-5,
                               rtol=0)


def test_past_the_gate_runs_the_streamed_twin(monkeypatch):
    """use_fused_em=True past the whole-fit gate (T=3200 at D=6, K=3)
    takes the streamed route (K4's plain twin on the CPU, no launch) and
    performs the scan path's operations."""
    import pb_bss_tpu_torch.models.cacgmm as mc
    from pb_bss_tpu_torch.ops import em_stream
    rng = np.random.default_rng(0)
    Y = torch.as_tensor((rng.standard_normal((2, 3200, 6))
                         + 1j * rng.standard_normal((2, 3200, 6))
                         ).astype(np.complex64))
    routes = []
    real = mc._fit_fused_stream

    def counted(*args, **kwargs):
        routes.append(kwargs['weight_mode'])
        return real(*args, **kwargs)

    monkeypatch.setattr(mc, '_fit_fused_stream', counted)
    before = em_stream.e_stats.launches
    kwargs = dict(num_classes=3, iterations=2, t_block=None)
    stream = CACGMMTrainer().fit(Y, use_fused_em=True, **kwargs)
    scan = CACGMMTrainer().fit(Y, use_fused_em=False, **kwargs)
    assert routes == ['per_bin']
    assert em_stream.e_stats.launches == before
    # the same operations; the summation order over T differs
    torch.testing.assert_close(stream.weight, scan.weight, atol=2e-4,
                               rtol=0)
    torch.testing.assert_close(stream.cacg.covariance_eigenvalues,
                               scan.cacg.covariance_eigenvalues, atol=2e-4,
                               rtol=0)


def test_default_generator_is_seeded_zero():
    y, _, _ = _mixture(F=3, T=20)
    Y = torch.as_tensor(y).transpose(-1, -2)
    a = CACGMMTrainer().fit(Y, num_classes=3, iterations=2)
    b = CACGMMTrainer().fit(
        Y, num_classes=3, iterations=2,
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.weight, b.weight)


@pytest.mark.parametrize('D', em_loop.DIMS)
def test_kernel_instantiations_cover_the_gate(D):
    """The kernel is instantiated for every D the gate admits, and its own
    shared memory stays within the card's limit for every (K, T, extras)
    the gate admits at that D (at the longest T, where it binds)."""
    from pb_bss_tpu_torch.ops._build import SMEM_LIMIT
    for K in (1, 2, 3, 4, 8, 19):
        for extras in itertools.product((False, True), repeat=2):
            T = em_loop.max_frames(D, K, *extras)
            if T < 1:
                continue
            assert em_loop.fits(D, K, T, *extras)
            assert em_loop.kernel_smem_bytes(D, K, T) <= SMEM_LIMIT
            assert em_loop.kernel_smem_bytes(D, K, T) \
                <= em_loop.smem_bytes(D, K, T, *extras)


def test_threads_fill_the_rounds_of_frames():
    """The CTA's threads follow T: whole warps, at most 8, at least one
    warp per floor(32 / D) classes (up to 8), the thread-per-frame
    rounds of the E-step leave at most one partial warp each, and the
    CTAs that an SM's shared memory holds come to about 32 warps."""
    for D, K, T in itertools.product((2, 6, 8, 16), (1, 2, 3, 8, 19),
                                     (1, 31, 32, 33, 150, 300, 304, 1000,
                                      3178)):
        threads = em_loop._threads(D, K, T)
        warps = threads // 32
        assert threads % 32 == 0 and 1 <= warps <= 8
        assert warps >= min(8, -(-K // (32 // D)))
        rounds = -(-T // threads)
        if warps > -(-K // (32 // D)):
            # frames fill every round but the last warp of the last
            assert rounds * threads - T < 32 * rounds
    # the slice shape: 9 CTAs an SM by shared memory, 4 warps each, 3
    # rounds of 128 threads for 304 frames
    assert em_loop._threads(6, 3, 304) == 128
    assert em_loop._threads(6, 3, 300) == 128
    # the longest T: one CTA an SM, eight warps
    assert em_loop._threads(6, 3, 3178) == 256
