"""The plain twin of the whole-fit integration kernel K12
(pb_bss_tpu_torch.ops.integration_em_loop) on the CPU: the vMF log
normalizer table against scipy (as tests/test_ops/
test_pallas_integration_em_loop.py holds the JAX table), the twin's warm
step, and the twin through the trainers' forced 'loop' route against the
JAX package's scan fits on the same numpy inputs, at the JAX suite's
tolerances for its whole-fit kernel against its per-iteration path. The
JAX whole-fit Pallas kernel in interpret mode is held in the slow tier."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from scipy.special import ive

from pb_bss_tpu.models.gcacgmm import GCACGMMTrainer as JaxG
from pb_bss_tpu.models.vmfcacgmm import VMFCACGMMTrainer as JaxV
from pb_bss_tpu.ops.pallas_integration_em_loop import (
    acc_rows as jax_acc_rows,
    spec_rows as jax_spec_rows,
    vmf_log_norm_table as jax_table,
)
from pb_bss_tpu_torch.models.gcacgmm import GCACGMMTrainer
from pb_bss_tpu_torch.models.vmfcacgmm import VMFCACGMMTrainer
from pb_bss_tpu_torch.ops import integration_em_loop
from pb_bss_tpu_torch.ops.integration_em_loop import (
    acc_rows,
    interpolate_log_norm,
    spec_rows,
    vmf_log_norm_table,
    warm_eigh,
)

torch.set_num_threads(2)


def _problem(F=13, T=24, D=3, E=6, K=2, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    shape = (*batch, F)
    atf = rng.standard_normal((*shape, D, K)) + 1j * rng.standard_normal(
        (*shape, D, K))
    s = rng.standard_normal((*shape, K, T)) + 1j * rng.standard_normal(
        (*shape, K, T))
    y = np.einsum('...dk,...kt->...dt', atf, s) + 0.2 * (
        rng.standard_normal((*shape, D, T))
        + 1j * rng.standard_normal((*shape, D, T)))
    obs = np.swapaxes(y, -1, -2).astype(np.complex64)  # (..., T, D)
    obs /= np.linalg.norm(obs, axis=-1, keepdims=True)
    emb = rng.standard_normal((*shape, T, E)).astype(np.float32)
    init = rng.uniform(size=(*shape, K, T)).astype(np.float32)
    return obs, emb, init / init.sum(-2, keepdims=True)


@pytest.mark.parametrize('dim', [2, 6, 20])
def test_vmf_log_norm_table_accuracy(dim):
    """The kernel's two-load interpolation of the sqrt-spaced table
    against the exact value over the clipped concentration range (the
    JAX suite's 2e-4), and the table itself equals the JAX package's."""
    s0, ds, values = vmf_log_norm_table(dim, 1e-10, 500.0)
    j0, jds, jvalues = jax_table(dim, 1e-10, 500.0)
    assert (s0, ds) == (j0, jds)
    np.testing.assert_array_equal(values, jvalues)
    nu = dim / 2 - 1
    kappa = np.concatenate([np.logspace(-10, np.log10(500), 2001),
                            np.linspace(1e-6, 500, 2001)])
    exact = ((dim / 2) * np.log(2 * np.pi) + np.log(ive(nu, kappa)) + kappa
             - nu * np.log(kappa))
    interp = interpolate_log_norm(torch.as_tensor(kappa, dtype=torch.float32),
                                  torch.as_tensor(values), s0, ds).numpy()
    assert np.abs(interp - exact).max() < 2e-4


def test_row_counts_match_jax():
    for mode in ('vmf', 'gaussian'):
        assert spec_rows(20, 3, mode) == jax_spec_rows(20, 3, mode)
        assert acc_rows(20, 3, mode) == jax_acc_rows(20, 3, mode)


def test_the_warm_step_diagonalizes_the_new_covariance():
    """The twin's M-step rotates the new covariance into the previous
    eigenbasis and sweeps from there: from a basis near the new one (1%
    off), two sweeps diagonalize it as six cold sweeps do (~2e-6 of the
    largest entry), where two cold sweeps, or none after the rotation,
    leave ~1e-1 and ~4e-2."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((50, 6, 6)) + 1j * rng.standard_normal((50, 6, 6))
    cov = torch.as_tensor((a @ np.conj(np.swapaxes(a, -1, -2))).astype(
        np.complex64))
    _, exact = torch.linalg.eigh(cov)
    noise = torch.as_tensor((0.01 * (rng.standard_normal((50, 6, 6))
                                     + 1j * rng.standard_normal((50, 6, 6))))
                            .astype(np.complex64))
    previous = torch.linalg.qr(exact + noise)[0]

    def residual(values, vectors):
        rebuilt = vectors @ torch.diag_embed(values.to(cov.dtype)) \
            @ vectors.conj().transpose(-1, -2)
        return ((rebuilt - cov).abs().amax((-2, -1))
                / cov.abs().amax((-2, -1))).max().item()

    values, vectors = warm_eigh(cov, previous, 2)
    assert residual(values, vectors) < 1e-5
    eye = torch.eye(6, dtype=cov.dtype)
    assert (vectors.conj().transpose(-1, -2) @ vectors - eye).abs().max() \
        < 1e-5
    assert residual(*warm_eigh(cov, previous, 0)) > 1e-2
    assert residual(*warm_eigh(cov, torch.eye(6, dtype=cov.dtype).expand(
        50, 6, 6), 2)) > 1e-2


def _assert_model_close(m_loop, m_ref, atol):
    for name, a, b in [
            ('weight', m_loop.weight, m_ref.weight),
            ('eigenvalues', m_loop.cacg.covariance_eigenvalues,
             m_ref.cacg.covariance_eigenvalues)]:
        assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                        atol=atol, err_msg=name)


def _loop(trainer, obs, emb, init, **kw):
    """The twin through the trainer's forced 'loop' route (no launch on
    the CPU)."""
    before = integration_em_loop.integration_em_full.launches
    model = trainer.fit(torch.as_tensor(obs), torch.as_tensor(emb),
                        initialization=torch.as_tensor(init),
                        use_fused_em='loop', **kw)
    assert integration_em_loop.integration_em_full.launches == before
    return model


@pytest.mark.parametrize('weights', [(1., 1.), (0.5, 2.)])
def test_vmf_loop_twin_matches_the_jax_scan(weights):
    obs, emb, init = _problem()
    kw = dict(iterations=3, spatial_weight=weights[0],
              spectral_weight=weights[1])
    m_l = _loop(VMFCACGMMTrainer(), obs, emb, init, **kw)
    m_s = JaxV().fit(jnp.asarray(obs), jnp.asarray(emb),
                     initialization=jnp.asarray(init), use_fused_em=False,
                     **kw)
    _assert_model_close(m_l, m_s, atol=5e-4)
    assert_allclose(m_l.vmf.mean.numpy(), np.asarray(m_s.vmf.mean),
                    atol=5e-4)
    assert_allclose(m_l.vmf.concentration.numpy(),
                    np.asarray(m_s.vmf.concentration), atol=5e-3)
    a_l = m_l.predict(torch.as_tensor(obs), torch.as_tensor(emb)).numpy()
    a_s = np.asarray(m_s.predict(jnp.asarray(obs), jnp.asarray(emb)))
    assert np.abs(a_l - a_s).mean() < 1e-3


@pytest.mark.parametrize('covariance_type', ['spherical', 'diagonal'])
def test_gaussian_loop_twin_matches_the_jax_scan(covariance_type):
    obs, emb, init = _problem(seed=3)
    kw = dict(iterations=3, covariance_type=covariance_type)
    m_l = _loop(GCACGMMTrainer(), obs, emb, init, **kw)
    m_s = JaxG().fit(jnp.asarray(obs), jnp.asarray(emb),
                     initialization=jnp.asarray(init), use_fused_em=False,
                     **kw)
    _assert_model_close(m_l, m_s, atol=5e-4)
    assert_allclose(m_l.gaussian.mean.numpy(), np.asarray(m_s.gaussian.mean),
                    atol=1e-3)
    assert_allclose(m_l.gaussian.covariance.numpy(),
                    np.asarray(m_s.gaussian.covariance), rtol=2e-3,
                    atol=1e-5)


def test_loop_twin_batched_fold():
    """(B, F, T, D): each utterance carries its own spectral state; the
    batched fit equals the single fit of an utterance (f32 sums in other
    orders) and the JAX scan of the batch."""
    obs, emb, init = _problem(batch=(2,), seed=5)
    tr = VMFCACGMMTrainer()
    m_l = _loop(tr, obs, emb, init, iterations=3)
    assert m_l.vmf.mean.shape == (2, 2, 6)
    assert m_l.weight.shape == (2, 13, 2)
    m_s = JaxV().fit(jnp.asarray(obs), jnp.asarray(emb),
                     initialization=jnp.asarray(init), iterations=3,
                     use_fused_em=False)
    _assert_model_close(m_l, m_s, atol=5e-4)
    assert_allclose(m_l.vmf.mean.numpy(), np.asarray(m_s.vmf.mean),
                    atol=5e-4)
    m_0 = _loop(tr, obs[0], emb[0], init[0], iterations=3)
    assert_allclose(m_l.vmf.mean[0].numpy(), m_0.vmf.mean.numpy(), atol=2e-3)
    assert_allclose(m_l.weight[0].numpy(), m_0.weight.numpy(), atol=1e-5)


def test_loop_with_saliency_asserts():
    obs, emb, init = _problem(F=4, T=10)
    with pytest.raises(AssertionError, match='saliency'):
        VMFCACGMMTrainer().fit(
            torch.as_tensor(obs), torch.as_tensor(emb),
            initialization=torch.as_tensor(init), iterations=3,
            saliency=torch.ones(4, 10), use_fused_em='loop')


def test_gate():
    assert integration_em_loop.fits(6, 3, 20, 'vmf')
    assert integration_em_loop.fits(6, 3, 20, 'gaussian')
    assert not integration_em_loop.fits(17, 3, 20, 'vmf')
    assert not integration_em_loop.fits(6, 3, 2000, 'gaussian')


@pytest.mark.parametrize('mode', ['vmf', 'gaussian'])
@pytest.mark.parametrize('ctas', [2, 3, 4])
@pytest.mark.parametrize('D', [1, 6, 8, 16])
def test_frames_per_tile_fits_the_sm_share(D, ctas, mode):
    """The host's frame tile: all T where ``ctas`` CTAs an SM keep room
    for it in the SM's shared memory, else the fewest equal tiles that
    cover T within that share (within the block limit where even 32
    frames exceed the share). Config 3 (D=6, K=3, E=20, T=300) at four
    CTAs an SM takes all its frames in one tile."""
    from pb_bss_tpu_torch.ops._build import SM_SMEM, SMEM_LIMIT
    K, E = 3, 20

    def smem(tile):
        return integration_em_loop.smem_bytes(D, K, E, mode, tile)

    share = SM_SMEM // ctas - 1024
    for T in (1, 31, 300, 301, 4000):
        tile = integration_em_loop.frames_per_tile(D, K, E, T, mode, ctas)
        budget = share if smem(min(T, 32)) <= share else SMEM_LIMIT
        tiles = -(-T // tile)
        assert 1 <= tile <= T and tile == -(-T // tiles)
        assert smem(tile) <= budget
        if tiles > 1:
            assert smem(-(-T // (tiles - 1))) > budget
    if (D, ctas) == (6, 4):
        assert integration_em_loop.frames_per_tile(6, 3, 20, 300, mode,
                                                   4) == 300


@pytest.mark.slow
@pytest.mark.parametrize('model', ['vmf', 'spherical'])
def test_loop_twin_matches_the_jax_loop_kernel_in_interpret_mode(model):
    obs, emb, init = _problem(seed=7)
    if model == 'vmf':
        ours, theirs, kw = VMFCACGMMTrainer(), JaxV(), {}
    else:
        ours, theirs, kw = GCACGMMTrainer(), JaxG(), dict(
            covariance_type='spherical')
    m_l = _loop(ours, obs, emb, init, iterations=3, **kw)
    m_j = theirs.fit(jnp.asarray(obs), jnp.asarray(emb),
                     initialization=jnp.asarray(init), iterations=3,
                     use_fused_em='loop', **kw)
    _assert_model_close(m_l, m_j, atol=5e-4)
