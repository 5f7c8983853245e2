"""Long signals on the CPU: the port's time-blocked EM and blocked
predict against the JAX package's (``_fit_em_t_blocked``,
``_predict_time_last_blocked``) on the same numpy inputs, and
``separate`` on a recording past the time-blocking threshold against
JAX ``separate``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pb_bss_tpu.models.cacgmm as jmc
from pb_bss_tpu.pipeline import separate as jax_separate
from pb_bss_tpu.testing.dummy_data import low_reverberation_data
from pb_bss_tpu_torch import separate
from pb_bss_tpu_torch.evaluation import si_sdr_stft
from pb_bss_tpu_torch.models import cacgmm as mc
from pb_bss_tpu_torch.models.cacgmm import CACGMM, CACGMMTrainer
from pb_bss_tpu_torch.models.complex_angular_central_gaussian import (
    normalize_observation,
)
from pb_bss_tpu_torch.transform.stft_module import stft_frames

torch.set_num_threads(2)

F, D, K, T, T_BLOCK = 5, 6, 3, 700, 256  # 700 = 2 blocks + a padded tail


def _inputs(seed=0, batch=()):
    """Unit-norm time-last y (..., F, D, T) and an initial affiliation."""
    rng = np.random.default_rng(seed)
    shape = (*batch, F, T, D)
    Y = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    y = normalize_observation(torch.as_tensor(Y.astype(np.complex64)))
    aff = rng.uniform(size=(*batch, F, K, T)).astype(np.float32)
    aff /= aff.sum(-2, keepdims=True)
    return y.numpy(), aff


def _numpy_dict(model):
    return jax.tree_util.tree_map(np.asarray, model.to_dict())


def _assert_models_close(port, ref, atol):
    assert_allclose(port.weight.numpy(), np.asarray(ref.weight), atol=atol)
    assert_allclose(port.cacg.covariance_eigenvalues.numpy(),
                    np.asarray(ref.cacg.covariance_eigenvalues), atol=atol)


@pytest.mark.parametrize('batch', [(), (2,)], ids=['unbatched', 'batched'])
def test_t_blocked_em_matches_jax(batch):
    y, aff = _inputs(batch=batch)
    common = dict(iterations=3, eigenvalue_floor=1e-10,
                  affiliation_eps=1e-10, first_e_step=False,
                  eigh_sweeps=None, t_block=T_BLOCK)
    ref = jmc._fit_em_t_blocked(
        jnp.asarray(y), None, jnp.asarray(aff), jnp.ones(aff.shape,
                                                         jnp.float32),
        **common)
    out = mc._fit_em_t_blocked(
        torch.as_tensor(y), None, torch.as_tensor(aff),
        torch.ones(aff.shape), **common)
    assert out.weight.shape == tuple(ref.weight.shape)
    # the same f32 operations in the same order of blocks; three EM
    # iterations amplify the rounding of two Jacobi implementations
    _assert_models_close(out, ref, atol=1e-4)


def test_t_blocked_resume_and_blocked_predict_match_jax():
    y, aff = _inputs(seed=1)
    ref0 = jmc._fit_em_t_blocked(
        jnp.asarray(y), None, jnp.asarray(aff),
        jnp.ones(aff.shape, jnp.float32), iterations=2,
        eigenvalue_floor=1e-10, affiliation_eps=1e-10, first_e_step=False,
        eigh_sweeps=None, t_block=T_BLOCK)
    common = dict(iterations=2, eigenvalue_floor=1e-10,
                  affiliation_eps=1e-10, first_e_step=True,
                  eigh_sweeps=None, t_block=T_BLOCK)
    ref = jmc._fit_em_t_blocked(jnp.asarray(y), ref0, None, None, **common)
    model0 = CACGMM.from_dict(_numpy_dict(ref0))
    out = mc._fit_em_t_blocked(torch.as_tensor(y), model0, None, None,
                               **common)
    _assert_models_close(out, ref, atol=1e-4)

    # the blocked final E-step on one shared model: rounding only
    aff_ref = jmc._predict_time_last_blocked(ref0, jnp.asarray(y),
                                             t_block=T_BLOCK)
    aff_out = mc._predict_time_last_blocked(model0, torch.as_tensor(y),
                                            t_block=T_BLOCK)
    assert aff_out.shape == (F, K, T)
    assert_allclose(aff_out.numpy(), np.asarray(aff_ref), atol=1e-5)
    # and it equals the unblocked predict
    torch.testing.assert_close(
        aff_out, model0._predict(torch.as_tensor(y))[0], atol=1e-6, rtol=0)


def test_int_t_block_fit_equals_the_scan_path():
    Y = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (F, T, D)).astype(np.complex64) * (1 + 1j))
    init = torch.as_tensor(_inputs(seed=2)[1])
    kwargs = dict(initialization=init, iterations=3, use_fused_em=False)
    blocked, aff_b = CACGMMTrainer().fit_predict_model(
        Y, t_block=T_BLOCK, **kwargs)
    scan, aff_s = CACGMMTrainer().fit_predict_model(Y, t_block=None,
                                                    **kwargs)
    # the scan path's operations; only the summation order differs
    torch.testing.assert_close(blocked.weight, scan.weight, atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(aff_b, aff_s, atol=1e-3, rtol=0)


def test_separate_long_recording_matches_jax(monkeypatch):
    """Four concatenated dummy scenarios (19 s) at STFT 512/16: T = 9661
    frames, past T_BLOCK_AUTO_THRESHOLD, so both packages take the
    time-blocked EM (a smaller STFT size would be cheaper, but DHTV has
    defaults only for 512 and 1024 in both packages). The two draw their
    initializations from different random streams, so they are held by
    separation quality."""
    calls = {'port': 0, 'jax': 0}
    for module, name in ((mc, 'port'), (jmc, 'jax')):
        real = module._fit_em_t_blocked

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, '_fit_em_t_blocked', counted)
    data = [low_reverberation_data(seed) for seed in (1, 2, 3, 4)]
    observation = np.concatenate(
        [d['observation'] for d in data], -1).astype(np.float32)
    images = torch.as_tensor(np.concatenate(
        [d['speech_image'][:, 0] for d in data], -1))
    assert stft_frames(observation.shape[-1], 512, 16) \
        > mc.T_BLOCK_AUTO_THRESHOLD
    out = separate(torch.as_tensor(observation), iterations=10,
                   stft_shift=16, beamformer='gev+ban')
    ref = np.array(jax_separate(jnp.asarray(observation), iterations=10,
                                stft_shift=16, beamformer='gev+ban'))
    assert calls == {'port': 1, 'jax': 1}
    assert out.shape == (3, observation.shape[-1])
    assert torch.isfinite(out).all()
    ours = si_sdr_stft(images[:, None], out[None].double()).max(-1).values
    theirs = si_sdr_stft(images[:, None],
                         torch.as_tensor(ref)[None].double()).max(-1).values
    # best estimate per speaker: measured within 1.3 dB of each other
    # here; different random initializations, so allow 3 dB
    assert ((ours - theirs).abs() < 3.0).all(), (ours, theirs)
