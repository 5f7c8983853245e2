"""The port's block-online cACGMM (pb_bss_tpu_torch.models.
cacgmm_streaming) against the JAX package's on the same seeded numpy
inputs (complex64): one streaming step from a state carried across with
``from_dict``, the stream state of a carried-across model on its first
block, and the port's own properties as the JAX tests hold them (the
``update`` loop equals ``fit_predict_stream``, block-size invariance, the
truncated trailing block, tracking a switching scene)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.cacgmm import CACGMMTrainer as JaxTrainer
from pb_bss_tpu.models.cacgmm_streaming import (
    StreamingCACGMM as JaxStreaming,
    _update_block as jax_update_block,
)
from pb_bss_tpu.models.complex_angular_central_gaussian import (
    normalize_observation as jax_normalize,
)
from pb_bss_tpu_torch.models.cacgmm import CACGMM, CACGMMTrainer
from pb_bss_tpu_torch.models.cacgmm_streaming import (
    StreamingCACGMM,
    StreamingCACGMMState,
    _update_block,
)
from pb_bss_tpu_torch.models.complex_angular_central_gaussian import (
    normalize_observation,
)

torch.set_num_threads(2)

F, D, K, T = 16, 3, 2, 400


def _sample(seed=0, F=F, D=D, K=K, T=T):
    """(F, T, D) unit-norm complex64 observations of K planted classes
    and their labels."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((F, K, D, 2)) + 1j * rng.standard_normal(
        (F, K, D, 2))
    cov = np.einsum('fkdr,fker->fkde', a, a.conj()) + 0.1 * np.eye(D)
    labels = rng.integers(0, K, size=(F, T))
    chol = np.linalg.cholesky(cov)
    g = rng.standard_normal((F, T, D)) + 1j * rng.standard_normal(
        (F, T, D))
    y = np.einsum('ftde,fte->ftd', chol[np.arange(F)[:, None], labels], g)
    y /= np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), 1e-30)
    return y.astype(np.complex64), labels


def _oracle_mse(affiliation, labels, K=K):
    one_hot = np.einsum('ftk->fkt', np.eye(K)[labels])
    aff = np.asarray(affiliation)
    best = np.full(aff.shape[0], np.inf)
    for perm in itertools.permutations(range(K)):
        best = np.minimum(
            best, np.mean((aff[:, perm, :] - one_hot) ** 2, axis=(1, 2)))
    return float(np.mean(best))


def _to_numpy_tree(d):
    return {k: _to_numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in d.items()}


def _covariance(eigenvectors, eigenvalues):
    return np.einsum('...dx,...x,...ex->...de', eigenvectors, eigenvalues,
                     np.conj(eigenvectors))


def _jax_state(y, seed, t_block, **kwargs):
    stream = JaxStreaming(K, init_iterations=5, **kwargs)
    state, _ = stream.init_state(jnp.asarray(y[:, :t_block]),
                                 key=jax.random.key(seed))
    return stream, state


@pytest.mark.parametrize('inner_iterations,forgetting',
                         [(1, 0.999), (2, 0.97)])
def test_update_block_matches_jax_from_a_carried_state(inner_iterations,
                                                      forgetting):
    y, _ = _sample(seed=0)
    t_block = 50
    _, state = _jax_state(y, 1, t_block)
    block = y[:, t_block:2 * t_block]
    kwargs = dict(inner_iterations=inner_iterations, forgetting=forgetting,
                  affiliation_eps=1e-10, eigenvalue_floor=1e-10,
                  eigh_sweeps=None)
    jax_state, jax_aff = jax_update_block(
        state, jax_normalize(jnp.asarray(block)), **kwargs)

    ours = StreamingCACGMMState.from_dict(_to_numpy_tree(state.to_dict()))
    new, aff = _update_block(ours, normalize_observation(
        torch.as_tensor(block)), **kwargs)
    # one E-step and M-step in f32 from the same state (two summation
    # orders of the scatter, the same cyclic Jacobi)
    assert_allclose(aff.numpy(), np.asarray(jax_aff), atol=2e-5)
    assert_allclose(new.scatter.numpy(), np.asarray(jax_state.scatter),
                    atol=2e-5, rtol=1e-5)
    assert_allclose(new.count.numpy(), np.asarray(jax_state.count),
                    rtol=1e-5)
    assert_allclose(new.frames.numpy(), np.asarray(jax_state.frames),
                    rtol=1e-6)
    assert_allclose(new.model.weight.numpy(),
                    np.asarray(jax_state.model.weight), atol=1e-6)
    cacg, jax_cacg = new.model.cacg, jax_state.model.cacg
    assert_allclose(cacg.covariance_eigenvalues.numpy(),
                    np.asarray(jax_cacg.covariance_eigenvalues),
                    atol=2e-5, rtol=1e-4)
    assert_allclose(
        _covariance(cacg.covariance_eigenvectors.numpy(),
                    cacg.covariance_eigenvalues.numpy()),
        _covariance(np.asarray(jax_cacg.covariance_eigenvectors),
                    np.asarray(jax_cacg.covariance_eigenvalues)),
        atol=5e-5)


def test_state_from_first_block_of_a_carried_model_matches_jax():
    """init_state's second half: the statistics of a fitted model (the
    JAX package's, carried across) on its first block."""
    y, _ = _sample(seed=2)
    t_block = 64
    stream = JaxStreaming(K, init_iterations=5)
    model, _ = JaxTrainer().fit_predict_model(
        jnp.asarray(y[:, :t_block]), num_classes=K, iterations=5,
        key=jax.random.key(3), affiliation_eps=1e-10,
        eigenvalue_floor=1e-10)
    jax_state = stream._state_from_first_block(
        model, jax_normalize(jnp.asarray(y[:, :t_block])))

    ours = StreamingCACGMM(K, init_iterations=5)._state_from_first_block(
        CACGMM.from_dict(_to_numpy_tree(model.to_dict())),
        normalize_observation(torch.as_tensor(y[:, :t_block])))
    assert_allclose(ours.scatter.numpy(), np.asarray(jax_state.scatter),
                    atol=2e-5, rtol=1e-5)
    assert_allclose(ours.count.numpy(), np.asarray(jax_state.count),
                    rtol=1e-5)
    assert ours.frames.dtype == torch.float32
    assert_allclose(ours.frames.numpy(), np.asarray(jax_state.frames))


def test_init_state_warm_start_is_the_offline_fit():
    """init_state runs CACGMMTrainer.fit_predict_model on the first
    block: the same generator gives the same model and affiliation."""
    y, _ = _sample(seed=4)
    block = torch.as_tensor(y[:, :50])
    stream = StreamingCACGMM(K, init_iterations=4)
    state, aff = stream.init_state(
        block, generator=torch.Generator().manual_seed(5))
    model, ref = CACGMMTrainer().fit_predict_model(
        block, num_classes=K, iterations=4,
        generator=torch.Generator().manual_seed(5), affiliation_eps=1e-10,
        eigenvalue_floor=1e-10)
    assert torch.equal(aff, ref)
    assert torch.equal(state.model.weight, model.weight)
    assert torch.equal(state.frames, torch.full((F,), 50.))
    assert aff.shape == (F, K, 50)


def test_update_loop_matches_fit_predict_stream():
    """The stateful update() API and fit_predict_stream give the same
    stream, bit for bit."""
    y, _ = _sample(seed=3)
    y = torch.as_tensor(y)
    t_block = 50
    stream = StreamingCACGMM(K, forgetting=0.999, inner_iterations=1,
                             init_iterations=5)
    model_loop, aff_loop = stream.fit_predict_stream(
        y, t_block=t_block, generator=torch.Generator().manual_seed(4))
    state = None
    affs = []
    for i in range(T // t_block):
        state, aff = stream.update(
            state, y[:, i * t_block:(i + 1) * t_block],
            generator=torch.Generator().manual_seed(4))
        affs.append(aff)
    assert torch.equal(torch.cat(affs, dim=-1), aff_loop)
    assert torch.equal(state.model.cacg.covariance_eigenvalues,
                       model_loop.cacg.covariance_eigenvalues)


def test_stationary_matches_offline():
    """Pure incremental EM (forgetting=1) on a stationary scene ends
    near the offline EM solution (the JAX test's margins)."""
    y, labels = _sample(seed=0)
    y = torch.as_tensor(y)
    offline = CACGMMTrainer().fit(y, num_classes=K, iterations=20,
                                  generator=torch.Generator().manual_seed(1))
    mse_off = _oracle_mse(offline.predict(y), labels)
    stream = StreamingCACGMM(K, forgetting=1.0, inner_iterations=2,
                             init_iterations=10)
    model, _ = stream.fit_predict_stream(
        y, t_block=50, generator=torch.Generator().manual_seed(1))
    mse_stream = _oracle_mse(model.predict(y), labels)
    assert mse_off < 0.15, mse_off
    assert mse_stream < mse_off + 0.03, (mse_stream, mse_off)


def test_block_size_invariance():
    """The per-frame forgetting makes quality insensitive to the block
    length (the JAX test's margin)."""
    y, labels = _sample(seed=1)
    y = torch.as_tensor(y)
    mses = []
    for t_block in (25, 50, 100):
        stream = StreamingCACGMM(K, forgetting=0.999, inner_iterations=2,
                                 init_iterations=10)
        model, _ = stream.fit_predict_stream(
            y, t_block=t_block, generator=torch.Generator().manual_seed(2))
        mses.append(_oracle_mse(model.predict(y), labels))
    assert max(mses) - min(mses) < 0.05, mses


def test_tracks_switching_scene():
    """forgetting < 1 tracks a scene that switches halfway better than
    one offline model of both halves (the JAX test's margin)."""
    y1, _ = _sample(seed=2)
    y2, lab2 = _sample(seed=7)
    y = torch.as_tensor(np.concatenate([y1, y2], axis=-2))
    offline = CACGMMTrainer().fit(y, num_classes=K, iterations=20,
                                  generator=torch.Generator().manual_seed(3))
    mse_off_2nd = _oracle_mse(offline.predict(torch.as_tensor(y2)), lab2)
    stream = StreamingCACGMM(K, forgetting=0.97, inner_iterations=2,
                             init_iterations=10)
    model, _ = stream.fit_predict_stream(
        y, t_block=50, generator=torch.Generator().manual_seed(3))
    mse_stream_2nd = _oracle_mse(model.predict(torch.as_tensor(y2)), lab2)
    assert mse_stream_2nd < mse_off_2nd - 0.02, (mse_stream_2nd,
                                                 mse_off_2nd)


def test_partial_trailing_block_is_truncated():
    y, _ = _sample(seed=5)
    stream = StreamingCACGMM(K, init_iterations=3)
    _, aff = stream.fit_predict_stream(torch.as_tensor(y[:, :130]),
                                       t_block=50)
    assert aff.shape == (F, K, 100), aff.shape


def test_state_round_trips_through_the_jax_dict_schema():
    """A port state's to_dict() has the JAX package's keys and loads
    there; the JAX state's loads here."""
    from pb_bss_tpu.models.cacgmm_streaming import (
        StreamingCACGMMState as JaxState,
    )
    y, _ = _sample(seed=6)
    state, _ = StreamingCACGMM(K, init_iterations=2).update(
        None, torch.as_tensor(y[:, :40]))
    d = _to_numpy_tree({k: (v.numpy() if isinstance(v, torch.Tensor)
                            else v) for k, v in state.to_dict().items()
                        if k != 'model'})
    d['model'] = {'weight': state.model.weight.numpy(), 'cacg': {
        k: v.numpy() for k, v in state.model.cacg.to_dict().items()}}
    jax_state = JaxState.from_dict(d)
    assert_allclose(np.asarray(jax_state.model.cacg.covariance_eigenvalues),
                    state.model.cacg.covariance_eigenvalues.numpy())
    back = StreamingCACGMMState.from_dict(_to_numpy_tree(
        jax_state.to_dict()))
    assert torch.equal(back.scatter, state.scatter)
