"""separate / separate_batch with ``mesh=`` on gloo: the port's
pipeline over ('b', 'f') ranks against the unsharded port and the JAX
package's sharded pipeline (the counterpart of
tests/test_parallel/test_mesh.py::test_full_pipeline_2d_sharded_matches_replicated,
at its sizes: B=4, D=4, 6,000 samples, K=3, 3 iterations).

From one initialization the sharded port equals the unsharded port bit
for bit (measured; the per-bin fits take no reduction, DHTV and the
phase correction run on the gathered bins, the reference-channel SNR is
an all-reduce of per-rank sums), held at atol 1e-6. Against JAX from
JAX's own initialization (``jax.random.split(key(0), B)``, as its
``separate_batch`` draws it): the masks at the JAX test's atol 1e-4
(measured 1.5e-6); the GEV+BAN waveforms at atol 5e-3 and 1e-3 of the
output's RMS (measured 1.65e-3 and 1.5e-4: on noise the GEV pencils are
nearly degenerate, and the two packages' eigenvectors part at f32
rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gloo as gloo
from pb_bss_tpu.parallel import make_mesh as jax_make_mesh
from pb_bss_tpu.pipeline import separate_batch as jax_separate_batch
from pb_bss_tpu_torch import separate, separate_batch
from pb_bss_tpu_torch.pipeline import _init_shape, _separate

torch.set_num_threads(2)

TIMEOUT = 180  # seconds a world may take (measured 8-17 s here)
B, D, N, K, ITERATIONS = 4, 4, 6000, 3, 3


@pytest.fixture(scope='module')
def observations():
    rng = np.random.default_rng(3)
    return rng.standard_normal((B, D, N)).astype(np.float32)


def _jax_initialization(observations):
    """JAX separate_batch's EM initialization at key(0)."""
    shape = _init_shape(torch.from_numpy(observations[0]), K, 512, 128)
    init = np.stack([np.asarray(jax.random.uniform(key, shape, jnp.float32))
                     for key in jax.random.split(jax.random.key(0), B)])
    return init / init.sum(-2, keepdims=True)


def _options(beamformer):
    return dict(iterations=ITERATIONS, stft_size=512, stft_shift=128,
                beamformer=beamformer, reference_channel=0,
                eigh_sweeps=None, model='cacgmm', refine=None,
                refine_iterations=20)


@pytest.mark.parametrize('beamformer,mesh_shape,names,jax_shape', [
    ('gev+ban', (2, 2), ('b', 'f'), (2, 4)),
    (None, (2,), ('f',), (8,)),
])
def test_full_pipeline_sharded_matches_replicated(
        tmp_path, observations, beamformer, mesh_shape, names, jax_shape):
    init = _jax_initialization(observations)
    results = gloo.run_world(gloo.pipeline, int(np.prod(mesh_shape)),
                             tmp_path, observations, init, mesh_shape,
                             names, _options(beamformer), timeout=TIMEOUT)
    local = _separate(torch.from_numpy(observations),
                      torch.from_numpy(init),
                      **_options(beamformer)).numpy()
    ref = np.asarray(jax_separate_batch(
        jnp.asarray(observations), num_classes=K, iterations=ITERATIONS,
        beamformer=beamformer,
        mesh=jax_make_mesh(jax_shape, names)))
    for out in results:  # every rank returns the whole batch
        assert out.shape == (B, K, N)
        np.testing.assert_allclose(out, local, atol=1e-6)
    if beamformer is None:
        np.testing.assert_allclose(results[0], ref, atol=1e-4)
    else:
        np.testing.assert_allclose(results[0], ref, atol=5e-3)
        error = np.sqrt(np.mean((results[0] - ref) ** 2)
                        / np.mean(ref ** 2))
        assert error < 1e-3, error


@pytest.fixture(scope='module')
def speech():
    """Three 6,000-sample cuts of the dummy two-speaker scenarios (D=6):
    MVDR-Souden's reference channel is a clear choice on them (the top
    two channels' summed SNRs part by 4.7e-3 relative or more, and the
    choice held at 1, 2, 3, 4, 6 and 8 threads; measured), where on
    white noise the channels' SNRs tie."""
    from pb_bss_tpu_torch.testing import low_reverberation_data
    return np.stack([low_reverberation_data(seed)['observation'][:, :N]
                     for seed in range(3)]).astype(np.float32)


@pytest.mark.parametrize('options,mesh_shape,names,batch', [
    # an uneven batch (2 + 1 utterances), the reference-channel SNR's
    # all-reduce over 'f'
    (dict(beamformer='mvdr_souden+ban'), (2, 2), ('b', 'f'), 3),
    (dict(beamformer='gev+ban'), (2,), ('b',), 4),
    (dict(refine='fca', refine_iterations=3), (2,), ('f',), 2),
])
def test_separate_batch_mesh_equals_unsharded(tmp_path, observations,
                                              speech, options, mesh_shape,
                                              names, batch):
    """separate_batch(mesh=) draws every utterance's initialization as
    the unsharded call does and returns its result on every rank (held
    at 1e-5 of the output's peak; measured bit for bit). The MVDR route
    is held at 2e-2 of the peak, its own run-to-run spread on the CPU:
    the unsharded call's output on one of these utterances moved by
    1.0e-2 of the peak between two calls in one process with other work
    between them. The step that amplifies the last bits is
    stable_solve's residual gate, a fault of the reference (ROADMAP
    queue 3): the noise PSD of utterance 0, class 1, bin 7 has condition
    2.1e4, its LU residual sits at 0.79 of the gate, one-ulp changes of
    the PSD move it over 0.54-1.47 of it, and past the gate the bin's
    beamformer is the pseudo-inverse solution, which parts from the LU
    one wholesale (measured; test_torch_linalg.py::
    test_stable_solve_residual_gate_flips_on_last_bits)."""
    mvdr = 'mvdr' in options.get('beamformer', '')
    data = speech if mvdr else observations[:batch]
    kwargs = dict(num_classes=K, iterations=ITERATIONS, **options)
    results = gloo.run_world(gloo.separate, int(np.prod(mesh_shape)),
                             tmp_path, data, mesh_shape, names, kwargs,
                             timeout=TIMEOUT)
    local = separate_batch(torch.from_numpy(data), **kwargs).numpy()
    for out in results:
        np.testing.assert_allclose(
            out, local, atol=(2e-2 if mvdr else 1e-5) * np.abs(local).max())


def test_separate_mesh_equals_unsharded(tmp_path, observations):
    """separate(mesh=) of one utterance over 'f' (the 'b' axis of a 2D
    mesh replicates it)."""
    kwargs = dict(num_classes=K, iterations=ITERATIONS, beamformer='gev+ban')
    results = gloo.run_world(gloo.separate, 4, tmp_path, observations[0],
                             (2, 2), ('b', 'f'), kwargs, timeout=TIMEOUT)
    local = separate(torch.from_numpy(observations[0]), **kwargs).numpy()
    for out in results:
        np.testing.assert_allclose(out, local, atol=1e-6)
