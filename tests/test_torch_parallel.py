"""pb_bss_tpu_torch.parallel's sharded fits on gloo against the
unsharded port and against the JAX package's sharded fits.

The counterparts of tests/test_parallel/test_mesh.py's fits, at its
sizes and iterations: each test runs the port in a world of 2 gloo
processes (the mesh's 'f' axis; 4 for the ('b', 'f') mesh) through
``tests/_torch_gloo.py``, joins the ranks' bins and holds them against
the unsharded port (the same routes from the same initialization: to
f32 rounding of the all-reduced sums, rtol 1e-5) and against JAX's fit
of the same initialization on the 8-device CPU mesh at the JAX test's
own tolerances (weights rtol 1e-4 atol 1e-5, eigenvalues rtol 1e-3
atol 1e-4). JAX's kernel routes run as its scan (its interpret-mode
Pallas kernels match their scan in its own suite). Each world has a
deadline of its own (``run_world``'s ``timeout``).
"""
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gloo as gloo
from pb_bss_tpu.parallel import fit_cacgmm_sharded as jax_fit_sharded
from pb_bss_tpu.parallel import make_mesh as jax_make_mesh
from pb_bss_tpu_torch.models import CACGMMTrainer
from pb_bss_tpu_torch.parallel import initialize_distributed

torch.set_num_threads(2)

TIMEOUT = 120  # seconds a world may take (measured 6-12 s here)


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _init(shape, seed):
    init = np.random.default_rng(seed).uniform(size=shape).astype(
        np.float32)
    return init / init.sum(-2, keepdims=True)


def _jax_mesh():
    return jax_make_mesh((8,), ('f',))


def _weight(results):
    """The ranks' frequency-constant weights, equal on every rank."""
    for r in results[1:]:
        np.testing.assert_array_equal(r['weight'], results[0]['weight'])
    return results[0]['weight']


def _cacgmm_case(tmp_path, y, init, **kwargs):
    F, K, _ = init.shape
    results = gloo.run_world(gloo.cacgmm_fit, 2, tmp_path, y, init, (2,),
                             dict(kwargs, num_classes=K), timeout=TIMEOUT)
    local = CACGMMTrainer().fit(torch.from_numpy(y),
                                initialization=torch.from_numpy(init),
                                **kwargs)
    jax_kwargs = {k: v for k, v in kwargs.items() if k != 'use_fused_em'}
    ref = jax_fit_sharded(jnp.asarray(y), _jax_mesh(),
                          initialization=jnp.asarray(init), **jax_kwargs)
    return results, local, ref


def _hold_cacgmm(results, local, ref, frequency_constant):
    if frequency_constant:
        weight = _weight(results)
    else:
        weight = gloo.concatenate(results, 'weight')
    eigenvalues = gloo.concatenate(results, 'eigenvalues')
    np.testing.assert_allclose(weight, local.weight.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(
        eigenvalues, local.cacg.covariance_eigenvalues.numpy(), rtol=1e-5,
        atol=1e-7)
    np.testing.assert_allclose(weight, np.asarray(ref.weight), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        eigenvalues, np.asarray(ref.cacg.covariance_eigenvalues),
        rtol=1e-3, atol=1e-4)


def test_frequency_sharded_fit_matches_replicated(tmp_path):
    """Per-bin weights: no traffic; each rank's bins are the unsharded
    fit's bit for bit."""
    F, T, D, K = 16, 40, 3, 2
    y, init = _data((F, T, D), 0), _init((F, K, T), 10)
    results, local, ref = _cacgmm_case(tmp_path, y, init, iterations=5)
    np.testing.assert_array_equal(gloo.concatenate(results, 'weight'),
                                  local.weight.numpy())
    _hold_cacgmm(results, local, ref, frequency_constant=False)


@pytest.mark.parametrize('route', [
    dict(use_fused_em=False),
    # K5's twin: its weight all-reduced between the step passes
    dict(use_fused_em=True),
])
def test_frequency_constant_weight_all_reduce_matches(tmp_path, route):
    """weight_constant_axis=(-3, -1) averages over the sharded F axis:
    the all-reduce of estimate_mixture_weight (scan) and of
    em_step's weight_from_asum (K5's route)."""
    F, T, D, K = 16, 40, 3, 2
    y, init = _data((F, T, D), 1), _init((F, K, T), 11)
    results, local, ref = _cacgmm_case(
        tmp_path, y, init, iterations=3, weight_constant_axis=(-3, -1),
        **route)
    _hold_cacgmm(results, local, ref, frequency_constant=True)


def test_fc_fused_em_under_frequency_sharding(tmp_path):
    """The JAX test's own sizes (F=32, T=24) on K5's route."""
    F, T, D, K = 32, 24, 3, 2
    y, init = _data((F, T, D), 9), _init((F, K, T), 19)
    results, local, ref = _cacgmm_case(
        tmp_path, y, init, iterations=3, weight_constant_axis=(-3, -1),
        use_fused_em=True)
    _hold_cacgmm(results, local, ref, frequency_constant=True)


def test_fc_streamed_em_under_frequency_sharding(tmp_path):
    """Past K5's gate the frequency-constant fit streams (K4's twin):
    em_stream.mixture_weight's all-reduce."""
    F, T, D, K = 16, 40, 3, 2
    y, init = _data((F, T, D), 2), _init((F, K, T), 12)
    results = gloo.run_world(
        gloo.cacgmm_fit, 2, tmp_path, y, init, (2,),
        dict(num_classes=K, iterations=3, weight_constant_axis=(-3, -1),
             use_fused_em=True, _step_gate=False), timeout=TIMEOUT)
    from pb_bss_tpu_torch.ops import em_step
    gate = em_step.fits
    em_step.fits = lambda *args: False
    try:
        local = CACGMMTrainer().fit(
            torch.from_numpy(y), initialization=torch.from_numpy(init),
            iterations=3, weight_constant_axis=(-3, -1), use_fused_em=True)
    finally:
        em_step.fits = gate
    ref = jax_fit_sharded(jnp.asarray(y), _jax_mesh(),
                          initialization=jnp.asarray(init), iterations=3,
                          weight_constant_axis=(-3, -1))
    _hold_cacgmm(results, local, ref, frequency_constant=True)


@pytest.mark.parametrize('route', [
    dict(use_fused_em=False),
    # K5's twin: the aligner between the step passes
    dict(use_fused_em=True),
])
def test_inline_aligner_under_frequency_sharding(tmp_path, route):
    """DHTV inline in a frequency-constant fit walks every bin: each
    rank gathers the posterior over 'f', maps it and keeps its bins'
    mapping; the fit equals the unsharded one."""
    from pb_bss_tpu_torch.permutation_alignment import (
        DHTVPermutationAlignment)
    F, T, D, K = 257, 24, 3, 2
    y, init = _data((F, T, D), 6), _init((F, K, T), 16)
    kwargs = dict(iterations=3, weight_constant_axis=(-3, -1), **route)
    results = gloo.run_world(
        gloo.cacgmm_fit, 2, tmp_path, y, init, (2,),
        dict(kwargs, num_classes=K, inline_permutation_aligner='dhtv'),
        timeout=TIMEOUT)
    local = CACGMMTrainer().fit(
        torch.from_numpy(y), initialization=torch.from_numpy(init),
        inline_permutation_aligner=DHTVPermutationAlignment.from_stft_size(
            512), **kwargs)
    np.testing.assert_allclose(_weight(results), local.weight.numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        gloo.concatenate(results, 'eigenvalues'),
        local.cacg.covariance_eigenvalues.numpy(), rtol=1e-5, atol=1e-7)


def test_sharded_fit_draws_the_unsharded_initialization(tmp_path):
    """num_classes alone: every rank draws the unsharded trainer's
    random initialization and keeps its bins."""
    F, T, D, K = 16, 40, 3, 2
    y = _data((F, T, D), 3)
    results = gloo.run_world(gloo.cacgmm_fit, 2, tmp_path, y, None, (2,),
                             dict(num_classes=K, iterations=2),
                             timeout=TIMEOUT)
    local = CACGMMTrainer().fit(torch.from_numpy(y), num_classes=K,
                                iterations=2)
    np.testing.assert_array_equal(gloo.concatenate(results, 'eigenvalues'),
                                  local.cacg.covariance_eigenvalues.numpy())


def test_uneven_frequency_split(tmp_path):
    """F=17 over 2 ranks (9 + 8 bins, DTensor's Shard layout): the
    frequency-constant fit still equals the unsharded one, and the
    pipeline's own split, gather and all-reduce agree with DTensor's."""
    F, T, D, K = 17, 40, 3, 2
    y, init = _data((F, T, D), 5), _init((F, K, T), 15)
    results = gloo.run_world(
        gloo.cacgmm_fit, 2, tmp_path, y, init, (2,),
        dict(num_classes=K, iterations=3, weight_constant_axis=(-3, -1)),
        timeout=TIMEOUT)
    assert [r['eigenvalues'].shape[0] for r in results] == [9, 8]
    local = CACGMMTrainer().fit(torch.from_numpy(y),
                                initialization=torch.from_numpy(init),
                                iterations=3, weight_constant_axis=(-3, -1))
    np.testing.assert_allclose(_weight(results), local.weight.numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        gloo.concatenate(results, 'eigenvalues'),
        local.cacg.covariance_eigenvalues.numpy(), rtol=1e-5, atol=1e-7)

    shapes = gloo.run_world(gloo.local_shapes, 2, tmp_path, 17, (2,),
                            timeout=TIMEOUT)
    full = np.arange(34.0).reshape(17, 2)
    for r in shapes:
        np.testing.assert_array_equal(r['rows'], r['dtensor'])
        np.testing.assert_array_equal(r['gathered'], full)
        np.testing.assert_array_equal(r['reduced'], np.full(3, 3.0))
    np.testing.assert_array_equal(
        np.concatenate([r['rows'] for r in shapes]), full)


def test_2d_mesh_batch_frequency(tmp_path):
    """shard_batch_and_frequencies and shard_batch_from_process_local on
    a (2, 2) ('b', 'f') mesh: each rank holds its block of the global
    array, and a fit of the block predicts normalized affiliations."""
    B, F, T, D, K = 4, 8, 30, 3, 2
    y = _data((B, F, T, D), 2)
    results = gloo.run_world(gloo.batch_frequency_fit, 4, tmp_path, y,
                             (2, 2), timeout=TIMEOUT)
    for rank, r in enumerate(results):
        b, f = divmod(rank, 2)
        block = y[2 * b:2 * b + 2, 4 * f:4 * f + 4]
        np.testing.assert_array_equal(r['local'], block)
        np.testing.assert_array_equal(r['from_local'], block)
        assert r['shape'] == r['from_local_shape'] == (B, F, T, D)
        assert r['affiliation'].shape == (2, 4, K, T)
        np.testing.assert_allclose(r['affiliation'].sum(-2), 1, rtol=1e-4)


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_initialize_distributed_and_make_mesh(tmp_path):
    """initialize_distributed joins over tcp (gloo for platform='cpu');
    make_mesh's defaults are ('f',) for 1D and ('b', 'f') for 2D."""
    results = gloo.run_world(gloo.initialize, 2, tmp_path, _free_port(),
                             timeout=TIMEOUT, store=False)
    for r in results:
        assert r == dict(backend='gloo', names1=('f',), names2=('b', 'f'),
                         shape2=(1, 2), device='cpu', total=2.0)


def test_initialize_distributed_refuses_several_local_devices():
    with pytest.raises(ValueError, match='one device per process'):
        initialize_distributed('127.0.0.1:1', 1, 0, local_device_count=8,
                               platform='cpu')
    with pytest.raises(ValueError, match='platform'):
        initialize_distributed('127.0.0.1:1', 1, 0, platform='tpu')
