"""pb_bss_tpu_torch's CWMM, CBMM and integration fits and the
beamformers under frequency sharding on gloo, against the unsharded port
and the JAX package's sharded results (the counterparts of
tests/test_parallel/test_mesh.py's integration and beamformer tests;
the worlds and tolerances as in tests/test_torch_parallel.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gloo as gloo
from pb_bss_tpu.parallel import fit_integration_sharded as jax_fit_integration
from pb_bss_tpu.parallel import make_mesh as jax_make_mesh
from pb_bss_tpu.parallel import shard_frequencies as jax_shard_frequencies
from pb_bss_tpu_torch import models

torch.set_num_threads(2)

TIMEOUT = 120  # seconds a world may take (measured 4-12 s here)


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


@pytest.mark.parametrize('trainer,fit_kwargs', [
    ('CWMMTrainer', {}),
    # K7's Watson twin, its weight from em_stream.mixture_weight
    ('CWMMTrainer', dict(use_fused_em=True)),
    ('CBMMTrainer', {}),
])
def test_mixture_fc_weight_under_frequency_sharding(tmp_path, trainer,
                                                    fit_kwargs):
    """CWMM and CBMM with frequency-constant weights: the trainers'
    weight all-reduce inside the frequency shard, against the unsharded
    port and against JAX's trainer on frequency-sharded input."""
    F, T, D, K = 16, 40, 3, 2
    y, init = _data((F, T, D), 4), _init((F, K, T), 14)
    y = y / np.linalg.norm(y, axis=-1, keepdims=True)
    kwargs = dict(iterations=3, weight_constant_axis=(-3, -1), **fit_kwargs)
    results = gloo.run_world(gloo.mixture_fit, 2, tmp_path, trainer, y,
                             init, (2,), kwargs, timeout=TIMEOUT)
    local = getattr(models, trainer)().fit(
        torch.from_numpy(y), initialization=torch.from_numpy(init),
        **kwargs)
    import pb_bss_tpu.models as jax_models
    ref = getattr(jax_models, trainer)().fit(
        jax_shard_frequencies(jnp.asarray(y), _jax_mesh()),
        initialization=jnp.asarray(init), iterations=3,
        weight_constant_axis=(-3, -1))
    weight = _weight(results)
    np.testing.assert_allclose(weight, local.weight.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(weight, np.asarray(ref.weight), rtol=1e-4,
                               atol=1e-5)
    family = ('complex_watson' if trainer == 'CWMMTrainer'
              else 'complex_bingham')
    # the all-reduced weight parts from the unsharded one by an ulp,
    # which three iterations carry into the Watson / Bingham parameters:
    # the Watson ones held at the JAX test's eigenvalue tolerance; the
    # Bingham ones at their own sensitivity (rule a of ROADMAP queue 3:
    # one ulp of this initialization moves the unsharded fit's Bingham
    # eigenvalues by 5.4e-3 and its eigenvectors by 9.9e-3 relative,
    # 3.6e-3 / 1.9e-3 absolute; measured)
    rtol, atol = (1e-3, 1e-4) if family == 'complex_watson' else (2e-2, 5e-3)
    for key in results[0]:
        if key.startswith(family + '/'):
            leaf = key.split('/', 1)[1]
            np.testing.assert_allclose(
                gloo.concatenate(results, key),
                getattr(getattr(local, family), leaf).numpy(), rtol=rtol,
                atol=atol)


def _integration_data(F, T, D, E, seed):
    rng = np.random.default_rng(seed)
    obs = (rng.standard_normal((F, T, D))
           + 1j * rng.standard_normal((F, T, D))).astype(np.complex64)
    emb = rng.standard_normal((F, T, E)).astype(np.float32)
    return obs, emb


@pytest.mark.parametrize('model,route', [
    ('vmfcacgmm', 'auto'), ('vmfcacgmm', 'step'),
    ('gcacgmm', 'auto'), ('gcacgmm', 'step'),
])
def test_integration_model_sharded_matches_replicated(tmp_path, model,
                                                      route):
    """The spectral M-step reduces over ALL frequencies: its resultants
    / moments are all-reduced over 'f' (the scan on the CPU for 'auto',
    K10's twin for 'step'); the global spectral state equals the
    unsharded fit's on every rank, and JAX's sharded fit's."""
    if model == 'vmfcacgmm':
        F, T, D, E, K, iterations, seed = 16, 40, 3, 6, 2, 4, 7
        spectral, leaves = 'vmf', ('mean', 'concentration')
    else:
        F, T, D, E, K, iterations, seed = 16, 32, 3, 6, 2, 3, 8
        spectral, leaves = 'gaussian', ('mean', 'covariance')
    obs, emb = _integration_data(F, T, D, E, seed)
    init = _init((F, K, T), seed + 10)
    kwargs = dict(iterations=iterations, use_fused_em=route)
    results = gloo.run_world(gloo.integration_fit, 2, tmp_path, model, obs,
                             emb, init, (2,), kwargs, timeout=TIMEOUT)
    Trainer = (models.VMFCACGMMTrainer if model == 'vmfcacgmm'
               else models.GCACGMMTrainer)
    local = Trainer().fit(torch.from_numpy(obs), torch.from_numpy(emb),
                          initialization=torch.from_numpy(init), **kwargs)
    ref = jax_fit_integration(jnp.asarray(obs), jnp.asarray(emb),
                              _jax_mesh(), model=model,
                              initialization=jnp.asarray(init),
                              iterations=iterations)
    for leaf in leaves:
        key = f'{spectral}/{leaf}'
        np.testing.assert_array_equal(results[1][key], results[0][key])
        ours = results[0][key]
        np.testing.assert_allclose(
            ours, getattr(getattr(local, spectral), leaf).numpy(),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            ours, np.asarray(getattr(getattr(ref, spectral), leaf)),
            rtol=1e-4, atol=1e-5)
    weight = gloo.concatenate(results, 'weight')
    np.testing.assert_allclose(weight, local.weight.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(weight, np.asarray(ref.weight), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        gloo.concatenate(results, 'cacg/covariance_eigenvalues'),
        np.asarray(ref.cacg.covariance_eigenvalues), rtol=1e-3, atol=1e-4)


def test_whole_fit_integration_kernel_refuses_frequency_sharding(tmp_path):
    """K12 sums every bin inside one launch: under an 'f' axis of 2 an
    explicit use_fused_em='loop' raises and names 'step'."""
    obs, emb = _integration_data(16, 32, 3, 6, 8)
    results = gloo.run_world(
        gloo.integration_fit, 2, tmp_path, 'vmfcacgmm', obs, emb,
        _init((16, 2, 32), 18), (2,),
        dict(iterations=3, use_fused_em='loop'), timeout=TIMEOUT)
    for r in results:
        assert "'step'" in r['error'], r


def test_sharded_beamformer_pipeline(tmp_path):
    """PSD, GEV and MVDR-Souden under frequency sharding; the
    estimated reference channel takes the SNR summed over every bin (an
    all-reduce) and equals the unsharded choice."""
    from pb_bss_tpu_torch.extraction.beamformer import (
        apply_beamforming_vector,
        get_gev_vector,
        get_mvdr_vector_souden,
        get_power_spectral_density_matrix,
    )
    F, D, T = 16, 4, 50
    y = _data((F, D, T), 3)
    mask = np.random.default_rng(4).uniform(0.05, 0.95, (F, T)).astype(
        np.float32)
    results = gloo.run_world(gloo.beamformers, 2, tmp_path, y, mask, (2,),
                             timeout=TIMEOUT)
    yt, maskt = torch.from_numpy(y), torch.from_numpy(mask)
    phi_xx = get_power_spectral_density_matrix(yt, maskt)
    phi_nn = get_power_spectral_density_matrix(yt, 1 - maskt)
    w_mvdr, ref_channel = get_mvdr_vector_souden(phi_xx, phi_nn,
                                                 return_ref_channel=True)
    expected = dict(
        gev=apply_beamforming_vector(get_gev_vector(phi_xx, phi_nn), yt),
        mvdr=apply_beamforming_vector(
            get_mvdr_vector_souden(phi_xx, phi_nn, ref_channel=0), yt),
        mvdr_ref=apply_beamforming_vector(w_mvdr, yt))
    for r in results:
        assert r['ref_channel'] == int(ref_channel)
    for name, value in expected.items():
        np.testing.assert_allclose(
            np.abs(gloo.concatenate(results, name)), np.abs(value.numpy()),
            rtol=1e-5, atol=1e-6)

    from pb_bss_tpu.extraction import beamformer as jax_bf
    mesh = _jax_mesh()
    y_j = jax_shard_frequencies(jnp.asarray(y), mesh)
    mask_j = jax_shard_frequencies(jnp.asarray(mask), mesh)
    phi_xx = jax_bf.get_power_spectral_density_matrix(y_j, mask_j)
    phi_nn = jax_bf.get_power_spectral_density_matrix(y_j, 1 - mask_j)
    for name, w in (
            ('gev', jax_bf.get_gev_vector(phi_xx, phi_nn)),
            ('mvdr', jax_bf.get_mvdr_vector_souden(phi_xx, phi_nn,
                                                   ref_channel=0))):
        np.testing.assert_allclose(
            np.abs(gloo.concatenate(results, name)),
            np.abs(np.asarray(jax_bf.apply_beamforming_vector(w, y_j))),
            rtol=1e-3, atol=1e-4)
