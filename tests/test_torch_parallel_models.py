"""pb_bss_tpu_torch's CWMM, CBMM and integration fits, the five
trainers' DTensor entry and the beamformers under frequency sharding on
gloo, against the unsharded port and the JAX package's sharded results
(the counterparts of tests/test_parallel/test_mesh.py's integration and
beamformer tests; the worlds and tolerances as in
tests/test_torch_parallel.py). The fits return the global model on every
rank (``gloo.global_value``)."""
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


@pytest.mark.parametrize('trainer,fit_kwargs', [
    ('CWMMTrainer', {}),
    # K7's Watson twin, its weight from em_stream.mixture_weight
    ('CWMMTrainer', dict(use_fused_em=True)),
    ('CBMMTrainer', {}),
])
def test_mixture_fc_weight_under_frequency_sharding(tmp_path, trainer,
                                                    fit_kwargs):
    """CWMM and CBMM with frequency-constant weights on a DTensor: the
    trainers' weight all-reduce inside the frequency shard, against the
    unsharded port and against JAX's trainer on frequency-sharded
    input."""
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
    weight = gloo.global_value(results, 'weight')
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
                gloo.global_value(results, key),
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
    weight = gloo.global_value(results, 'weight')
    np.testing.assert_allclose(weight, local.weight.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(weight, np.asarray(ref.weight), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        gloo.global_value(results, 'cacg/covariance_eigenvalues'),
        np.asarray(ref.cacg.covariance_eigenvalues), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize('model,ranks,F', [
    ('vmfcacgmm', 2, 16),
    ('gcacgmm', 2, 17),  # 9 + 8 bins
    ('vmfcacgmm', 4, 18),  # 5 + 5 + 5 + 3 bins
    ('gcacgmm', 4, 16),
])
def test_whole_fit_integration_kernel_under_frequency_sharding(
        tmp_path, model, ranks, F):
    """K12 sums every bin inside its one launch: under an 'f' axis of 2
    or 4 (even and uneven splits) every rank all-gathers the observation,
    embedding and initialization bins, fits every bin with
    use_fused_em='loop' and returns the global model. It is the
    unsharded 'loop' fit (K12's twin on the CPU; atol 1e-6, measured bit
    for bit) and JAX's unsharded fit from the same initialization at the
    JAX mesh test's tolerances (rtol 1e-4 / atol 1e-5; eigenvalues rtol
    1e-3 / atol 1e-4)."""
    T, D, E, K, iterations = 32, 3, 6, 2, 4
    obs, emb = _integration_data(F, T, D, E, 8)
    init = _init((F, K, T), 18)
    kwargs = dict(iterations=iterations, use_fused_em='loop')
    results = gloo.run_world(gloo.integration_fit, ranks, tmp_path, model,
                             obs, emb, init, (ranks,), kwargs,
                             timeout=TIMEOUT)
    Trainer = (models.VMFCACGMMTrainer if model == 'vmfcacgmm'
               else models.GCACGMMTrainer)
    local = Trainer().fit(torch.from_numpy(obs), torch.from_numpy(emb),
                          initialization=torch.from_numpy(init), **kwargs)
    import pb_bss_tpu.models as jax_models
    JaxTrainer = (jax_models.VMFCACGMMTrainer if model == 'vmfcacgmm'
                  else jax_models.GCACGMMTrainer)
    ref = JaxTrainer().fit(jnp.asarray(obs), jnp.asarray(emb),
                           initialization=jnp.asarray(init),
                           iterations=iterations)
    spectral, leaves = (('vmf', ('mean', 'concentration'))
                        if model == 'vmfcacgmm'
                        else ('gaussian', ('mean', 'covariance')))
    for key, ours, theirs, rtol, atol in [
            ('weight', local.weight, ref.weight, 1e-4, 1e-5),
            ('cacg/covariance_eigenvalues',
             local.cacg.covariance_eigenvalues,
             ref.cacg.covariance_eigenvalues, 1e-3, 1e-4),
            *[(f'{spectral}/{leaf}', getattr(getattr(local, spectral), leaf),
               getattr(getattr(ref, spectral), leaf), 1e-4, 1e-5)
              for leaf in leaves]]:
        value = gloo.global_value(results, key)
        np.testing.assert_allclose(value, ours.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(value, np.asarray(theirs), rtol=rtol,
                                   atol=atol)


def _trainer_case(trainer, seed):
    """The inputs, initialization and fit arguments of one trainer's
    DTensor case (F=15: an uneven split over 2 ranks, 8 + 7 bins, which
    JAX's mesh of 5 divides)."""
    F, T, D, K = 15, 32, 3, 2
    init = _init((F, K, T), seed + 10)
    if trainer in ('VMFCACGMMTrainer', 'GCACGMMTrainer'):
        return _integration_data(F, T, D, 6, seed), init, dict(iterations=3)
    y = _data((F, T, D), seed)
    if trainer == 'CACGMMTrainer':
        # the random initialization: the unsharded draw, the rank's rows
        return (y,), None, dict(num_classes=K, iterations=4)
    return (y / np.linalg.norm(y, axis=-1, keepdims=True),), init, dict(
        iterations=3)


def _random_draw(shape):
    """The port's random initial affiliations of a fit with
    ``num_classes`` and no generator (torch.rand seeded 0)."""
    draw = torch.rand(shape, generator=torch.Generator().manual_seed(0))
    return (draw / draw.sum(-2, keepdim=True)).numpy()


def _jax_tolerance(key, trainer):
    """The JAX mesh test's tolerances (rtol 1e-4 / atol 1e-5; eigenvalues
    rtol 1e-3 / atol 1e-4). The Bingham leaves at the fc test's above:
    JAX's sharded CBMM fit is its unsharded one bit for bit, and the
    port's Bingham moment inversion parts from JAX's by 1.8e-3 in the
    eigenvalues after one iteration of this case already (3 iterations:
    weight 2.6e-4, eigenvalues 3.2e-3, eigenvectors 1.3e-3 absolute;
    measured)."""
    if trainer == 'CBMMTrainer':
        return 2e-2, 5e-3
    return (1e-3, 1e-4) if key.endswith('eigenvalues') else (1e-4, 1e-5)


@pytest.mark.parametrize('trainer,embedding,weight_constant_axis', [
    ('CACGMMTrainer', None, None),
    ('CWMMTrainer', None, None),
    ('CBMMTrainer', None, None),
    ('VMFCACGMMTrainer', 'dtensor', None),
    ('GCACGMMTrainer', 'global', None),
    # a tuple with the class axis keeps per-bin weights: (F, 1, 1), (F, 1, T)
    ('CACGMMTrainer', None, (-2, -1)),
    ('CWMMTrainer', None, (-2,)),
])
def test_trainers_take_a_frequency_sharded_dtensor(tmp_path, trainer,
                                                   embedding,
                                                   weight_constant_axis):
    """Each trainer's fit of an observation that is a DTensor sharded
    over 'f' on its frequency axis (2 ranks, 8 + 7 bins): the rank fits
    its bins and every rank returns the global model, the unsharded
    fit's at 1e-5 (rtol and atol; the integration models' all-reduced
    spectral sums part by f32 rounding, which moved a GCACGMM
    eigenvector entry by 2.2e-6 over 3 iterations, measured), and JAX's
    trainer on frequency-sharded input (a mesh of 5) from the same
    initialization at :func:`_jax_tolerance`. The integration trainers
    take the embedding as a DTensor or as the global tensor."""
    import pb_bss_tpu.models as jax_models
    inputs, init, kwargs = _trainer_case(trainer, 21)
    if weight_constant_axis is not None:
        kwargs['weight_constant_axis'] = weight_constant_axis
    results = gloo.run_world(
        gloo.trainer_fit, 2, tmp_path, trainer, inputs, init, (2,), 0,
        dict(kwargs, _embedding=embedding), timeout=TIMEOUT)
    if init is not None:
        kwargs['initialization'] = torch.from_numpy(init)
    local = getattr(models, trainer)().fit(
        *[torch.from_numpy(x) for x in inputs], **kwargs)
    if init is None:
        F, T, _ = inputs[0].shape
        init = _random_draw((F, kwargs.pop('num_classes'), T))
    jax_kwargs = dict(kwargs, initialization=jnp.asarray(init))
    mesh = jax_make_mesh((5,), ('f',))
    ref = getattr(jax_models, trainer)().fit(
        *[jax_shard_frequencies(jnp.asarray(x), mesh) for x in inputs],
        **jax_kwargs)
    expected = gloo._leaves(local.to_dict())
    assert set(results[0]) == set(expected), (results[0].keys(), expected)
    for key, value in expected.items():
        ours = gloo.global_value(results, key)
        np.testing.assert_allclose(ours, value.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
        theirs = ref
        for part in key.split('/'):
            theirs = getattr(theirs, part)
        rtol, atol = _jax_tolerance(key, trainer)
        np.testing.assert_allclose(ours, np.asarray(theirs), rtol=rtol,
                                   atol=atol, err_msg=key)


def test_trainer_refuses_a_dtensor_sharded_over_time(tmp_path):
    """A DTensor split on T (its axis 1 of (F, T, D)) is no frequency
    shard: the trainer raises a ValueError that names the axis."""
    inputs, _, kwargs = _trainer_case('CWMMTrainer', 22)
    results = gloo.run_world(
        gloo.trainer_fit, 2, tmp_path, 'CWMMTrainer', inputs, None, (2,), 1,
        dict(kwargs, num_classes=2), timeout=TIMEOUT)
    for r in results:
        assert 'on its axis 1' in r['error'], r


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
