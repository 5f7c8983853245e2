"""pb_bss_tpu_torch's ('b', 'f') layout on gloo: the five trainers fit a
DTensor whose utterances are split over 'b' and whose bins are split
over 'f' (the JAX package's multi-host layout), the models predict
DTensors, CACGMM.log_likelihood sums every block once, and the multi-host
dry run's sequence runs (the counterparts of
tests/test_parallel/test_mesh.py::test_2d_mesh_batch_frequency and
scripts/dcn_dryrun.py).

The worlds: a (2, 2) ('b', 'f') world and a (2,) ('b',) world of gloo
processes, on 3 utterances and 15 bins (uneven splits: 2 + 1 utterances,
8 + 7 bins), and on 2 utterances and 16 bins (one utterance a 'b' rank). Every rank
returns the global model, held against the unsharded port at 1e-5 (rtol
and atol) and against the JAX package's trainer on a ('b', 'f') mesh of
its virtual CPU devices from the same initialization at the JAX mesh
test's tolerances (``_jax_tolerance``). JAX refuses a sharding that does
not divide an axis (``device_put``'s divisibility check), so the 3 x 15
cases run on its (3, 1) mesh and the 2-utterance ones on its (2, 4)
mesh. Several cases share a world (a world costs a few seconds of
process start).
"""
import concurrent.futures
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_gloo as gloo
from pb_bss_tpu.parallel import make_mesh as jax_make_mesh
from pb_bss_tpu.parallel import (
    shard_batch_and_frequencies as jax_shard_batch_and_frequencies,
)
from pb_bss_tpu_torch import models
from test_torch_parallel_models import _jax_tolerance

torch.set_num_threads(2)

TIMEOUT = 240  # seconds a world may take (measured 10-25 s here)
B, F, T, D, K, E = 3, 15, 32, 3, 2, 6


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _init(shape, seed):
    init = np.random.default_rng(seed).uniform(size=shape).astype(
        np.float32)
    return init / init.sum(-2, keepdims=True)


def _unit(y):
    return y / np.linalg.norm(y, axis=-1, keepdims=True)


def _random_draw(shape):
    """The port's random initial affiliations of a fit with
    ``num_classes`` and no generator (torch.rand seeded 0)."""
    draw = torch.rand(shape, generator=torch.Generator().manual_seed(0))
    return (draw / draw.sum(-2, keepdim=True)).numpy()


def _case(name):
    """The inputs, global initialization (None: the random draw) and fit
    arguments of one case. ``_b1`` cases have 2 utterances, one a 'b'
    rank, and 16 bins (JAX's (2, 4) mesh divides them); the others 3
    utterances and 15 bins."""
    batch, bins = (2, 16) if name.endswith('_b1') else (B, F)
    y = _data((batch, bins, T, D), 31)
    init = _init((batch, bins, K, T), 32)
    emb = np.random.default_rng(33).standard_normal(
        (batch, bins, T, E)).astype(np.float32)
    trainer, inputs, kwargs = {
        'cacgmm': ('CACGMMTrainer', [y], dict(num_classes=K)),
        'cacgmm_fc': ('CACGMMTrainer', [y],
                      dict(weight_constant_axis=(-3, -1))),
        # the integer class axis: a (K, 1) weight, no bin or utterance
        'cacgmm_class': ('CACGMMTrainer', [y],
                         dict(weight_constant_axis=-2)),
        # a weight constant over the utterances too: its sum crosses 'b'
        'cacgmm_utterances': ('CACGMMTrainer', [y],
                              dict(weight_constant_axis=(-4, -3, -1))),
        'cacgmm_fc_b1': ('CACGMMTrainer', [y],
                         dict(weight_constant_axis=(-3, -1))),
        'cwmm': ('CWMMTrainer', [_unit(y)], {}),
        'cwmm_b1': ('CWMMTrainer', [_unit(y)], {}),
        'cbmm': ('CBMMTrainer', [_unit(y)], {}),
        'vmfcacgmm': ('VMFCACGMMTrainer', [y, emb], {}),
        # K12's twin: the bins gathered over 'f', the batch kept split
        'vmfcacgmm_loop': ('VMFCACGMMTrainer', [y, emb],
                           dict(use_fused_em='loop')),
        'gcacgmm': ('GCACGMMTrainer', [y, emb], {}),
        'gcacgmm_b1': ('GCACGMMTrainer', [y, emb], {}),
    }[name]
    if 'num_classes' in kwargs:
        init = None
    return trainer, inputs, init, dict(kwargs, iterations=3)


FIT_CASES = ['cacgmm', 'cacgmm_fc', 'cacgmm_class', 'cacgmm_utterances',
             'cacgmm_fc_b1', 'cwmm', 'cwmm_b1', 'cbmm', 'vmfcacgmm',
             'vmfcacgmm_loop', 'gcacgmm', 'gcacgmm_b1']
# the layouts of each world: mesh axis -> axis of (B, F, T, D)
WORLDS = {
    'b_f': ((2, 2), ('b', 'f'), {'b': 0, 'f': 1}),
    'b': ((2,), ('b',), {'b': 0}),
}
# cases that also run on the (2, 2) world with the utterances replicated
# over 'b' (bins over 'f' only)
F_ONLY = ['cacgmm_fc', 'cwmm', 'gcacgmm']


def _world_cases(dims, names):
    cases = []
    for name in names:
        trainer, inputs, init, kwargs = _case(name)
        cases.append(dict(trainer=trainer, inputs=inputs, init=init,
                          kwargs=kwargs, dims=dims, embedding='dtensor' if name == 'vmfcacgmm'
                          else None))
    return cases


def _process_local_case():
    return _data((2, 16, 24, D), 7), dict(
        num_classes=K, iterations=2, weight_constant_axis=(-3, -1),
        use_fused_em=False)


def _collective_case():
    """The fits whose collectives are recorded: frequency-constant
    weights on the scan and on K5's twin, per-bin weights, and a weight
    constant over the utterances too."""
    fits = [dict(iterations=4, weight_constant_axis=(-3, -1),
                 use_fused_em=False),
            dict(iterations=4, weight_constant_axis=(-3, -1),
                 use_fused_em=True),
            dict(iterations=4),
            dict(iterations=4, weight_constant_axis=(-4, -3, -1))]
    return _data((B, F, T, D), 9), _init((B, F, K, T), 10), fits


LOG_LIKELIHOOD_LAYOUTS = [{'b': 0, 'f': 1}, {'f': 1}, {'b': 0}, {}]


def _log_likelihood_data():
    return _data((4, 16, 24, D), 8)


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    """Every world's results: ``{(world, case): [rank results]}``. The
    (2, 2) world also runs the 'f'-only layout of ``F_ONLY``, two splits
    the trainers refuse (T over 'f', F over 'b') and the scenarios of the
    process-local, collective and log-likelihood tests (``('scenario',
    name)``). The two worlds run at the same time."""
    jobs, out = {}, {}
    for world, (mesh_shape, names, dims) in WORLDS.items():
        cases = _world_cases(dims, FIT_CASES)
        keys = [(world, name) for name in FIT_CASES]
        calls = []
        if world == 'b_f':
            cases += _world_cases({'f': 1}, F_ONLY) \
                + _world_cases({'b': 0, 'f': 2}, ['cwmm']) \
                + _world_cases({'b': 1}, ['cwmm'])
            keys += [('f', name) for name in F_ONLY] \
                + [('refused', 'time'), ('refused', 'bins_over_b')]
            y, kwargs = _process_local_case()
            y_c, init_c, fits = _collective_case()
            calls = [
                (gloo.process_local_fit, (y, mesh_shape, kwargs)),
                (gloo.collective_log, (y_c, init_c, mesh_shape, fits)),
                (gloo.log_likelihoods, (_log_likelihood_data(), mesh_shape,
                                        names, LOG_LIKELIHOOD_LAYOUTS))]
        jobs[world] = keys, len(calls), functools.partial(
            gloo.run_world, gloo.scenarios, int(np.prod(mesh_shape)),
            tmp_path_factory.mktemp(world),
            [(gloo.batch_fits, (cases, mesh_shape, names)), *calls],
            timeout=TIMEOUT)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {world: pool.submit(job[2]) for world, job in jobs.items()}
        for world, (keys, scenarios, _) in jobs.items():
            results = futures[world].result()
            for i, key in enumerate(keys):
                out[key] = [r[0][i] for r in results]
            for i, name in enumerate(('process_local', 'collectives',
                                      'log_likelihood')[:scenarios], 1):
                out['scenario', name] = [r[i] for r in results]
    return out


@functools.lru_cache(maxsize=None)
def _unsharded(name):
    """The unsharded port's fit of a case."""
    trainer, inputs, init, kwargs = _case(name)
    if init is not None:
        kwargs['initialization'] = torch.from_numpy(init)
    return getattr(models, trainer)().fit(
        *[torch.from_numpy(x) for x in inputs], **kwargs)


@functools.lru_cache(maxsize=None)
def _jax_fit(name):
    """JAX's trainer on the case's inputs split over a ('b', 'f') mesh,
    from the port's initialization."""
    import pb_bss_tpu.models as jax_models
    trainer, inputs, init, kwargs = _case(name)
    if init is None:
        init = _random_draw((*inputs[0].shape[:2], K, T))
        kwargs.pop('num_classes')
    if kwargs.get('use_fused_em') == 'loop':
        # JAX's whole-fit kernel is opt-in and TPU-only: its scan fit
        kwargs.pop('use_fused_em')
    mesh = jax_make_mesh((2, 4) if name.endswith('_b1') else (3, 1),
                         ('b', 'f'))
    return getattr(jax_models, trainer)().fit(
        *[jax_shard_batch_and_frequencies(jnp.asarray(x), mesh)
          for x in inputs], initialization=jnp.asarray(init), **kwargs)


def _leaf(model, key):
    for part in key.split('/'):
        model = getattr(model, part)
    return model


@pytest.mark.parametrize('world', list(WORLDS))
@pytest.mark.parametrize('name', FIT_CASES)
def test_trainers_fit_a_batch_sharded_dtensor(worlds, world, name):
    """Each trainer's fit of a DTensor split over 'b' (and 'f'): every
    rank returns the global model, the unsharded port's at 1e-5, and
    JAX's fit on its ('b', 'f') mesh at ``_jax_tolerance``; the weight
    keeps its global shape ((B, 1, K, 1) frequency-constant, (K, 1) on
    the class axis)."""
    results = worlds[world, name]
    local = gloo._leaves(_unsharded(name).to_dict())
    ref = _jax_fit(name)
    trainer = _case(name)[0]
    assert {k for k in results[0] if not k.startswith(
        ('predict/', 'placed/'))} == set(local), results[0].keys()
    for key, value in local.items():
        ours = gloo.global_value(results, key)
        assert ours.shape == tuple(value.shape), (key, ours.shape)
        np.testing.assert_allclose(ours, value.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
        if name == 'vmfcacgmm_loop' and key.endswith('eigenvectors'):
            # K12's Jacobi fixes each eigenvector's phase its own way
            # (test_torch_parallel_models.py holds its 'loop' fits to
            # JAX's by the weights, eigenvalues and spectral leaves)
            continue
        rtol, atol = _jax_tolerance(key, trainer)
        np.testing.assert_allclose(ours, np.asarray(_leaf(ref, key)),
                                   rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.parametrize('world,name', [
    *[(world, name) for world in WORLDS for name in FIT_CASES],
    *[('f', name) for name in F_ONLY],
])
def test_predict_returns_a_dtensor_placed_as_its_input(worlds, world, name):
    """predict of the fitted model on the DTensor it was fitted on,
    with the global model and with the rank's own block of it: a
    DTensor with the input's mesh, placements and shape, equal to the
    global model's prediction of the full tensor at 1e-6 (the 'f'
    world: bins over 'f', utterances replicated over 'b')."""
    results = worlds[world, name]
    for r in results:
        for model in ('global', 'own'):
            assert r[f'placed/{model}'], (model, r)
            np.testing.assert_allclose(r[f'predict/{model}'],
                                       r['predict/plain'], rtol=1e-6,
                                       atol=1e-6)
    plain = gloo.global_value(results, 'predict/plain')
    np.testing.assert_allclose(plain.sum(-2), np.ones_like(plain.sum(-2)),
                               rtol=1e-5)


@pytest.mark.parametrize('name', F_ONLY)
def test_frequency_split_replicated_over_b_fits_every_utterance(worlds,
                                                                name):
    """On the (2, 2) world a DTensor split over 'f' and replicated over
    'b' fits every utterance on both 'b' ranks, and no sum counts a
    replica twice: the unsharded fit at 1e-5."""
    results = worlds['f', name]
    for key, value in gloo._leaves(_unsharded(name).to_dict()).items():
        np.testing.assert_allclose(gloo.global_value(results, key),
                                   value.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize('split,axis', [('time', 2), ('bins_over_b', 1)])
def test_trainer_refuses_other_splits(worlds, split, axis):
    """A split on T (axis 2 of (B, F, T, D)) over 'f', or of the bins
    over 'b', is no block of the layout: a ValueError naming the
    axis."""
    for r in worlds['refused', split]:
        assert f'on its axis {axis}' in r['error'], r


def test_process_local_batch_fc_fit_and_predict(worlds):
    """The multi-host dry run's sequence on a (2, 2) world: each 'b'
    index passes its one utterance to shard_batch_from_process_local,
    the frequency-constant fit on the scan route (use_fused_em=False)
    returns the (2, 1, K, 1) weight, and predict gives affiliations that
    sum to 1, equal to the unsharded fit's at 1e-5 and to JAX's on its
    (2, 4) mesh at its tolerances."""
    import pb_bss_tpu.models as jax_models
    y, kwargs = _process_local_case()
    results = worlds['scenario', 'process_local']
    local = models.CACGMMTrainer().fit(torch.from_numpy(y), **kwargs)
    affiliation = gloo.global_value(results, 'affiliation')
    weight = gloo.global_value(results, 'weight')
    assert weight.shape == (2, 1, K, 1)
    assert all(r['placed'] for r in results)
    np.testing.assert_allclose(affiliation.sum(-2), 1, rtol=1e-5)
    for ours, theirs in ((weight, local.weight),
                         (gloo.global_value(results, 'eigenvalues'),
                          local.cacg.covariance_eigenvalues),
                         (affiliation, local.predict(torch.from_numpy(y)))):
        np.testing.assert_allclose(ours, theirs.numpy(), rtol=1e-5,
                                   atol=1e-5)
    kwargs.pop('num_classes')
    mesh = jax_make_mesh((2, 4), ('b', 'f'))
    ref = jax_models.CACGMMTrainer().fit(
        jax_shard_batch_and_frequencies(jnp.asarray(y), mesh),
        initialization=jnp.asarray(_random_draw((2, 16, K, 24))), **kwargs)
    np.testing.assert_allclose(weight, np.asarray(ref.weight), rtol=1e-4,
                               atol=1e-5)


def test_log_likelihood_counts_every_block_once(worlds):
    """CACGMM.log_likelihood of a DTensor on a (2, 2) world, split over
    both axes, over 'f' only (replicated over 'b'), over 'b' only and
    replicated: every rank returns the unsharded total (rtol 1e-5), so
    no replica is counted twice."""
    y = _log_likelihood_data()
    results = worlds['scenario', 'log_likelihood']
    for r in results:
        np.testing.assert_allclose(
            r['sharded'], [r['plain']] * len(LOG_LIKELIHOOD_LAYOUTS),
            rtol=1e-5)
    local = models.CACGMMTrainer().fit(torch.from_numpy(y), num_classes=2,
                                       iterations=2)
    np.testing.assert_allclose(
        results[0]['plain'], float(local.log_likelihood(torch.from_numpy(y))),
        rtol=1e-5)


def test_no_per_iteration_collective_crosses_the_batch_axis(worlds):
    """The collectives of fits on a (2, 2) world, recorded by mesh axis:
    a frequency-constant weight all-reduces over 'f' only, once an
    iteration; per-bin weights reduce nothing; each fit ends in one
    packed all-gather over 'f' and one over 'b'. Only a weight constant
    over the utterances sums over 'b' too, once an iteration."""
    results = worlds['scenario', 'collectives']
    gathers = [('all_gather', 'f'), ('all_gather', 'b')]
    for r in results:
        fc_scan, fc_kernel, per_bin, utterances = (x['log'] for x in r)
        assert fc_scan == [('all_reduce', 'f')] * 4 + gathers, fc_scan
        # K5's twin: the initial weight and one a step
        assert fc_kernel == [('all_reduce', 'f')] * 4 + gathers, fc_kernel
        assert per_bin == gathers, per_bin
        assert utterances == [('all_reduce', 'f'),
                              ('all_reduce', 'b')] * 4 + gathers, utterances
