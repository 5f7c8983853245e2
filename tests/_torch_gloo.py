"""Worlds of ``torch.distributed`` processes on gloo for the port's
parallel tests.

:func:`run_world` spawns ``world_size`` processes that join one gloo
group through a file store in the test's ``tmp_path`` (so that
concurrent test workers never race for a port), runs a scenario of this
module on every rank and returns each rank's result. Every world has a
deadline: a hung collective kills the processes and fails the test.

This module imports torch and the port only: the spawned processes
never import jax.
"""
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, scenario, world_size, directory, args, store):
    torch.set_num_threads(1)
    if store:
        dist.init_process_group(
            'gloo', init_method=f'file://{directory}/store',
            world_size=world_size, rank=rank)
        try:
            result = scenario(*args)
        finally:
            dist.destroy_process_group()
    else:
        result = scenario(rank, world_size, *args)
    with open(os.path.join(directory, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(result, f)


def run_world(scenario, world_size, tmp_path, *args, timeout=120,
              store=True):
    """``scenario(*args)`` on each rank of a gloo world of
    ``world_size`` processes; the list of their results in rank order.
    Without ``store`` the scenario joins a group of its own and is
    called as ``scenario(rank, world_size, *args)``. Fails the calling
    test after ``timeout`` seconds."""
    directory = str(tmp_path / f'world{time.monotonic_ns()}')
    os.makedirs(directory)
    context = mp.start_processes(
        _entry, args=(scenario, world_size, directory, args, store),
        nprocs=world_size, join=False, start_method='spawn')
    deadline = time.monotonic() + timeout
    try:
        while not context.join(
                timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f'{scenario.__name__}: the world of {world_size} did '
                    f'not finish in {timeout} s')
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()
                process.join()
    results = []
    for rank in range(world_size):
        with open(os.path.join(directory, f'rank{rank}.pkl'), 'rb') as f:
            results.append(pickle.load(f))
    return results


def _numpy(x):
    return x.detach().cpu().numpy()


def _mesh(shape, names=None):
    from pb_bss_tpu_torch.parallel import make_mesh
    return make_mesh(shape, names)


def cacgmm_fit(y, init, mesh_shape, fit_kwargs):
    """fit_cacgmm_sharded of (F, T, D) ``y`` from ``init`` (None: the
    random draw); the weight and eigenvalues of the global model it
    returns. ``_step_gate=False``
    in ``fit_kwargs`` closes K5's gate in this process;
    ``inline_permutation_aligner='dhtv'`` takes DHTV for a 512-point
    STFT."""
    from pb_bss_tpu_torch.parallel import fit_cacgmm_sharded
    mesh = _mesh(mesh_shape)
    kwargs = dict(fit_kwargs)
    if not kwargs.pop('_step_gate', True):
        # send the frequency-constant fit past K5's gate to the streamed
        # route
        from pb_bss_tpu_torch.ops import em_step
        em_step.fits = lambda *args: False
    if kwargs.get('inline_permutation_aligner') == 'dhtv':
        from pb_bss_tpu_torch.permutation_alignment import (
            DHTVPermutationAlignment)
        kwargs['inline_permutation_aligner'] = \
            DHTVPermutationAlignment.from_stft_size(512)
    if init is None:
        kwargs['num_classes'] = kwargs.pop('num_classes')
    else:
        kwargs['initialization'] = torch.from_numpy(init)
        kwargs.pop('num_classes', None)
    model = fit_cacgmm_sharded(torch.from_numpy(y), mesh, **kwargs)
    return dict(weight=_numpy(model.weight),
                eigenvalues=_numpy(model.cacg.covariance_eigenvalues))


def mixture_fit(trainer, y, init, mesh_shape, fit_kwargs):
    """A CWMM / CBMM trainer's fit of (F, T, D) ``y`` as a DTensor
    sharded over the mesh's 'f' axis (the trainers' DTensor entry; the
    JAX package shards them by GSPMD) from the global ``init``; the
    leaves of the global model it returns."""
    from pb_bss_tpu_torch import models
    from pb_bss_tpu_torch.parallel import shard_frequencies
    mesh = _mesh(mesh_shape)
    model = getattr(models, trainer)().fit(
        shard_frequencies(torch.from_numpy(y), mesh),
        initialization=torch.from_numpy(init), **fit_kwargs)
    return {k: _numpy(v) for k, v in _leaves(model.to_dict()).items()}


def trainer_fit(trainer, inputs, init, mesh_shape, shard_dim, fit_kwargs):
    """``trainer``'s fit of ``inputs`` (the observation, and an
    integration trainer's embedding): the observation a DTensor split on
    its axis ``shard_dim`` over the mesh's 'f' axis, the embedding a
    DTensor alike (``fit_kwargs['_embedding'] == 'dtensor'``) or the
    global tensor; from the global ``init`` (None: ``num_classes`` in
    ``fit_kwargs``). The leaves of the model it returns, or the
    ValueError's message."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from pb_bss_tpu_torch import models
    mesh = _mesh(mesh_shape)
    kwargs = dict(fit_kwargs)
    embedding = kwargs.pop('_embedding', None)
    inputs = [torch.from_numpy(x) for x in inputs]
    inputs[0] = distribute_tensor(inputs[0], mesh, [Shard(shard_dim)])
    if embedding == 'dtensor':
        inputs[1] = distribute_tensor(inputs[1], mesh, [Shard(shard_dim)])
    if init is not None:
        kwargs['initialization'] = torch.from_numpy(init)
    try:
        model = getattr(models, trainer)().fit(*inputs, **kwargs)
    except ValueError as error:
        return dict(error=str(error))
    return {k: _numpy(v) for k, v in _leaves(model.to_dict()).items()}


def cacgmm_resume(y, init, mesh_shape, fit_kwargs):
    """fit_cacgmm_sharded for 2 iterations, then resumed for 3 from the
    global model it returns and from this rank's own bins of it; the
    weights and eigenvalues of the three global models."""
    from pb_bss_tpu_torch._shard import (
        axis_shard,
        model_rows,
        model_weight_axis,
    )
    from pb_bss_tpu_torch.parallel import fit_cacgmm_sharded
    mesh = _mesh(mesh_shape)
    y = torch.from_numpy(y)
    first = fit_cacgmm_sharded(y, mesh, initialization=torch.from_numpy(init),
                               iterations=2, **fit_kwargs)
    own = model_rows(first, (axis_shard(mesh, 'f', y.shape[0]),),
                     model_weight_axis(first, y.ndim))
    out = {'own_bins': own.cacg.covariance_eigenvalues.shape[0]}
    for name, model in (('first', first), ('global', first), ('own', own)):
        if name != 'first':
            model = fit_cacgmm_sharded(y, mesh, initialization=model,
                                       iterations=3, **fit_kwargs)
        out[f'{name}/weight'] = _numpy(model.weight)
        out[f'{name}/eigenvalues'] = _numpy(
            model.cacg.covariance_eigenvalues)
    return out


def _leaves(d, prefix=''):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + '/'))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


def integration_fit(model_name, obs, emb, init, mesh_shape, fit_kwargs):
    """fit_integration_sharded; the leaves of the global model it
    returns."""
    from pb_bss_tpu_torch.parallel import fit_integration_sharded
    mesh = _mesh(mesh_shape)
    model = fit_integration_sharded(
        torch.from_numpy(obs), torch.from_numpy(emb), mesh,
        model=model_name, initialization=torch.from_numpy(init),
        **fit_kwargs)
    return {k: _numpy(v) for k, v in _leaves(model.to_dict()).items()}


def pipeline(observations, init, mesh_shape, names, kwargs):
    """The port's batched pipeline under a mesh from a given
    initialization (B, F, K, T); every rank's (B, K, N) output."""
    from pb_bss_tpu_torch.pipeline import _separate
    mesh = _mesh(mesh_shape, names)
    out = _separate(torch.from_numpy(observations), torch.from_numpy(init),
                    mesh=mesh, **kwargs)
    return _numpy(out)


def separate(observations, mesh_shape, names, kwargs):
    """separate_batch(mesh=) of (B, D, N) ``observations`` with its own
    random initialization, or separate(mesh=) of (D, N) ones."""
    from pb_bss_tpu_torch import separate, separate_batch
    mesh = _mesh(mesh_shape, names)
    run = separate_batch if observations.ndim == 3 else separate
    return _numpy(run(torch.from_numpy(observations), mesh=mesh, **kwargs))


def batch_frequency_fit(y, mesh_shape):
    """shard_batch_and_frequencies and shard_batch_from_process_local
    on a ('b', 'f') mesh; a fit and a predict of the rank's block."""
    from pb_bss_tpu_torch.models import CACGMMTrainer
    from pb_bss_tpu_torch.parallel import (
        shard_batch_and_frequencies,
        shard_batch_from_process_local,
    )
    mesh = _mesh(mesh_shape, ('b', 'f'))
    y = torch.from_numpy(y)
    sharded = shard_batch_and_frequencies(y, mesh)
    b = mesh.get_local_rank('b')
    B = y.shape[0] // mesh.size(0)
    from_local = shard_batch_from_process_local(y[b * B:(b + 1) * B], mesh)
    local = sharded.to_local()
    model = CACGMMTrainer().fit(local, num_classes=2, iterations=3)
    return dict(local=_numpy(local), from_local=_numpy(from_local.to_local()),
                shape=tuple(sharded.shape),
                from_local_shape=tuple(from_local.shape),
                affiliation=_numpy(model.predict(local)))


def beamformers(y, mask, mesh_shape):
    """PSD, GEV and MVDR-Souden (a fixed and an estimated reference
    channel) on the rank's bins of (F, D, T) ``y``; the vectors and the
    beamformed bins of the rank."""
    from pb_bss_tpu_torch._shard import axis_shard, frequency_sharded
    from pb_bss_tpu_torch.extraction.beamformer import (
        apply_beamforming_vector,
        get_gev_vector,
        get_mvdr_vector_souden,
        get_power_spectral_density_matrix,
    )
    mesh = _mesh(mesh_shape)
    shard = axis_shard(mesh, 'f', y.shape[0])
    y = shard.rows(torch.from_numpy(y), 0)
    mask = shard.rows(torch.from_numpy(mask), 0)
    with frequency_sharded(shard):
        phi_xx = get_power_spectral_density_matrix(y, mask)
        phi_nn = get_power_spectral_density_matrix(y, 1 - mask)
        out = {}
        for name, w in (
                ('gev', get_gev_vector(phi_xx, phi_nn)),
                ('mvdr', get_mvdr_vector_souden(phi_xx, phi_nn,
                                                ref_channel=0)),
                ('mvdr_ref', get_mvdr_vector_souden(
                    phi_xx, phi_nn, return_ref_channel=True))):
            if isinstance(w, tuple):
                w, out['ref_channel'] = w[0], int(w[1])
            out[name] = _numpy(apply_beamforming_vector(w, y))
    return out


def local_shapes(total, mesh_shape):
    """This rank's rows of ``total`` bins by the pipeline's AxisShard and
    by a DTensor's Shard placement."""
    from pb_bss_tpu_torch._shard import axis_shard
    from pb_bss_tpu_torch.parallel import shard_frequencies
    mesh = _mesh(mesh_shape)
    x = torch.arange(total * 2.0).reshape(total, 2)
    shard = axis_shard(mesh, 'f', total)
    return dict(rows=_numpy(shard.rows(x, 0)),
                dtensor=_numpy(shard_frequencies(x, mesh).to_local()),
                gathered=_numpy(shard.gather(shard.rows(x, 0), 0)),
                reduced=_numpy(shard.sum(torch.ones(3) * (shard.index + 1))))


def initialize(rank, world_size, port):
    """initialize_distributed over tcp (a group of its own, no file
    store) and make_mesh's defaults."""
    from pb_bss_tpu_torch.parallel import initialize_distributed, make_mesh
    initialize_distributed(f'127.0.0.1:{port}', world_size, rank,
                           local_device_count=1, platform='cpu')
    try:
        mesh1 = make_mesh()
        mesh2 = make_mesh((1, world_size))
        total = torch.ones(1)
        dist.all_reduce(total, group=mesh1.get_group('f'))
        return dict(backend=dist.get_backend(), names1=mesh1.mesh_dim_names,
                    names2=mesh2.mesh_dim_names, shape2=tuple(mesh2.shape),
                    device=mesh1.device_type, total=float(total))
    finally:
        dist.destroy_process_group()


def global_value(results, key):
    """One key of every rank's result, which every rank holds alike (the
    global value, bit for bit)."""
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])
    return results[0][key]


def concatenate(results, key, axis=0):
    """One key of every rank's result joined along ``axis`` (the bins)."""
    return np.concatenate([r[key] for r in results], axis)


def _distribute(x, mesh, dims):
    """``x`` as a DTensor split on its axis ``dims[name]`` over each mesh
    axis named in ``dims`` (replicated over the others)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    return distribute_tensor(
        torch.from_numpy(x), mesh,
        [Shard(dims[name]) if name in dims else Replicate()
         for name in mesh.mesh_dim_names])


def _predictions(model, args, observation):
    """``model.predict`` of the DTensor ``observation`` with the global
    model and with this rank's own block of it: the full affiliations,
    whether each came back placed as the observation, and the global
    model's prediction of the full tensor (``predict/plain``)."""
    from pb_bss_tpu_torch._shard import (
        dtensor_shards,
        model_rows,
        model_weight_axis,
    )
    own = model_rows(model, dtensor_shards(observation),
                     model_weight_axis(model, observation.ndim))
    plain = model.predict(observation.full_tensor(),
                          *[x.full_tensor() if hasattr(x, 'full_tensor')
                            else x for x in args])
    out = {'predict/plain': _numpy(plain)}
    for name, m in (('global', model), ('own', own)):
        affiliation = m.predict(observation, *args)
        if isinstance(affiliation, tuple):
            affiliation = affiliation[0]
        out[f'predict/{name}'] = _numpy(affiliation.full_tensor())
        out[f'placed/{name}'] = (
            tuple(affiliation.placements) == tuple(observation.placements)
            and tuple(affiliation.shape) == (*observation.shape[:-2],
                                             *affiliation.shape[-2:]))
    return out


def batch_fits(cases, mesh_shape, names):
    """Each case of ``cases`` on a mesh of ``mesh_shape`` and ``names``:
    the trainer's fit of the observation as a DTensor split on its axis
    ``dims[name]`` over each mesh axis ``name`` (an integration
    trainer's embedding a DTensor alike, ``'dtensor'``, or the global
    tensor), from the global ``init`` (None: ``num_classes`` in the
    kwargs); the leaves of the model it returns and its prediction of
    the DTensor with the global model and with the rank's own
    (:func:`_predictions`). A ValueError's message instead."""
    from pb_bss_tpu_torch import models
    mesh = _mesh(mesh_shape, names)
    results = []
    for case in cases:
        observation = _distribute(case['inputs'][0], mesh, case['dims'])
        args = [torch.from_numpy(x) for x in case['inputs'][1:]]
        if case.get('embedding') == 'dtensor':
            args = [_distribute(x, mesh, case['dims'])
                    for x in case['inputs'][1:]]
        kwargs = dict(case['kwargs'])
        if case['init'] is not None:
            kwargs['initialization'] = torch.from_numpy(case['init'])
        try:
            model = getattr(models, case['trainer'])().fit(
                observation, *args, **kwargs)
        except ValueError as error:
            results.append(dict(error=str(error)))
            continue
        out = {k: _numpy(v) for k, v in _leaves(model.to_dict()).items()}
        out.update(_predictions(model, args, observation))
        results.append(out)
    return results


def collective_log(y, init, mesh_shape, fits):
    """cACGMM fits of the (B, F, T, D) ``y`` split over 'b' and 'f' from
    the global ``init``, one a kwargs of ``fits``, with every all-reduce
    and all-gather each makes recorded by the mesh axis whose group it
    used ('b', 'f' or 'other'); each fit's log and global weight."""
    from pb_bss_tpu_torch.models import CACGMMTrainer
    mesh = _mesh(mesh_shape, ('b', 'f'))
    observation = _distribute(y, mesh, {'b': 0, 'f': 1})
    groups = {id(mesh.get_group(name)): name for name in ('b', 'f')}
    log = []
    originals = {name: getattr(dist, name)
                 for name in ('all_reduce', 'all_gather')}

    def recorder(name):
        def call(*args, group=None, **kwargs):
            log.append((name, groups.get(id(group), 'other')))
            return originals[name](*args, group=group, **kwargs)
        return call

    out = []
    for fit_kwargs in fits:
        for name in originals:
            setattr(dist, name, recorder(name))
        try:
            model = CACGMMTrainer().fit(
                observation, initialization=torch.from_numpy(init),
                **fit_kwargs)
        finally:
            for name, call in originals.items():
                setattr(dist, name, call)
        out.append(dict(log=list(log), weight=_numpy(model.weight)))
        log.clear()
    return out


def process_local_fit(y, mesh_shape, fit_kwargs):
    """The multi-host dry run's sequence on a ('b', 'f') mesh: each 'b'
    index passes its own utterances of ``y`` to
    shard_batch_from_process_local, the trainer fits the global DTensor,
    and the model predicts it; the weight, the eigenvalues and the full
    affiliation."""
    from pb_bss_tpu_torch.models import CACGMMTrainer
    from pb_bss_tpu_torch.parallel import shard_batch_from_process_local
    mesh = _mesh(mesh_shape, ('b', 'f'))
    b, per_rank = mesh.get_local_rank('b'), y.shape[0] // mesh.size(0)
    observation = shard_batch_from_process_local(
        torch.from_numpy(y[b * per_rank:(b + 1) * per_rank]), mesh)
    model = CACGMMTrainer().fit(observation, **fit_kwargs)
    affiliation = model.predict(observation)
    return dict(weight=_numpy(model.weight),
                eigenvalues=_numpy(model.cacg.covariance_eigenvalues),
                affiliation=_numpy(affiliation.full_tensor()),
                placed=tuple(affiliation.placements)
                == tuple(observation.placements))


def log_likelihoods(y, mesh_shape, names, layouts):
    """CACGMM.log_likelihood of a DTensor of the (B, F, T, D) ``y`` in
    each layout of ``layouts`` (mesh axis -> observation axis; an axis
    left out replicates it), from the unsharded fit of ``y``."""
    from pb_bss_tpu_torch.models import CACGMMTrainer
    mesh = _mesh(mesh_shape, names)
    model = CACGMMTrainer().fit(torch.from_numpy(y), num_classes=2,
                                iterations=2)
    return dict(plain=float(model.log_likelihood(torch.from_numpy(y))),
                sharded=[float(model.log_likelihood(
                    _distribute(y, mesh, dims))) for dims in layouts])


def scenarios(calls):
    """Each ``(scenario, args)`` of ``calls`` in turn on this rank (one
    world for several scenarios); their results in order."""
    return [scenario(*args) for scenario, args in calls]
