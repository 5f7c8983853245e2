"""Mesh parallelism on ``torch.distributed`` (counterpart of
``pb_bss_tpu.parallel``).

The axes of the JAX package's mesh keep their names:

* ``'f'``: frequency bins, independent through the whole EM and
  extraction pipeline (the sequence-parallel axis of BSS);
* ``'b'``: the utterance batch (the data-parallel axis).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with those
axis names, and a sharded array a ``DTensor`` with ``Shard`` placements
(the counterpart of ``NamedSharding(mesh, P(...))``). One process drives
one device. GSPMD inserts the JAX package's collectives; here they are
explicit, and the trainers and the hand kernels never see a DTensor: the
sharded entry points take each rank's bins (``to_local()``), run the
trainers unchanged on them, and all-reduce over ``'f'`` only where the
JAX program reduces over all frequencies (frequency-constant mixture
weights, the integration models' spectral M-step; ``_shard.py``). Per-bin
fits need no traffic. On one card a world of size 1 runs the same
collectives, as no-ops.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .._dtypes import real_dtype as _real_dtype
from .._shard import axis_shard, frequency_sharded

__all__ = [
    'initialize_distributed',
    'make_mesh',
    'shard_frequencies',
    'shard_batch_and_frequencies',
    'shard_batch_from_process_local',
    'fit_cacgmm_sharded',
    'fit_integration_sharded',
]


def initialize_distributed(
        coordinator_address=None,
        num_processes=None,
        process_id=None,
        *,
        local_device_count=None,
        platform=None,
):
    """Join this process to a ``torch.distributed`` job (the default
    process group), after which :func:`make_mesh` builds meshes over
    every process.

    Args:
        coordinator_address: ``'host:port'`` of rank 0 (``tcp://``
            rendezvous); None reads ``MASTER_ADDR`` / ``MASTER_PORT``,
            ``WORLD_SIZE`` and ``RANK`` from the environment
            (``env://``).
        num_processes / process_id: the world size and this process's
            rank.
        local_device_count: devices this process drives. One process
            drives one device in ``torch.distributed``, so only 1 (or
            None) is accepted.
        platform: ``'cpu'`` joins over gloo; None, ``'cuda'`` or
            ``'gpu'`` over NCCL.
    """
    import torch.distributed as dist
    if local_device_count not in (None, 1):
        raise ValueError(
            f'local_device_count={local_device_count!r}: torch.distributed '
            'drives one device per process; start one process per device '
            'and pass local_device_count=1 (or None)')
    if platform == 'cpu':
        backend = 'gloo'
    elif platform in (None, 'cuda', 'gpu'):
        backend = 'nccl'
    else:
        raise ValueError(f'unknown platform {platform!r}')
    kwargs = {}
    if coordinator_address is not None:
        kwargs['init_method'] = f'tcp://{coordinator_address}'
    else:
        kwargs['init_method'] = 'env://'
    if num_processes is not None:
        kwargs['world_size'] = int(num_processes)
    if process_id is not None:
        kwargs['rank'] = int(process_id)
    dist.init_process_group(backend, **kwargs)


def make_mesh(mesh_shape=None, axis_names=None, devices=None):
    """Build a device mesh over the ranks of the default process group.

    Args:
        mesh_shape: tuple of ints, e.g. ``(2, 2)``; default: every rank
            on one ``'f'`` axis.
        axis_names: names matching ``mesh_shape``; default ``('f',)``
            for 1D, ``('b', 'f')`` for 2D.
        devices: optional explicit list of ranks (default: the first
            ``prod(mesh_shape)`` ranks).
    Returns:
        a ``DeviceMesh`` on CUDA under NCCL, on the CPU otherwise.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError(
            'make_mesh needs a process group: call initialize_distributed '
            'first (a world of size 1 for one device)')
    if devices is None:
        devices = list(range(dist.get_world_size()))
    if mesh_shape is None:
        mesh_shape = (len(devices),)
    mesh_shape = tuple(int(n) for n in mesh_shape)
    if axis_names is None:
        axis_names = ('f',) if len(mesh_shape) == 1 else ('b', 'f')
    assert len(mesh_shape) == len(axis_names), (mesh_shape, axis_names)
    n = 1
    for size in mesh_shape:
        n *= size
    if n > len(devices):
        raise ValueError(f'a mesh of {mesh_shape} needs {n} ranks, '
                         f'{len(devices)} given')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return DeviceMesh(device_type,
                      torch.tensor(devices[:n]).reshape(mesh_shape),
                      mesh_dim_names=tuple(axis_names))


def _placements(mesh, **shards):
    """Placements of ``mesh``'s axes: ``Shard(dim)`` for the axis names
    in ``shards`` (name -> tensor dim), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(shards[name]) if name in shards else Replicate()
            for name in mesh.mesh_dim_names]


def _check_axes(mesh, *names):
    missing = [n for n in names if n not in (mesh.mesh_dim_names or ())]
    if missing:
        raise ValueError(f'the mesh {mesh.mesh_dim_names} has no axis '
                         f'{missing}')


def shard_frequencies(y, mesh, *, frequency_axis=0):
    """A DTensor of ``y`` with its frequency axis split over the mesh's
    ``'f'`` axis, replicated over the others (rank 0's ``y`` is the
    global value)."""
    from torch.distributed.tensor import distribute_tensor
    _check_axes(mesh, 'f')
    y = torch.as_tensor(y)
    return distribute_tensor(
        y, mesh, _placements(mesh, f=frequency_axis % y.ndim))


def shard_batch_and_frequencies(y, mesh, *, batch_axis=0, frequency_axis=1):
    """A DTensor of (batch, frequency, ...) ``y`` over a 2D ('b', 'f')
    mesh."""
    from torch.distributed.tensor import distribute_tensor
    _check_axes(mesh, 'b', 'f')
    y = torch.as_tensor(y)
    return distribute_tensor(
        y, mesh, _placements(mesh, b=batch_axis % y.ndim,
                             f=frequency_axis % y.ndim))


def shard_batch_from_process_local(local_batch, mesh, *,
                                   batch_axis=0, frequency_axis=1):
    """Assemble a global ('b', 'f')-sharded DTensor from each rank's
    utterances: ``local_batch`` is this rank's slice of the batch (the
    ranks of one ``'b'`` index pass the same slice, of equal size on
    every ``'b'`` index); the ``'b'`` axis concatenates the slices in
    rank order, then each rank keeps its bins over ``'f'``."""
    from torch.distributed.tensor import DTensor
    _check_axes(mesh, 'b', 'f')
    local_batch = torch.as_tensor(local_batch)
    batch_axis %= local_batch.ndim
    frequency_axis %= local_batch.ndim
    replicated = DTensor.from_local(local_batch, mesh,
                                    _placements(mesh, b=batch_axis))
    return replicated.redistribute(
        mesh, _placements(mesh, b=batch_axis, f=frequency_axis))


def _local_bins(x, mesh, frequency_axis):
    """This rank's bins of ``x`` (a DTensor, or a tensor / array with
    the global value, sharded here) and the global shape. A tensor must
    live on the mesh's device type (an array is put there)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        frequency_axis %= x.ndim
        x = x.redistribute(mesh, _placements(mesh, f=frequency_axis))
        return x.to_local(), tuple(x.shape)
    if isinstance(x, torch.Tensor) and x.device.type != mesh.device_type:
        raise ValueError(f'a {mesh.device_type} mesh cannot shard a tensor '
                         f'on {x.device}')
    x = torch.as_tensor(x, device=mesh.device_type)
    dtensor = shard_frequencies(x, mesh, frequency_axis=frequency_axis)
    return dtensor.to_local(), tuple(x.shape)


@contextlib.contextmanager
def _sharded_fit(mesh, shape, frequency_axis):
    """The frequency shard of a fit of (..., F, T, D) input of the global
    ``shape`` (``frequency_axis`` among its leading axes); the trainers'
    frequency reductions all-reduce over ``'f'`` inside the block."""
    _check_axes(mesh, 'f')
    axis = frequency_axis % len(shape) - len(shape)
    with frequency_sharded(axis_shard(mesh, 'f', shape[axis],
                                      axis=axis)) as shard:
        yield shard


def _local_initialization(initialization, shard, shape, num_classes,
                          generator, dtype, device):
    """This rank's bins of the initialization: the full random draw of
    the unsharded trainer (so that the draws equal the unsharded call's)
    when None, a DTensor's local part, or the rows of a global tensor or
    array; a model (this rank's own, as the sharded fits return it) as
    it is."""
    from torch.distributed.tensor import DTensor
    if initialization is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        *independent, T, _ = shape
        affiliation = torch.rand((*independent, num_classes, T),
                                 generator=generator, dtype=dtype,
                                 device=device)
        affiliation = affiliation / affiliation.sum(-2, keepdim=True)
        return shard.rows(affiliation, shard.axis)
    if isinstance(initialization, DTensor):
        return initialization.to_local()
    if isinstance(initialization, (torch.Tensor, np.ndarray)):
        initialization = torch.as_tensor(initialization, device=device)
        if initialization.ndim >= -shard.axis \
                and initialization.shape[shard.axis] == shard.total:
            return shard.rows(initialization, shard.axis)
    return initialization


def fit_cacgmm_sharded(
        y,
        mesh,
        *,
        num_classes=None,
        initialization=None,
        iterations=100,
        frequency_axis=0,
        **fit_kwargs,
):
    """Run the cACGMM EM with the frequency axis sharded over ``mesh``'s
    ``'f'`` axis.

    Each rank runs :class:`~pb_bss_tpu_torch.models.CACGMMTrainer`
    unchanged on its bins (every route: the whole-fit kernel, the
    frequency-constant one with its weight all-reduced between launches,
    the streamed one, the scan). A random initialization is the
    unsharded trainer's draw, of which each rank keeps its bins.

    Args:
        y: (..., F, T, D) complex observations, a tensor with the global
            value or a DTensor; ``frequency_axis`` indexes F among the
            leading (independent) dims.
        initialization: None (``num_classes`` and ``generator`` draw
            it), global or sharded affiliations, or this rank's model.
    Returns:
        on each rank, the model of that rank's own bins (the local shard
        of the JAX package's sharded parameters).
    """
    from ..models.cacgmm import CACGMM, CACGMMTrainer
    y_local, shape = _local_bins(y, mesh, frequency_axis)
    with _sharded_fit(mesh, shape, frequency_axis) as shard:
        if not isinstance(initialization, CACGMM):
            initialization = _local_initialization(
                initialization, shard, shape, num_classes,
                fit_kwargs.pop('generator', None), _real_dtype(y_local),
                y_local.device)
            num_classes = None
        return CACGMMTrainer().fit(
            y_local, initialization=initialization,
            num_classes=num_classes, iterations=iterations, **fit_kwargs)


def fit_integration_sharded(
        observation,
        embedding,
        mesh,
        *,
        model='vmfcacgmm',
        num_classes=None,
        initialization=None,
        iterations=100,
        frequency_axis=0,
        **fit_kwargs,
):
    """Run an integration-model EM (vMF x cACG or Gaussian x cACG)
    with the frequency axis sharded over ``mesh``'s ``'f'`` axis.

    The spectral M-step reduces over ALL frequencies (global vMF
    resultants / Gaussian moments): each iteration all-reduces them over
    ``'f'`` (on the K10 route after each statistics launch); the
    per-frequency cACG M-step stays on the rank. The whole-fit kernel
    (``use_fused_em='loop'``, K12) sums every bin inside its one launch
    and cannot all-reduce, so it raises under an ``'f'`` axis larger
    than 1.

    Args:
        observation: (F, T, D) complex; embedding: (F, T, E) real
            (tensors with the global value, or DTensors).
        model: 'vmfcacgmm' | 'gcacgmm'.
    Returns:
        on each rank, the model of that rank's own bins (its spectral
        parameters are global, equal on every rank).
    """
    if model == 'vmfcacgmm':
        from ..models.vmfcacgmm import VMFCACGMMTrainer as Trainer
    elif model == 'gcacgmm':
        from ..models.gcacgmm import GCACGMMTrainer as Trainer
    else:
        raise ValueError(model)
    _check_axes(mesh, 'f')
    if fit_kwargs.get('use_fused_em') == 'loop' \
            and mesh.size(mesh.mesh_dim_names.index('f')) > 1:
        raise ValueError(
            "use_fused_em='loop' fits every bin in one launch, which "
            "cannot all-reduce over 'f'; under frequency sharding use "
            "'step' (or 'auto')")
    obs_local, shape = _local_bins(observation, mesh, frequency_axis)
    emb_local, _ = _local_bins(embedding, mesh, frequency_axis)
    with _sharded_fit(mesh, shape, frequency_axis) as shard:
        initialization = _local_initialization(
            initialization, shard, shape, num_classes,
            fit_kwargs.pop('generator', None), _real_dtype(obs_local),
            obs_local.device)
        return Trainer().fit(
            obs_local, emb_local, initialization=initialization,
            num_classes=None, iterations=iterations, **fit_kwargs)

