"""Mesh parallelism on ``torch.distributed`` (counterpart of
``pb_bss_tpu.parallel``).

The axes of the JAX package's mesh keep their names:

* ``'f'``: frequency bins, independent through the whole EM and
  extraction pipeline (the sequence-parallel axis of BSS);
* ``'b'``: the utterance batch (the data-parallel axis).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with those
axis names, and a sharded array a ``DTensor`` with ``Shard`` placements
(the counterpart of ``NamedSharding(mesh, P(...))``). One process drives
one device: the JAX package's multi-host layout, ``'b'`` over hosts and
``'f'`` over each host's devices, is here a world of one process a
device. GSPMD inserts the JAX package's collectives; here they are
explicit. The five trainers take a DTensor with its bins split over
``'f'`` and / or its utterances over ``'b'`` as it is (what
:func:`shard_frequencies`, :func:`shard_batch_and_frequencies` and
:func:`shard_batch_from_process_local` return;
``_shard.dtensor_entry``; :func:`fit_cacgmm_sharded` and
:func:`fit_integration_sharded` call them so): each rank fits its block
(``to_local()``; the hand kernels never see a DTensor), all-reduces over
``'f'`` only where the JAX program reduces over all frequencies
(frequency-constant mixture weights, the integration models' spectral
M-step) and over ``'b'`` only where it reduces over the utterances (a
weight constant over them; ``_shard.py``), and all-gathers the split
parameters once a mesh axis at the end, so that every rank returns the
global model. The models' ``predict`` take such a DTensor too and
return one placed alike (``_shard.dtensor_predict``). The whole-fit
integration kernel, which cannot be partitioned over the bins, runs on
every bin of every rank (on the rank's utterances).
``separate(_batch)(mesh=)`` runs the trainers on each rank's bins
inside the shard and gathers only what its pipeline needs. On one card
a world of size 1 runs the same collectives, as no-ops.
"""
from __future__ import annotations

import torch

from .._shard import is_dtensor

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
    global value): what the trainers' ``fit`` and the models'
    ``predict`` take, with the frequency axis third from the end."""
    from torch.distributed.tensor import distribute_tensor
    _check_axes(mesh, 'f')
    y = torch.as_tensor(y)
    return distribute_tensor(
        y, mesh, _placements(mesh, f=frequency_axis % y.ndim))


def shard_batch_and_frequencies(y, mesh, *, batch_axis=0, frequency_axis=1):
    """A DTensor of (batch, frequency, ...) ``y`` over a 2D ('b', 'f')
    mesh (rank 0's ``y`` is the global value): what the trainers' ``fit``
    and the models' ``predict`` take, (B, F, T, D) observations and
    (B, F, T, E) embeddings."""
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
    rank order, then each rank keeps its bins over ``'f'``. The trainers'
    ``fit`` and the models' ``predict`` take it, as
    ``scripts/dcn_dryrun.py`` runs the JAX package's."""
    from torch.distributed.tensor import DTensor
    _check_axes(mesh, 'b', 'f')
    local_batch = torch.as_tensor(local_batch)
    batch_axis %= local_batch.ndim
    frequency_axis %= local_batch.ndim
    replicated = DTensor.from_local(local_batch, mesh,
                                    _placements(mesh, b=batch_axis))
    return replicated.redistribute(
        mesh, _placements(mesh, b=batch_axis, f=frequency_axis))


def _frequency_sharded(x, mesh, frequency_axis):
    """``x`` as a DTensor with its ``frequency_axis`` split over the
    mesh's ``'f'`` axis (replicated over the others): a DTensor is
    redistributed; a tensor or array holds the global value (a tensor
    must live on the mesh's device type; an array is put there)."""
    _check_axes(mesh, 'f')
    if is_dtensor(x):
        return x.redistribute(
            mesh, _placements(mesh, f=frequency_axis % x.ndim))
    if isinstance(x, torch.Tensor) and x.device.type != mesh.device_type:
        raise ValueError(f'a {mesh.device_type} mesh cannot shard a tensor '
                         f'on {x.device}')
    return shard_frequencies(torch.as_tensor(x, device=mesh.device_type),
                             mesh, frequency_axis=frequency_axis)


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
    ``'f'`` axis: :class:`~pb_bss_tpu_torch.models.CACGMMTrainer` on
    ``y`` as a DTensor (its DTensor entry).

    Each rank fits its bins on the usual route (the whole-fit kernel,
    the frequency-constant one with its weight all-reduced between
    launches, the streamed one, the scan). A random initialization is
    the unsharded trainer's draw, of which each rank keeps its bins.

    Args:
        y: (..., F, T, D) complex observations, a tensor with the global
            value or a DTensor; ``frequency_axis`` indexes F, the third
            axis from the end.
        initialization: None (``num_classes`` and ``generator`` draw
            it), global or sharded affiliations, or a model: the global
            one (the rank keeps its bins) or the rank's own.
    Returns:
        on every rank, the model with the global value (the counterpart
        of ``np.asarray`` of the JAX package's sharded parameters): its
        per-bin fields are gathered over ``'f'`` once, at the end.
    """
    from ..models.cacgmm import CACGMMTrainer
    return CACGMMTrainer().fit(
        _frequency_sharded(y, mesh, frequency_axis), num_classes=num_classes,
        initialization=initialization, iterations=iterations, **fit_kwargs)


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
    with the frequency axis sharded over ``mesh``'s ``'f'`` axis: the
    trainer on the observation and embedding as DTensors (their DTensor
    entry).

    The spectral M-step reduces over ALL frequencies (global vMF
    resultants / Gaussian moments): on ``'auto'`` / ``'step'`` (K10) and
    the scan each rank fits its bins and all-reduces them over ``'f'``
    every iteration, while the per-frequency cACG M-step stays on the
    rank; that divides the work. The whole-fit kernel
    (``use_fused_em='loop'``, K12) sums every bin inside its one launch:
    as the JAX package's GSPMD does with a call it cannot partition,
    every rank all-gathers the observation and embedding bins and does
    the whole fit on every bin (the unsharded ``'loop'`` fit), then keeps
    its rows.

    Args:
        observation: (..., F, T, D) complex; embedding: (..., F, T, E)
            real (tensors with the global value, or DTensors).
        model: 'vmfcacgmm' | 'gcacgmm'.
    Returns:
        on every rank, the model with the global value (the per-bin
        weight and cACG gathered over ``'f'`` once, at the end; the
        spectral parameters are global already).
    """
    if model == 'vmfcacgmm':
        from ..models.vmfcacgmm import VMFCACGMMTrainer as Trainer
    elif model == 'gcacgmm':
        from ..models.gcacgmm import GCACGMMTrainer as Trainer
    else:
        raise ValueError(model)
    return Trainer().fit(
        _frequency_sharded(observation, mesh, frequency_axis),
        _frequency_sharded(embedding, mesh, frequency_axis),
        num_classes=num_classes, initialization=initialization,
        iterations=iterations, **fit_kwargs)
