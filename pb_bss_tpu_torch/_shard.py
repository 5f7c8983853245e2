"""An array axis split over the ranks of a process group, and the
block of a sharded fit: its frequency bins and its utterances.

:class:`AxisShard` is one axis in ``torch.chunk``'s layout (the layout
of a DTensor ``Shard`` placement: ceil(n / ranks) entries a rank, the
last ranks shorter): this rank's rows of a full tensor, and the full
tensor back from every rank's rows (an all-gather, padded to equal
sizes on the wire).

Inside :func:`frequency_sharded` (or :func:`block_sharded`) the EM fits
and the extraction run on one rank's frequency bins, and every
reduction over the frequency axis goes through :func:`frequency_sum`,
an all-reduce over the group of the mesh's ``'f'`` axis; outside it,
:func:`frequency_sum` is the identity. The trainers call it where the
JAX package's program reduces over all bins (frequency-constant
mixture weights, the integration models' spectral M-step, the
beamformers' reference-channel SNR), and :func:`frequency_gather` /
:func:`frequency_rows` where a step needs every bin (the inline
permutation aligners). The frequency axis is -3 of the trainers'
(..., F, T, D) observations and (..., F, K, T) affiliations. Inside
:func:`block_sharded` the fit also runs on one rank's utterances (an
axis left of the bins, split over the mesh's ``'b'`` axis); the
utterances are independent, so only a reduction over that axis crosses
``'b'`` (:func:`sharded_sum`: a mixture weight constant over the
utterances).

A trainer's ``fit`` wrapped by :func:`dtensor_entry` takes a DTensor
whose bins are split over a mesh's ``'f'`` axis and / or whose
utterances are split over its ``'b'`` axis (:func:`dtensor_shards`): it
fits the rank's block inside :func:`block_sharded` and returns the
global model, whose split fields (:func:`sharded_fields`: each
component's ``bin_axes`` and ``core_ranks``, the mixture weight by the
fit's weight axes) come back in one packed all-gather a mesh axis
(:meth:`AxisShard.gather_packed`), as the JAX trainers return sharded
parameters. A model's ``predict`` wrapped by :func:`dtensor_predict`
runs on the rank's block and returns a DTensor placed as its input.
:func:`on_every_bin` runs a step that cannot be partitioned over the
bins (the whole-fit integration kernel) on every bin of every rank, as
GSPMD runs a custom call it cannot partition.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import inspect
import math
import sys

import numpy as np
import torch

FREQUENCY_AXIS = -3


@dataclasses.dataclass(frozen=True)
class AxisShard:
    """``total`` entries of an axis over the ``count`` ranks of
    ``group``; this rank is the ``index``-th. ``axis`` is where the
    axis sits, counted from the end of the trainers' layout (-3 for the
    bins; the utterances' axis left of them)."""
    group: object
    total: int
    index: int
    count: int
    axis: int = FREQUENCY_AXIS

    @property
    def sizes(self):
        chunk = -(-self.total // self.count)
        return [max(0, min(chunk, self.total - i * chunk))
                for i in range(self.count)]

    @property
    def start(self):
        return sum(self.sizes[:self.index])

    @property
    def size(self):
        return self.sizes[self.index]

    def rows(self, x, dim):
        """This rank's rows of the full ``x`` along ``dim``."""
        return x.narrow(dim, self.start, self.size)

    def gather(self, x, dim):
        """The full tensor from every rank's rows ``x`` along ``dim``."""
        import torch.distributed as dist
        dim = dim % x.ndim
        longest = max(self.sizes)
        if x.shape[dim] < longest:
            pad = list(x.shape)
            pad[dim] = longest - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.count)]
        dist.all_gather(parts, x, group=self.group)
        if self.count == 1:
            return parts[0]
        return torch.cat([part.narrow(dim, 0, size)
                          for part, size in zip(parts, self.sizes)], dim)

    def gather_packed(self, tensors):
        """The full tensors from every rank's rows of each ``(x, dim)``
        in ``tensors``: ONE all-gather of their bytes, packed row by row
        (any dtypes; bit for bit)."""
        rows, layouts = [], []
        for x, dim in tensors:
            x = x.movedim(dim % x.ndim, 0)
            real = torch.view_as_real(x) if x.is_complex() else x
            layouts.append((x.dtype, real.dtype, tuple(real.shape[1:]),
                            dim))
            rows.append(real.contiguous().reshape(x.shape[0], -1)
                        .view(torch.uint8))
        widths = [r.shape[1] for r in rows]
        gathered = self.gather(torch.cat(rows, 1), 0)
        out = []
        for part, (dtype, real_dtype, trailing, dim) in zip(
                gathered.split(widths, 1), layouts):
            x = part.contiguous().view(real_dtype).reshape(-1, *trailing)
            if dtype.is_complex:
                x = torch.view_as_complex(x)
            out.append(x.movedim(0, dim % x.ndim))
        return out

    def sum(self, x):
        """``x`` summed over the ranks of the group."""
        import torch.distributed as dist
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


def axis_shard(mesh, name, total, axis=FREQUENCY_AXIS):
    """The :class:`AxisShard` of ``total`` entries over the mesh axis
    ``name`` of a ``DeviceMesh``, or None when the mesh has no such
    axis. Raises ``ValueError`` when a rank would hold no entry."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    shard = AxisShard(group=mesh.get_group(name), total=int(total),
                      index=mesh.get_local_rank(name),
                      count=mesh.size(mesh.mesh_dim_names.index(name)),
                      axis=axis)
    if 0 in shard.sizes:
        raise ValueError(f'{shard.total} entries leave a rank of the '
                         f'{shard.count} on the mesh axis {name!r} without '
                         'one')
    return shard


_FREQUENCY = contextvars.ContextVar('pb_bss_tpu_torch_frequency_shard',
                                    default=None)
_BATCH = contextvars.ContextVar('pb_bss_tpu_torch_batch_shard',
                                default=None)


@contextlib.contextmanager
def frequency_sharded(shard):
    """Run the block on the bins of ``shard`` (an :class:`AxisShard`;
    None runs it unsharded)."""
    token = _FREQUENCY.set(shard)
    try:
        yield shard
    finally:
        _FREQUENCY.reset(token)


@contextlib.contextmanager
def block_sharded(frequency, batch):
    """Run the block on the bins of ``frequency`` and the utterances of
    ``batch`` (:class:`AxisShard` s; None leaves that axis whole)."""
    token = _BATCH.set(batch)
    try:
        with frequency_sharded(frequency):
            yield
    finally:
        _BATCH.reset(token)


def _frequency():
    shard = _FREQUENCY.get()
    if shard is None or shard.axis != FREQUENCY_AXIS:
        return None
    return shard


def frequency_sum(x):
    """``x``, a sum over this rank's frequency bins, summed over every
    bin: an all-reduce inside a sharded fit, ``x`` itself elsewhere."""
    shard = _frequency()
    return x if shard is None else shard.sum(x)


def frequency_bins(local):
    """The number of bins of the whole frequency axis (``local`` when
    unsharded)."""
    shard = _frequency()
    return local if shard is None else shard.total


def frequency_gather(x, dim):
    """Every bin of ``x``, this rank's bins along ``dim``."""
    shard = _frequency()
    return x if shard is None else shard.gather(x, dim)


def frequency_rows(x, dim):
    """This rank's bins of ``x``, every bin along ``dim``."""
    shard = _frequency()
    return x if shard is None else shard.rows(x, dim)


def _axes(axes, ndim):
    axes = axes if isinstance(axes, (tuple, list)) else (axes,)
    return {a % ndim for a in axes}


def spans_frequency(axes, ndim):
    """Does a reduction over ``axes`` of an ``ndim``-dim tensor in the
    trainers' layout include the frequency axis?"""
    return ndim >= -FREQUENCY_AXIS and FREQUENCY_AXIS % ndim in _axes(
        axes, ndim)


def _spanned_batch(axes, ndim):
    """The batch shard of a sharded fit when a reduction over ``axes``
    of an ``ndim``-dim tensor in the trainers' layout includes its
    utterance axis, else None."""
    shard = _BATCH.get()
    if shard is None or ndim < -shard.axis:
        return None
    return shard if shard.axis % ndim in _axes(axes, ndim) else None


def spans_shard(axes, ndim):
    """Does a reduction over ``axes`` include the frequency axis, or the
    utterance axis of a batch-sharded fit?"""
    return spans_frequency(axes, ndim) or \
        _spanned_batch(axes, ndim) is not None


def sharded_sum(x, axes, ndim):
    """``x``, a sum over ``axes`` of this rank's block of an
    ``ndim``-dim tensor in the trainers' layout, summed over every
    rank's block: all-reduced over ``'f'`` where the axes include the
    frequency axis and over ``'b'`` where they include the utterance
    axis (inside a sharded fit; ``x`` itself elsewhere)."""
    if spans_frequency(axes, ndim):
        x = frequency_sum(x)
    shard = _spanned_batch(axes, ndim)
    return x if shard is None else shard.sum(x)


def sharded_count(shape, axes):
    """The number of entries a sum over ``axes`` of a tensor of this
    rank's ``shape`` covers over every rank's block."""
    ndim = len(shape)
    count = math.prod(shape[a] for a in _axes(axes, ndim))
    if spans_frequency(axes, ndim):
        count = count // shape[FREQUENCY_AXIS] * frequency_bins(
            shape[FREQUENCY_AXIS])
    shard = _spanned_batch(axes, ndim)
    if shard is not None:
        count = count // shape[shard.axis] * shard.total
    return count


def squeezed_weight_axis(weight_constant_axis, ndim, axis):
    """The axis of a mixture weight summed over ``weight_constant_axis``
    of ``ndim``-dim (..., F, K, T) affiliations and squeezed there (the
    integration models' weight) that holds the affiliations' ``axis``,
    or None when the weight is constant over it (a constant class axis
    leaves a scalar)."""
    axes = _axes(weight_constant_axis, ndim)
    if ndim - 2 in axes or axis % ndim in axes:
        return None
    return axis + sum(1 for a in axes if a > axis % ndim)


def model_weight_axis(model, ndim):
    """``axis -> `` the axis of a given model's weight that holds the
    ``axis`` of ``ndim``-dim affiliations, or None: an integration
    model's squeezed weight by its own ``weight_constant_axis``; a
    mixture weight kept in the affiliations' layout (CACGMM, CWMM, CBMM)
    where it is not broadcast over the axis (size 1), none in the class
    axis's (K, 1)."""
    weight = model.weight
    constant = getattr(model, 'weight_constant_axis', None)
    if constant is not None:
        return functools.partial(squeezed_weight_axis, constant, ndim)
    return lambda axis: (axis if weight.ndim >= -axis
                         and weight.shape[axis] != 1 else None)


def on_every_bin(fit, inputs, weight_axis):
    """``fit(*inputs)`` on every bin: inside a frequency shard the
    inputs' bins (their axis -3) are all-gathered over ``'f'`` (one
    packed all-gather), ``fit`` runs on all of them on every rank (on
    the rank's utterances, which stay split), and the rank's rows of
    the returned model's per-bin fields come back (the weight's at
    ``weight_axis(-3)``). Elsewhere ``fit(*inputs)``."""
    shard = _frequency()
    if shard is None:
        return fit(*inputs)
    inputs = shard.gather_packed([(x, FREQUENCY_AXIS) for x in inputs])
    with frequency_sharded(None):
        model = fit(*inputs)
    return model_rows(model, (shard,), weight_axis)


def sharded_fields(model, shard, weight_axis):
    """``[(path, tensor, axis)]`` of a mixture model's tensors split
    over ``shard``'s axis, from its schema. Over the bins (axis -3):
    each component's ``bin_axes``. Over the utterances, which lie as far
    left of the bins in every field as in the observation: each
    component's ``bin_axes`` moved by that offset, and the fields of a
    component without bins (the integration models' vMF or Gaussian
    spectral model) at their ``core_ranks`` left of it. The mixture
    ``weight`` at ``weight_axis(shard.axis)`` (None: constant over the
    axis)."""
    offset = shard.axis - FREQUENCY_AXIS
    fields = []
    for name in model.__dataclass_fields__:
        value = getattr(model, name)
        if name == 'weight':
            axis = weight_axis(shard.axis)
            if axis is not None:
                fields.append(((name,), value, axis))
            continue
        for leaf, axis in getattr(value, 'bin_axes', {}).items():
            fields.append(((name, leaf), getattr(value, leaf),
                           axis + offset))
        if offset:
            for leaf, rank in getattr(value, 'core_ranks', {}).items():
                fields.append(((name, leaf), getattr(value, leaf),
                               offset - rank))
    return fields


def _replace_fields(model, values):
    """``model`` with the tensors at each ``path`` replaced."""
    changes = {}
    for path, value in values:
        changes.setdefault(path[0], []).append((path[1:], value))
    return model.replace(**{
        name: (_replace_fields(getattr(model, name), inner)
               if inner[0][0] else inner[0][1])
        for name, inner in changes.items()})


def gather_model(model, shards, weight_axis, *extra):
    """The global model from every rank's model of its block: over each
    mesh axis of ``shards`` (the bins, then the utterances), one packed
    all-gather of the fields split over it (:func:`sharded_fields`) and
    of the tensors of ``extra`` (in the affiliations' layout); with
    ``extra``, ``(model, *tensors)``."""
    tensors = list(extra)
    for shard in shards:
        if shard is None:
            continue
        fields = sharded_fields(model, shard, weight_axis)
        gathered = shard.gather_packed(
            [(x, axis) for _, x, axis in fields]
            + [(x, shard.axis) for x in tensors])
        model = _replace_fields(model, [
            (path, x) for (path, _, _), x in zip(fields, gathered)])
        tensors = gathered[len(fields):]
    return (model, *tensors) if extra else model


def model_rows(model, shards, weight_axis):
    """This rank's block of a global model's fields split over
    ``shards``."""
    for shard in shards:
        if shard is not None:
            model = _replace_fields(model, [
                (path, shard.rows(x, axis))
                for path, x, axis in sharded_fields(model, shard,
                                                    weight_axis)])
    return model


def _model_block(model, shards, weight_axis):
    """This rank's block of a given model: over each axis of
    ``shards``, a model of the whole axis (its components span it) is
    cut to the rank's rows; the rank's own model, or one broadcast over
    the axis, is taken as it is."""
    for shard in shards:
        if shard is None:
            continue
        fields = [field for field in sharded_fields(model, shard,
                                                    weight_axis)
                  if field[1].ndim >= -field[2]]
        span = next((x.shape[axis] for path, x, axis in fields
                     if path[0] != 'weight'), None)
        if span == shard.total:
            model = _replace_fields(model, [
                (path, shard.rows(x, axis)) for path, x, axis in fields])
    return model


def is_dtensor(x):
    """Is ``x`` a ``torch.distributed.tensor.DTensor``? (Without that
    module imported there is none, and nothing is imported here.)"""
    module = sys.modules.get('torch.distributed.tensor')
    return module is not None and isinstance(x, module.DTensor)


def dtensor_shards(x):
    """``(frequency, batch)``: the :class:`AxisShard` s of a DTensor in
    the trainers' (..., F, T, D) layout whose frequency axis (-3) is
    split over its mesh's ``'f'`` axis and / or one utterance axis left
    of it over ``'b'`` (``Shard`` placements, ``Replicate`` elsewhere);
    None for an axis left whole. Raises ``ValueError`` naming the axis
    for any other placement."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or (None,) * mesh.ndim
    frequency = x.ndim + FREQUENCY_AXIS
    shards = {}
    for name, placement in zip(names, x.placements):
        if isinstance(placement, Replicate):
            continue
        if not isinstance(placement, Shard):
            raise ValueError(f'a DTensor placed {placement} on the mesh '
                             f'axis {name!r}: only Shard and Replicate '
                             'placements are fitted')
        dim = placement.dim % x.ndim
        if name == 'f' and dim == frequency:
            axis = FREQUENCY_AXIS
        elif name == 'b' and 0 <= dim < frequency:
            axis = dim - x.ndim
        else:
            raise ValueError(
                f'a DTensor of shape {tuple(x.shape)} sharded on its axis '
                f'{dim} over the mesh axis {name!r}: the trainers shard the '
                f'frequency axis {frequency} ({FREQUENCY_AXIS} of '
                "(..., F, T, D)) over 'f' and an utterance axis left of it "
                "over 'b'")
        shards[name] = axis_shard(mesh, name, x.shape[dim], axis=axis)
    return shards.get('f'), shards.get('b')


def _local(x, shards, mesh, device, dim):
    """This rank's block of an input given with a sharded fit's
    observation, whose bins lie at ``dim`` (its utterances as far left
    of them as the observation's): a DTensor's local part, split like
    the observation; a tensor or array with the global value, its rows
    (an axis broadcast at size 1, or missing, as it is)."""
    if x is None:
        return None
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        placements = {}
        for shard, name in zip(shards, ('f', 'b')):
            if shard is not None:
                axis = dim + shard.axis - FREQUENCY_AXIS
                if x.ndim >= -axis:
                    placements[name] = Shard(axis % x.ndim)
        return x.redistribute(mesh, [
            placements.get(name, Replicate())
            for name in mesh.mesh_dim_names]).to_local()
    x = torch.as_tensor(x, device=device)
    for shard in shards:
        if shard is not None:
            axis = dim + shard.axis - FREQUENCY_AXIS
            if x.ndim >= -axis and x.shape[axis] == shard.total:
                x = shard.rows(x, axis)
    return x


def dtensor_entry(weight_axis, per_bin):
    """Decorate a trainer's ``fit(self, observation, ...)``: an
    observation that is a DTensor with its bins split over ``'f'`` and /
    or its utterances over ``'b'`` (:func:`dtensor_shards`) fits the
    rank's block inside :func:`block_sharded` and returns, on every
    rank, the global model (and with ``_return_affiliation`` the global
    affiliation), gathered in one packed all-gather a mesh axis.

    ``weight_axis(weight_constant_axis, ndim, axis)`` gives the axis of
    the fitted mixture weight that holds the ``axis`` of the ``ndim``-dim
    affiliations (None: constant over it); ``per_bin`` maps the names of
    the other per-bin arguments (embedding, saliency, mask) to their
    frequency axis. Those and the initialization (affiliations, or a
    model: the global one or the rank's own) may be DTensors or tensors
    with the global value. A random initialization is the unsharded
    call's draw in full, of which the rank keeps its block."""
    def decorate(fit):
        signature = inspect.signature(fit)
        first = list(signature.parameters)[1]

        @functools.wraps(fit)
        def wrapper(self, observation, *args, **kwargs):
            if not is_dtensor(observation):
                return fit(self, observation, *args, **kwargs)
            bound = signature.bind(self, observation, *args, **kwargs)
            bound.apply_defaults()
            arguments = bound.arguments
            shards = dtensor_shards(observation)
            local = observation.to_local()
            arguments[first] = local
            if shards == (None, None):  # replicated: every rank fits all
                for name in (*per_bin, 'initialization'):
                    if is_dtensor(arguments[name]):
                        arguments[name] = arguments[name].full_tensor()
                return fit(*bound.args, **bound.kwargs)
            mesh = observation.device_mesh
            axis = functools.partial(weight_axis,
                                     arguments['weight_constant_axis'],
                                     observation.ndim)
            for name, dim in per_bin.items():
                arguments[name] = _local(arguments[name], shards, mesh,
                                         local.device, dim)
            initialization = arguments['initialization']
            assert (initialization is None) != (
                arguments['num_classes'] is None), (
                'Provide either `initialization` or `num_classes` — not '
                'both and not neither.')
            if initialization is None:
                generator = arguments.get('generator')
                if generator is None:
                    generator = torch.Generator(
                        device=local.device).manual_seed(0)
                *independent, T, _ = observation.shape
                dtype = (local.real if local.is_complex() else local).dtype
                initialization = torch.rand(
                    (*independent, arguments['num_classes'], T),
                    generator=generator, dtype=dtype, device=local.device)
                initialization = initialization / initialization.sum(
                    -2, keepdim=True)
                arguments['generator'] = None
            if is_dtensor(initialization) or isinstance(
                    initialization, (torch.Tensor, np.ndarray)):
                initialization = _local(initialization, shards, mesh,
                                        local.device, FREQUENCY_AXIS)
            else:
                initialization = _model_block(
                    initialization, shards,
                    model_weight_axis(initialization, observation.ndim))
            arguments['initialization'] = initialization
            arguments['num_classes'] = None
            with block_sharded(*shards):
                out = fit(*bound.args, **bound.kwargs)
            if isinstance(out, tuple):
                return gather_model(out[0], shards, axis, out[1])
            return gather_model(out, shards, axis)
        return wrapper
    return decorate


def _like(x, observation):
    """A DTensor of this rank's block ``x`` of an output in the
    observation's (..., F, ...) layout: the observation's mesh and
    placements, its global shape up to the bins and ``x``'s own trailing
    axes."""
    from torch.distributed.tensor import DTensor
    shape = (*observation.shape[:-2], *x.shape[-2:])
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(x, observation.device_mesh,
                              observation.placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def dtensor_predict(per_bin=None, total=False):
    """Decorate a model's ``predict(self, observation, ...)``: an
    observation that is a DTensor (:func:`dtensor_shards`) is predicted
    block by block. The rank runs the plain call on its block with its
    block of the model (a global model, as a DTensor fit returns it, is
    cut to the rank's rows; the rank's own is taken as it is) and of
    the ``per_bin`` arguments (name -> frequency axis; DTensors or
    tensors with the global value). Each tensor it returns comes back as
    a DTensor with the observation's mesh and placements; with
    ``total``, the call returns a sum, which is all-reduced over the
    sharded axes only (every distinct block once, never a replica) and
    comes back as the same plain tensor on every rank."""
    per_bin = per_bin or {}

    def decorate(predict):
        signature = inspect.signature(predict)
        own, first = list(signature.parameters)[:2]

        @functools.wraps(predict)
        def wrapper(self, observation, *args, **kwargs):
            if not is_dtensor(observation):
                return predict(self, observation, *args, **kwargs)
            bound = signature.bind(self, observation, *args, **kwargs)
            arguments = bound.arguments
            shards = dtensor_shards(observation)
            local = observation.to_local()
            arguments[first] = local
            for name, dim in per_bin.items():
                if name in arguments:
                    arguments[name] = _local(
                        arguments[name], shards, observation.device_mesh,
                        local.device, dim)
            arguments[own] = _model_block(
                self, shards, model_weight_axis(self, observation.ndim))
            out = predict(*bound.args, **bound.kwargs)
            if total:
                for shard in shards:
                    if shard is not None:
                        out = shard.sum(out)
                return out
            if isinstance(out, tuple):
                return tuple(_like(x, observation) for x in out)
            return _like(out, observation)
        return wrapper
    return decorate
