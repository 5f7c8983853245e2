"""An array axis split over the ranks of a process group, and the
frequency shard of a sharded fit.

:class:`AxisShard` is one axis in ``torch.chunk``'s layout (the layout
of a DTensor ``Shard`` placement: ceil(n / ranks) entries a rank, the
last ranks shorter): this rank's rows of a full tensor, and the full
tensor back from every rank's rows (an all-gather, padded to equal
sizes on the wire).

Inside :func:`frequency_sharded` the EM fits and the extraction run on
one rank's frequency bins, and every reduction over the frequency axis
goes through :func:`frequency_sum`, an all-reduce over the group of the
mesh's ``'f'`` axis; outside it, :func:`frequency_sum` is the identity.
The trainers call it where the JAX package's program reduces over all
bins (frequency-constant mixture weights, the integration models'
spectral M-step, the beamformers' reference-channel SNR), and
:func:`frequency_gather` / :func:`frequency_rows` where a step needs
every bin (the inline permutation aligners). The frequency axis is -3
of the trainers' (..., F, T, D) observations and (..., F, K, T)
affiliations.

A trainer's ``fit`` wrapped by :func:`dtensor_entry` takes a DTensor
sharded over a mesh's ``'f'`` axis (:func:`dtensor_shard`): it fits the
rank's bins inside the frequency shard and returns the global model,
whose per-bin fields (:func:`per_bin_fields`: each component's
``bin_axes``, the mixture weight by the fit's weight axes) come back in
one packed all-gather (:meth:`AxisShard.gather_packed`), as the JAX
trainers return sharded parameters. :func:`on_every_bin` runs a step
that cannot be partitioned (the whole-fit integration kernel) on every
bin of every rank, as GSPMD runs a custom call it cannot partition.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import inspect
import sys

import numpy as np
import torch

FREQUENCY_AXIS = -3


@dataclasses.dataclass(frozen=True)
class AxisShard:
    """``total`` entries of an axis over the ``count`` ranks of
    ``group``; this rank is the ``index``-th. ``axis`` is where the
    axis sits, counted from the end of the trainers' layout."""
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
        in ``tensors``: ONE all-gather of their bytes, packed bin by bin
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


@contextlib.contextmanager
def frequency_sharded(shard):
    """Run the block on the bins of ``shard`` (an :class:`AxisShard`;
    None runs it unsharded)."""
    token = _FREQUENCY.set(shard)
    try:
        yield shard
    finally:
        _FREQUENCY.reset(token)


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


def spans_frequency(axes, ndim):
    """Does a reduction over ``axes`` of an ``ndim``-dim tensor in the
    trainers' layout include the frequency axis?"""
    axes = axes if isinstance(axes, (tuple, list)) else (axes,)
    return ndim >= -FREQUENCY_AXIS and \
        FREQUENCY_AXIS % ndim in {a % ndim for a in axes}


def on_every_bin(fit, inputs, weight_axis):
    """``fit(*inputs)`` on every bin: inside a frequency shard the
    inputs' bins (their axis -3) are all-gathered over ``'f'`` (one
    packed all-gather), ``fit`` runs unsharded on all of them on every
    rank, and the rank's rows of the returned model's per-bin fields
    come back (the weight's at ``weight_axis``). Elsewhere
    ``fit(*inputs)``."""
    shard = _frequency()
    if shard is None:
        return fit(*inputs)
    inputs = shard.gather_packed([(x, FREQUENCY_AXIS) for x in inputs])
    with frequency_sharded(None):
        model = fit(*inputs)
    return model_rows(model, shard, weight_axis)


def per_bin_fields(model, weight_axis):
    """``[(path, tensor, axis)]`` of a mixture model's per-bin tensors,
    from its schema: each component's ``bin_axes`` (a field without
    them, the integration models' vMF or Gaussian spectral model, is
    global), and the mixture ``weight`` at ``weight_axis`` (None: a
    frequency-constant weight, global)."""
    fields = []
    for name in model.__dataclass_fields__:
        value = getattr(model, name)
        if name == 'weight':
            if weight_axis is not None:
                fields.append(((name,), value, weight_axis))
            continue
        for leaf, axis in getattr(value, 'bin_axes', {}).items():
            fields.append(((name, leaf), getattr(value, leaf), axis))
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


def gather_model(model, shard, weight_axis, *extra):
    """The global model from every rank's model of its bins (one packed
    all-gather of the per-bin fields, with the ``(tensor, axis)`` pairs
    of ``extra`` beside them); with ``extra``, ``(model, *tensors)``."""
    fields = per_bin_fields(model, weight_axis)
    gathered = shard.gather_packed(
        [(x, axis) for _, x, axis in fields] + list(extra))
    model = _replace_fields(model, [
        (path, x) for (path, _, _), x in zip(fields, gathered)])
    return (model, *gathered[len(fields):]) if extra else model


def model_rows(model, shard, weight_axis):
    """This rank's bins of a global model's per-bin fields."""
    return _replace_fields(model, [
        (path, shard.rows(x, axis))
        for path, x, axis in per_bin_fields(model, weight_axis)])


def is_dtensor(x):
    """Is ``x`` a ``torch.distributed.tensor.DTensor``? (Without that
    module imported there is none, and nothing is imported here.)"""
    module = sys.modules.get('torch.distributed.tensor')
    return module is not None and isinstance(x, module.DTensor)


def dtensor_shard(x, axis=FREQUENCY_AXIS):
    """The :class:`AxisShard` of a DTensor whose ``axis`` is split over
    its mesh's ``'f'`` axis (a ``Shard`` placement, replicated over
    every other mesh axis); None when it is replicated everywhere.
    Raises ``ValueError`` naming the axis for any other placement."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or (None,) * mesh.ndim
    dim = axis % x.ndim
    shard = None
    for name, placement in zip(names, x.placements):
        if isinstance(placement, Replicate):
            continue
        if not isinstance(placement, Shard):
            raise ValueError(f'a DTensor placed {placement} on the mesh '
                             f'axis {name!r}: only Shard and Replicate '
                             'placements are fitted')
        if name != 'f' or placement.dim % x.ndim != dim:
            raise ValueError(
                f'a DTensor of shape {tuple(x.shape)} sharded on its axis '
                f'{placement.dim % x.ndim} over the mesh axis {name!r}: the '
                f"trainers shard only the frequency axis {dim} ({axis} of "
                "(..., F, T, D)) over 'f'")
        shard = axis_shard(mesh, 'f', x.shape[dim], axis=axis)
    return shard


def _placements(x, mesh, dim):
    """``x``'s placements on ``mesh`` with its axis ``dim`` split over
    ``'f'`` (Replicate elsewhere)."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dim % x.ndim) if name == 'f' else Replicate()
            for name in mesh.mesh_dim_names]


def _local(x, shard, mesh, device, dim):
    """This rank's bins (``dim``) of an input given with a sharded fit's
    observation: a DTensor's local part, split like the observation; a
    tensor or array with the global value, its rows (an axis broadcast
    at size 1 as it is)."""
    if x is None:
        return None
    if is_dtensor(x):
        return x.redistribute(mesh, _placements(x, mesh, dim)).to_local()
    x = torch.as_tensor(x, device=device)
    if x.ndim < -dim or x.shape[dim] != shard.total:
        return x
    return shard.rows(x, dim)


def _local_initialization(initialization, shard, mesh, device,
                          weight_axis):
    """This rank's part of an initialization: affiliations as
    :func:`_local`; a model of every bin (its components' bins span the
    whole axis), its rows; this rank's own model as it is."""
    if initialization is None or isinstance(
            initialization, (torch.Tensor, np.ndarray)):
        return _local(initialization, shard, mesh, device, FREQUENCY_AXIS)
    fields = per_bin_fields(initialization, weight_axis)
    _, x, axis = next(f for f in fields if f[0][0] != 'weight')
    if x.shape[axis] == shard.total:
        return model_rows(initialization, shard, weight_axis)
    return initialization


def dtensor_entry(weight_axis, per_bin):
    """Decorate a trainer's ``fit(self, observation, ...)``: an
    observation that is a DTensor sharded over ``'f'`` on its frequency
    axis (:func:`dtensor_shard`) fits the rank's bins inside the
    frequency shard and returns, on every rank, the global model (and
    with ``_return_affiliation`` the global affiliation), gathered in
    one packed all-gather.

    ``weight_axis(weight_constant_axis, ndim)`` gives the mixture
    weight's frequency axis (None: constant over the bins);
    ``per_bin`` maps the names of the other per-bin arguments
    (embedding, saliency, mask) to their frequency axis. Those and the
    initialization may be DTensors or tensors with the global value. A
    random initialization is the unsharded call's draw in full, of which
    the rank keeps its bins."""
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
            shard = dtensor_shard(observation)
            local = observation.to_local()
            arguments[first] = local
            if shard is None:  # replicated: every rank fits every bin
                for name in (*per_bin, 'initialization'):
                    if is_dtensor(arguments[name]):
                        arguments[name] = arguments[name].full_tensor()
                return fit(*bound.args, **bound.kwargs)
            mesh = observation.device_mesh
            axis = weight_axis(arguments['weight_constant_axis'],
                               observation.ndim)
            for name, dim in per_bin.items():
                arguments[name] = _local(arguments[name], shard, mesh,
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
            arguments['initialization'] = _local_initialization(
                initialization, shard, mesh, local.device, axis)
            arguments['num_classes'] = None
            with frequency_sharded(shard):
                out = fit(*bound.args, **bound.kwargs)
            if isinstance(out, tuple):
                return gather_model(out[0], shard, axis,
                                    (out[1], FREQUENCY_AXIS))
            return gather_model(out, shard, axis)
        return wrapper
    return decorate
