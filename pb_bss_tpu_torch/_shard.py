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
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

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
