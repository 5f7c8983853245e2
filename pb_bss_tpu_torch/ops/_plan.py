"""The host side of the streamed statistics pass that the cACGMM kernel
K4 (:mod:`.em_stream`) and the Watson / Bingham kernel K7
(:mod:`.mm_stream`) share (``csrc/stream.cuh``): its work plan and its
shared memory.

A pass over N bins of T frames lays the N T frames end to end and cuts
them into equal spans, one per CTA, in whole waves of the CTAs the card
holds at once (:func:`partition`), so that no wave runs nearly empty. Each
piece of a bin that a CTA covers (a segment, :func:`segments`) writes its
partial sums to its own slot, and the wrapper adds a bin's slots in a
fixed order (deterministic, no atomics); where the kernel adds them itself
(the last CTA on a split bin, found by a ticket), it takes its counters
and slots from :func:`workspace`. :func:`capacity` asks a kernel
library how many of its CTAs are resident at once; :func:`pass_words` is
the pass's own share of a CTA's shared memory.
"""
from __future__ import annotations

import functools

import torch

__all__ = ['TILE', 'WAVES', 'partition', 'segments', 'capacity',
           'pass_words', 'workspace']

TILE = 256  # frames per tile (kTile in csrc/stream.cuh)
_GROUP = 4  # classes summed in registers at once (kGroup)
_STAGES = 2  # tiles in flight (kStages)
_WARPS = 8  # warps per CTA (kThreads / 32)
# waves of the grid: one, two, four and eight ran alike for K4 on the H100
# (chip_smoke.py's splits; PERF.md); four keep the spans short
WAVES = 4


def partition(N, T, capacity, tile=TILE, waves=WAVES):
    """(ctas, span, slots) of one pass over N bins of T frames on a card
    that holds ``capacity`` CTAs at once: the N T frames laid end to end
    are cut into ``ctas`` spans of ``span`` frames, ``waves`` whole waves
    of ``capacity`` CTAs (the last span may be shorter; at least a tile
    each), CTA g taking frames [g span, (g + 1) span). A bin's frames then
    fall to at most ``slots`` consecutive CTAs; the one starting at CTA
    floor(n T / span) + s writes the bin's slot s."""
    return _spans(N, T, max(waves * capacity, 1), tile)


@functools.lru_cache(maxsize=None)
def _spans(N, T, target, tile):
    """partition for a grid of about ``target`` CTAs, once per shape (the
    slot count walks the bins)."""
    total = N * T
    span = max(-(-total // target), tile)
    ctas = -(-total // span)
    slots = max(((n + 1) * T - 1) // span - n * T // span + 1
                for n in range(N))
    return ctas, span, slots


def segments(N, T, span):
    """The (cta, bin, first frame, end frame, slot) of every piece of a
    bin that a CTA covers, in the order the kernel walks them (CTA by
    CTA, then by frame): the host's copy of the kernel's walk, for
    tests."""
    out = []
    total = N * T
    for g in range(-(-total // span)):
        pos, end = g * span, min((g + 1) * span, total)
        while pos < end:
            n = pos // T
            t0, t1 = pos - n * T, min(end - n * T, T)
            out.append((g, n, t0, t1, g - n * T // span))
            pos = n * T + t1
    return out


@functools.lru_cache(maxsize=None)
def capacity(name, device_index, *shape):
    """CTAs of one pass of kernel library ``name`` resident at once on the
    card: its ``<name>_capacity(*shape)`` occupancy query (blocks per SM
    times the SMs)."""
    from ._build import load
    with torch.cuda.device(device_index):
        value = getattr(load(name), f'{name}_capacity')(*shape)
    if value <= 0:
        raise RuntimeError(
            f'{name} occupancy query failed: CUDA error {-value}')
    return value


def pass_words(D):
    """Float-sized words of a CTA's shared memory that the pass itself
    takes (ring_words + kPassWords in csrc/stream.cuh): the tile ring (or,
    if larger, the cross-warp reduction's scratch), the tile's scatter
    weights and the reduction's affiliation sums."""
    P = D * (D + 1) // 2
    ring = max(_STAGES * D * (TILE + 1) * 2,
               _WARPS * _GROUP * -(-P // 32) * 32 * 2)
    return ring + TILE * _GROUP + _WARPS * _GROUP


# per (device, stream): the bins' counters (0 between launches) and the
# slots of the split bins' partial sums
_workspaces = {}


def workspace(device, stream, N, words):
    """Counters for N bins and ``words`` floats of slots, reused by every
    pass that sums its split bins in the launch (the integration
    statistics, the E-step scatter) on ``stream``: stream order keeps the
    launches apart, and each leaves the counters at 0. Grown on demand."""
    key = (device.index, stream)
    counters, slots = _workspaces.get(key, (None, None))
    if counters is None or counters.numel() < N:
        counters = torch.zeros(max(N, 1), dtype=torch.int32, device=device)
    if slots is None or slots.numel() < words:
        slots = torch.empty(max(words, 2), dtype=torch.float32,
                            device=device)
    _workspaces[key] = counters, slots
    return counters, slots
