"""The profiler's capture of a traced window and its reduction.

From the raw events of one ``torch.profiler`` capture: the seconds in
which the device ran anything (the union of its kernel, copy and set
intervals), the device time of each ``sepbench.<span>`` range (the
kernels whose launch, matched by the profiler's correlation id, falls
inside the range on the host; kernels launched from the program's own
libraries count like any other), its host time and count, the host
synchronizations inside it, the kernels that took the most device time,
and the longest idle gaps of the device by what the host was doing. On
the card a capture now and then records no device time; it is taken
again after a pause, up to five times.
"""
from __future__ import annotations

import collections
import math
import time

import numpy as np

SYNC_NAMES = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize')


def events(prof):
    return list(prof.profiler.kineto_results.events())


def _on_device(event):
    """A kernel, copy or set on the device (the device's copies of the
    spans' ranges are left out)."""
    return (event.device_type().name != 'CPU'
            and not event.name().startswith('sepbench.'))


def capture(torch, run, attempts=5):
    """(profile, window seconds) of ``run()`` under the profiler, or
    (None, seconds) when every attempt recorded no device time."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    wall = 0.0
    for attempt in range(attempts):
        if attempt:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            start = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        if any(_on_device(e) and e.duration_ns() > 0 for e in events(prof)):
            return prof, wall
    return None, wall


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class Reduced:
    """busy_s, window_s, spans {name: {'device_s', 'host_s', 'count',
    'syncs', 'operations'}}, device_ops [[name, s]], idle_gaps [[name, s]], and
    ``unmatched``: the device operations attributed to no span.

    A device operation belongs to the spans whose host range holds its
    launch: the runtime call with its correlation id, or else the host
    operation the profiler links it to. The program's own libraries
    launch through a runtime the profiler does not see; their kernels
    are found by name instead (``kernels``: {span: [part of a kernel's
    name]}, from the layer files) and belong to the last range of that
    span that began before the kernel did.
    """

    def __init__(self, raw, window_s, kernels=None):
        device, host, launch, ops = [], [], {}, {}
        for e in raw:
            start = e.start_ns() / 1e9
            row = (e.name(), start, start + e.duration_ns() / 1e9)
            if _on_device(e):
                device.append(row + (e.correlation_id(),
                                     e.linked_correlation_id()))
            elif e.device_type().name == 'CPU':
                host.append(row)
                if e.linked_correlation_id() > 0:
                    launch[e.correlation_id()] = start
                else:
                    ops[e.correlation_id()] = start
        busy = _merge((start, end) for _, start, end, *_ in device)
        self.window_s = window_s
        self.busy_s = sum(end - start for start, end in busy)
        spans = [(name[len('sepbench.'):], start, end)
                 for name, start, end in host
                 if name.startswith('sepbench.')]
        launched = [launch[c] if c in launch else
                    ops.get(linked, math.nan) if linked > 0 else math.nan
                    for *_, c, linked in device]
        self.spans = self._spans(spans, device, host, launched)
        named = self._named(spans, device, launched, kernels or {})
        for span, (seconds, operations) in named.items():
            self.spans.setdefault(span, {'device_s': 0.0, 'host_s': 0.0,
                                         'count': 0, 'syncs': 0,
                                         'operations': 0})
            self.spans[span]['device_s'] += seconds
            self.spans[span]['operations'] += operations
        self.unmatched = sum(math.isnan(t) for t in launched) \
            - self.named_count
        self.device_ops = self._device_ops(device)
        self.idle_gaps = self._idle_gaps(busy, host)

    @staticmethod
    def _spans(spans, device, host, launched):
        out = collections.defaultdict(
            lambda: {'device_s': 0.0, 'host_s': 0.0, 'count': 0,
                     'syncs': 0, 'operations': 0})
        syncs = np.array(sorted(start for name, start, _ in host
                                if name in SYNC_NAMES))
        launched = np.array(launched)
        lengths = np.array([end - start for _, start, end, *_ in device])
        for name, start, end in spans:
            span = out[name]
            inside = (launched >= start) & (launched < end)
            span['device_s'] += float(lengths[inside].sum())
            span['operations'] += int(inside.sum())
            span['host_s'] += end - start
            span['count'] += 1
            span['syncs'] += int(((syncs >= start) & (syncs < end)).sum())
        return dict(out)

    def _named(self, spans, device, launched, kernels):
        """{span: [seconds, operations]} of the kernels with no launch
        found whose names a span's layer lists."""
        starts = collections.defaultdict(list)
        for name, start, _ in spans:
            starts[name].append(start)
        out = collections.defaultdict(lambda: [0.0, 0])
        self.named_count = 0
        for (name, start, end, *_), when in zip(device, launched):
            if not math.isnan(when):
                continue
            for span, parts in kernels.items():
                if any(part in name for part in parts) and any(
                        s <= start for s in starts.get(span, ())):
                    out[span][0] += end - start
                    out[span][1] += 1
                    self.named_count += 1
                    break
        return out

    @staticmethod
    def _device_ops(device, top=10):
        total = collections.Counter()
        for name, start, end, *_ in device:
            total[name[:160]] += end - start
        return [[name, s] for name, s in total.most_common(top)]

    @staticmethod
    def _idle_gaps(busy, host, top=10, examined=400):
        """The longest gaps between device activity, summed by the
        innermost span and the innermost host operation running at each
        gap's middle."""
        gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1],
                        busy[i + 1][0]) for i in range(len(busy) - 1)),
                      reverse=True)[:examined]
        names = [name for name, _, _ in host]
        starts = np.array([start for _, start, _ in host])
        ends = np.array([end for _, _, end in host])
        length = ends - starts
        is_span = np.array([n.startswith('sepbench.') for n in names],
                           dtype=bool)
        total = collections.Counter()
        for gap, start, end in gaps:
            middle = (start + end) / 2
            inside = (starts <= middle) & (middle < ends)
            label = []
            for pick in (inside & is_span, inside & ~is_span):
                if pick.any():
                    label.append(names[int(np.argmin(
                        np.where(pick, length, np.inf)))])
            total[(' / '.join(label) or 'no host operation')[:160]] += gap
        return [[name, s] for name, s in total.most_common(top)]


__all__ = ['capture', 'events', 'Reduced', 'SYNC_NAMES']
