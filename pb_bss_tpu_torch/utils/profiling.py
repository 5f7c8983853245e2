"""Profiling and tracing helpers (counterpart of
``pb_bss_tpu.utils.profiling``): a per-phase host wall-clock
:class:`Timer`; :func:`trace`, a ``torch.profiler`` capture written
as a Chrome trace (the JAX package's ``trace`` writes a JAX profiler
trace); and the program's own spans and counters.

Spans and counters. The pipeline's layers run inside named
:class:`span` s, always recorded on the host: each span keeps its name,
its parent and its start and end on ``time.time_ns()``, the clock the
profiler stamps its host events with, so a span can be laid over a
``torch.profiler`` trace. The outermost span on a thread opens a
*request*; every span and :func:`count` until it closes belongs to it,
and so do the kernel launches made meanwhile (the change of the
``.launches`` attribute of each kernel wrapper that ``ops._build.counted``
registered, as ``launches.<module>.<function>``).
:func:`requests` returns the last 1,024 completed requests. Nothing is
written to disk, and no setting turns the recording on or off: it
costs a few microseconds a span.

The spans of a call of :func:`pb_bss_tpu_torch.pipeline.separate_batch`
(root ``separate_batch``; ``separate`` for one recording):

* ``init``: the EM initialization's draws, one generator an utterance
  (its host read of their seeds included);
* ``stft`` and ``istft``: the transforms;
* ``em``: the trainer's fit, with the counter ``em.route.<route>`` of
  the route it took (``whole``, ``fc``, ``stream``, ``t_blocked`` or
  ``scan`` for the cACGMM, ``cwmm`` or ``cbmm`` for the other models)
  and, on the ``whole`` route, ``em.whole.scatter_frames.<G>``, the
  frames a lane of the kernel's scatter sums at once
  (``ops.em_loop.scatter_frames``);
* ``dhtv``: the permutation alignment, with a ``dhtv.read`` span around
  each host read of its early exit (the first waits for the work queued
  before it, mostly the EM) and the counter ``dhtv.iterations`` of the
  iterations that ran;
* ``beamformer``: the PSDs, beamforming vectors, phase correction and
  beamforming;
* ``fca`` in its place with ``refine='fca'``: the FCA refinement, its
  ``fca.fit`` (the counters ``fca.iterations``, the MU / IP iterations,
  ``fca.ip_rows``, the diagonalizer rows solved: D x IP sweeps x
  iterations, and ``fca.ip_sweeps``, the IP sweeps, each with its D
  rows' covariances in one pass) and ``fca.separate`` (the Wiener back-transform). A fit
  or a separation called on its own is a request of its own.

A call of :func:`pb_bss_tpu_torch.evaluation.bss_eval_stoi_fused_batch`
is a request ``score``, with ``score.read`` around its copy to the host.

Only inside :func:`trace` does a span also open a ``torch.profiler``
range, named ``pb_bss_tpu_torch.<span>``, so the Chrome trace shows the
spans over the device's timeline; a ``torch.profiler`` capture of one's
own holds none of them.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import tempfile
import threading
import time
import typing
import warnings

import torch

__all__ = ['Timer', 'trace', 'span', 'count', 'requests', 'clear',
           'Span', 'Request']


class Timer:
    """Per-phase wall-clock accumulation (host clock: synchronize the
    device inside a phase to time device work).

    >>> timer = Timer()
    >>> with timer['phase1']:
    ...     _ = sum(range(10))
    >>> sorted(timer.times) == ['phase1']
    True
    """

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def _measure(self, name):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) \
                + time.perf_counter() - start

    def __getitem__(self, name):
        return self._measure(name)

    def as_dict(self):
        return dict(self.times)

    def __repr__(self):
        inner = ', '.join(
            f'{k}: {v * 1e3:.2f} ms' for k, v in self.times.items())
        return f'Timer({inner})'


RING = 1024
PREFIX = 'pb_bss_tpu_torch.'
# the kernel wrappers that count their launches in ``.launches``, by
# counter name ``launches.<module>.<function>``; ``ops._build.counted``
# registers each as its module is imported
_launch_counters = {}


def _register_launches(function):
    """Carry ``function.launches`` in every request (``ops._build.counted``;
    a function registered again under its name replaces the first)."""
    module = function.__module__.rpartition('.')[2]
    _launch_counters[f'launches.{module}.{function.__name__}'] = function


class Span(typing.NamedTuple):
    """One span of a request: ``parent`` is the index of the enclosing
    span in the request's ``spans`` (None for the root); times are
    ``time.time_ns()``."""
    name: str
    parent: typing.Optional[int]
    start_ns: int
    end_ns: int


class Request(typing.NamedTuple):
    """A completed request: its spans in the order they opened (the
    root first) and its counters, launches included."""
    id: int
    root: str
    spans: tuple
    counters: dict


class _Thread(threading.local):
    """The open spans, as (index in ``spans``, profiler range or None);
    the open request's ``spans`` ([name, parent, start_ns, end_ns]),
    ``counters`` and ``launches`` (the counts at its start, by wrapper)
    are set by its root."""

    def __init__(self):
        self.stack = []


_thread = _Thread()
_finished = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_ranges = 0  # > 0 while trace() records


def _launch_counts():
    return {function: function.launches
            for function in _launch_counters.values()}


class span:
    """A named span of the program, as a context manager or a
    decorator (``@span('stft')``; the function keeps its name). The
    outermost span on a thread opens a request; see the module's
    docstring."""

    __slots__ = ('name',)

    def __init__(self, name):
        if name.startswith('sepbench.'):
            raise ValueError(f'a span name may not start with sepbench.: '
                             f'{name!r}')
        self.name = name

    def __enter__(self):
        state = _thread
        if state.stack:
            parent = state.stack[-1][0]
        else:
            parent = None
            state.spans, state.counters = [], {}
            state.launches = _launch_counts()
        start = time.time_ns()
        scope = None
        if _ranges:
            scope = torch.profiler.record_function(PREFIX + self.name)
            scope.__enter__()
        state.stack.append((len(state.spans), scope))
        state.spans.append([self.name, parent, start, 0])
        return self

    def __exit__(self, *exc):
        state = _thread
        index, scope = state.stack.pop()
        if scope is not None:
            scope.__exit__(None, None, None)
        state.spans[index][3] = time.time_ns()
        if not state.stack:
            counters = state.counters
            for name, function in _launch_counters.items():
                # a wrapper registered since the request opened counts
                # from 0
                launched = function.launches \
                    - state.launches.get(function, 0)
                if launched:
                    counters[name] = launched
            _finished.append(Request(
                next(_ids), state.spans[0][0],
                tuple(Span(*s) for s in state.spans), counters))
        return False

    def __call__(self, function):
        @functools.wraps(function)
        def spanned(*args, **kwargs):
            with self:
                return function(*args, **kwargs)
        return spanned


def count(name, n=1):
    """Add ``n`` to the counter ``name`` of the open request (nothing
    outside a span)."""
    state = _thread
    if state.stack:
        state.counters[name] = state.counters.get(name, 0) + n


def requests(last=None):
    """The completed requests, oldest first (the ``last`` ones only
    when given); at most :data:`RING` are kept."""
    done = list(_finished)
    return done if last is None else done[max(0, len(done) - last):]


def clear():
    """Forget the completed requests."""
    _finished.clear()


def _cuda_activity():
    """Record CUDA activity? (when a card is present)"""
    return torch.cuda.is_available()


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the block with ``torch.profiler`` and write its Chrome
    trace (``chrome://tracing``, Perfetto, TensorBoard's profiler) to
    ``<log_dir>/<pid>.<ns>.pt.trace.json``; yields ``log_dir``. Inside
    the block every :class:`span` is also a profiler range named
    ``pb_bss_tpu_torch.<span>``.

    CUDA activity is recorded when a card is present. The card's
    profiler (CUPTI) can return a capture without device events; the
    trace is written all the same, with a ``RuntimeWarning`` that names
    the file (nothing is retried).

    Args:
        log_dir: the directory of the trace; default
            ``pb_bss_tpu_torch_trace`` in the temporary directory.
    """
    from torch.profiler import ProfilerActivity, profile
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               'pb_bss_tpu_torch_trace')
    os.makedirs(log_dir, exist_ok=True)
    cuda = _cuda_activity()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    global _ranges
    with profile(activities=activities) as prof:
        _ranges += 1
        try:
            yield log_dir
        finally:
            _ranges -= 1
    path = os.path.join(log_dir,
                        f'{os.getpid()}.{time.time_ns()}.pt.trace.json')
    prof.export_chrome_trace(path)
    if cuda and not any(event.device_type == torch.autograd.DeviceType.CUDA
                        for event in prof.events()):
        warnings.warn(
            f'the profiler captured no device event: {path} holds host '
            'events only', RuntimeWarning, stacklevel=3)
