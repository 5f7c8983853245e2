"""Profiling and tracing helpers (counterpart of
``pb_bss_tpu.utils.profiling``): a per-phase host wall-clock
:class:`Timer`, and :func:`trace`, a ``torch.profiler`` capture written
as a Chrome trace (the JAX package's ``trace`` writes a JAX profiler
trace)."""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
import warnings

import torch

__all__ = ['Timer', 'trace']


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


def _cuda_activity():
    """Record CUDA activity? (when a card is present)"""
    return torch.cuda.is_available()


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the block with ``torch.profiler`` and write its Chrome
    trace (``chrome://tracing``, Perfetto, TensorBoard's profiler) to
    ``<log_dir>/<pid>.<ns>.pt.trace.json``; yields ``log_dir``.

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
    with profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(log_dir,
                        f'{os.getpid()}.{time.time_ns()}.pt.trace.json')
    prof.export_chrome_trace(path)
    if cuda and not any(event.device_type == torch.autograd.DeviceType.CUDA
                        for event in prof.events()):
        warnings.warn(
            f'the profiler captured no device event: {path} holds host '
            'events only', RuntimeWarning, stacklevel=3)
