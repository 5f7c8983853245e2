"""pb_bss_tpu_torch.utils.profiling: the host wall-clock Timer (as the
JAX package's) and the torch.profiler trace."""
import json
import os
import time
import warnings

import pytest
import torch

from pb_bss_tpu.utils.profiling import Timer as JaxTimer
from pb_bss_tpu_torch.utils import profiling


def test_timer_accumulates_like_jax():
    timer, jax_timer = profiling.Timer(), JaxTimer()
    for t in (timer, jax_timer):
        for _ in range(2):
            with t['phase']:
                time.sleep(0.01)
        with t['other']:
            pass
    assert list(timer.times) == list(jax_timer.times) == ['phase', 'other']
    assert timer.times['phase'] >= 0.02
    assert timer.as_dict() == timer.times
    assert timer.as_dict() is not timer.times
    assert repr(timer).startswith('Timer(phase: ')


def test_timer_counts_a_phase_that_raises():
    timer = profiling.Timer()
    with pytest.raises(RuntimeError):
        with timer['failing']:
            raise RuntimeError
    assert timer.times['failing'] >= 0


def _trace_files(directory):
    return [os.path.join(directory, f) for f in os.listdir(directory)
            if f.endswith('.pt.trace.json')]


def test_trace_writes_a_cpu_chrome_trace(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter('error', RuntimeWarning)
        with profiling.trace(str(tmp_path)) as log_dir:
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(tmp_path)
    [path] = _trace_files(tmp_path)
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)['traceEvents']
    assert any('mm' in event.get('name', '') for event in events)


def test_trace_warns_when_the_cuda_capture_holds_no_device_event(
        tmp_path, monkeypatch):
    """CUDA activity asked for (faked here: the CPU build records none)
    and no device event captured: the trace is still written, with a
    RuntimeWarning that names its file."""
    monkeypatch.setattr(profiling, '_cuda_activity', lambda: True)
    with pytest.warns(RuntimeWarning, match='no device event') as record:
        with warnings.catch_warnings():
            # torch.profiler's own note that CUDA is unavailable here
            warnings.filterwarnings('ignore', 'CUDA is not available')
            with profiling.trace(str(tmp_path)):
                torch.ones(8) + 1
    [path] = _trace_files(tmp_path)
    assert os.path.getsize(path) > 0
    assert any(path in str(w.message) for w in record)
