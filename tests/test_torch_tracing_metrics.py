"""The benchmark's readers of the program's spans and counters
(``sepbench/metrics/{step_init_ms,dhtv_self_ms,dhtv_read_ms,
dhtv_iterations}.py``): a run of a separation cell, cut to the CPU's
size, reports each of them, equal to the value computed by hand from
``profiling.requests()`` of the window's calls; where the program keeps
no requests, or fewer than the window's calls, they read nothing.

The run is made in a process of its own: the runner refuses a process
that has loaded JAX, as this one has (the reference side of the tests).
The CPU cannot take a traced run (it synchronizes the card), so the
readers are read in the place of the untraced run's end-to-end
metrics."""
import json
import pathlib
import subprocess
import sys
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from sepbench.harness import runner  # noqa: E402

NEW = ('step_init_ms', 'dhtv_self_ms', 'dhtv_read_ms', 'dhtv_iterations')

_RUN = r'''
import json, sys, time
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from small import cell
from sepbench.harness import runner
from pb_bss_tpu_torch.utils import profiling

c = cell('utt.b512', iterations=3)
c.end_to_end = [m for m in c.per_layer if m['name'] in {names!r}]
result = runner.run(c, 2 ** 31 + 77, 0.5, False, torch=torch,
                    device=torch.device('cpu'), process_start=time.time(),
                    log=lambda line: None)
print(json.dumps({{
    'metrics': {{k: v['value'] for k, v in result['metrics'].items()}},
    'calls': result['attempted'] // c.traffic['batch'],
    'requests': [[r.root, [list(s) for s in r.spans], r.counters]
                 for r in profiling.requests()]}}))
'''


@pytest.fixture(scope='module')
def run():
    script = _RUN.format(tests=str(ROOT / 'sepbench' / 'tests'),
                         names=list(NEW))
    done = subprocess.run([sys.executable, '-c', script], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def _by_hand(requests, calls):
    window = [r for r in requests if r[0] == 'separate_batch'][-calls:]
    assert len(window) == calls
    init = self_ms = read_ms = iterations = 0
    for _, spans, counters in window:
        iterations += counters.get('dhtv.iterations', 0)
        for index, (name, parent, start, end) in enumerate(spans):
            if name == 'init':
                init += end - start
            if name == 'dhtv':
                reads = [s for s in spans
                         if s[0] == 'dhtv.read' and s[1] == index]
                self_ms += end - start - (reads[0][3] - reads[0][2])
                read_ms += sum(e - s for _, _, s, e in reads[1:])
    return {'step_init_ms': init / 1e6 / calls,
            'dhtv_self_ms': self_ms / 1e6 / calls,
            'dhtv_read_ms': read_ms / 1e6 / calls,
            'dhtv_iterations': iterations / calls}


@pytest.mark.parametrize('name', NEW)
def test_the_reader_reports_the_window_by_hand(run, name):
    assert run['calls'] >= 1
    # the warm-up call and the window's calls, each one request
    assert len(run['requests']) >= run['calls'] + 1
    want = _by_hand(run['requests'], run['calls'])
    assert run['metrics'][name] == pytest.approx(want[name], rel=1e-12)
    assert run['metrics']['dhtv_read_ms'] <= run['metrics']['dhtv_self_ms']
    assert 0 < run['metrics']['dhtv_iterations'] <= 34


def _ctx(calls):
    return types.SimpleNamespace(calls=calls)


@pytest.mark.parametrize('name', NEW)
def test_the_reader_reads_nothing_without_the_requests(monkeypatch, name):
    from pb_bss_tpu_torch.utils import profiling
    reader = runner.load_module('metrics', name)
    profiling.clear()
    with profiling.span('separate_batch'):
        pass
    assert reader.read(_ctx(2)) is None  # fewer than the window's calls
    assert reader.read(_ctx(0)) is None
    assert reader.read(_ctx(1)) is not None
    # a program without the registry (as before it had one)
    monkeypatch.delattr(profiling, 'requests')
    assert reader.read(_ctx(1)) is None
