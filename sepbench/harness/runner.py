"""One run of one cell: set-up, the measured window, the check, the
metrics.

Everything that belongs to a cell is found by name: the workload entry
in ``BENCHMARK.json`` names the configuration and the traffic; the cell
file ``sepbench/cells/<workload>.json`` names its driver
(``sepbench/drivers/<driver>.py``), the kernels to build, the layers to
span (``sepbench/layers/<span>.json``) and the limits of its check; each
metric is read by ``sepbench/metrics/<metric>.py``.
"""
from __future__ import annotations

import concurrent.futures
import importlib.util
import json
import math
import os
import pathlib
import random
import sys
import time

from . import device as device_info
from . import spans as spans_module
from . import trace as trace_module

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pb_bss_tpu')
PROGRAM = 'pb_bss_tpu_torch'


class Failure(Exception):
    """A run that cannot give a result (exit code, message)."""

    def __init__(self, code, message):
        super().__init__(message)
        self.code = code


def read_json(path):
    return json.loads(pathlib.Path(path).read_text())


def load_module(kind, name):
    path = BENCH / kind / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'sepbench_{kind}_{name}'.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A workload's entry, configuration, traffic, cell file, layers and
    metrics."""

    def __init__(self, name, benchmark=None, root=ROOT):
        benchmark = benchmark or read_json(root / 'BENCHMARK.json')
        workloads = {w['name']: w for w in benchmark['workloads']}
        if name not in workloads:
            raise Failure(2, f'no workload {name!r} in BENCHMARK.json')
        self.name = name
        self.workload = workloads[name]
        configs = {c['name']: c for c in benchmark['configs']}
        self.config = read_json(root / configs[self.workload['config']]
                                ['file'])
        self.traffic = read_json(
            BENCH / 'traffic' / f'{self.workload["traffic"]}.json')
        self.spec = read_json(BENCH / 'cells' / f'{name}.json')
        self.layers = {span: read_json(BENCH / 'layers' / f'{span}.json')
                       for span in self.spec['spans']}

        def mine(metric):
            return name in metric.get('workloads', [name])
        self.end_to_end = [m for m in benchmark['end_to_end'] if mine(m)]
        self.per_layer = [m for m in benchmark['per_layer'] if mine(m)]
        self.chips = self.workload['chips']


def set_cache_dirs(root=ROOT):
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = pathlib.Path(root) / '.sepbench_cache'
    for key, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TRITON_CACHE_DIR', 'triton'),
                     ('CUDA_CACHE_PATH', 'nv')):
        os.environ[key] = str(cache / sub)


def import_program(root=ROOT):
    """The system under test, imported from this checkout."""
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    try:
        program = importlib.import_module(PROGRAM)
    except ImportError as error:
        raise Failure(1, f'cannot import {PROGRAM}: {error}') from error
    where = pathlib.Path(program.__file__).resolve()
    if pathlib.Path(root).resolve() not in where.parents:
        raise Failure(1, f'{PROGRAM} comes from {where}, outside {root}')
    return program


def build(kernels):
    """Build (or load) the cell's kernel libraries, all at once."""
    from pb_bss_tpu_torch.ops import _build
    with concurrent.futures.ThreadPoolExecutor(max(1, len(kernels))) as pool:
        for _ in pool.map(_build.load, kernels):
            pass


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules
                   if m.split('.')[0] in FORBIDDEN})


def counter_values(readers):
    """{dotted: launches} of every counter a metric reader declares."""
    from .spans import resolve
    out = {}
    for reader in readers:
        for dotted in getattr(reader, 'COUNTERS', ()):
            owner, attr = resolve(dotted)
            out[dotted] = getattr(owner, attr).launches
    return out


class Context:
    """What a metric reader reads."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


def check(driver, samples, limits):
    """([(name, worst value, limit)] of the numbers with a limit, {name:
    worst value} of the others, which are logged and not compared) over
    the sampled calls [(index, captured)]: ``driver.check_call`` gives
    each call's numbers; a NaN anywhere keeps NaN."""
    worst = {name: 0.0 for name in limits}
    info = {}
    for index, captured in samples:
        for name, value in driver.check_call(index, captured).items():
            table = worst if name in worst else info
            seen = table.get(name, 0.0)
            table[name] = math.nan if math.isnan(value) or math.isnan(seen) \
                else max(seen, value)
    return [(name, worst[name], limits[name]) for name in limits], info


def percentile(values, q):
    ordered = sorted(values)
    if not ordered:
        return math.nan
    position = (len(ordered) - 1) * q / 100
    low = math.floor(position)
    high = min(low + 1, len(ordered) - 1)
    return ordered[low] + (ordered[high] - ordered[low]) * (position - low)


def sample_rows(seed, index, batch, count):
    """The recordings of call ``index`` whose outputs its check compares:
    ``count`` of the batch drawn from the seed, in order (all of them
    where ``count`` is None or not smaller than the batch)."""
    if count is None or count >= batch:
        return list(range(batch))
    rng = random.Random(f'sepbench-rows-{seed}-{index}')
    return sorted(rng.sample(range(batch), count))


def make_driver(cell, seed, torch, device):
    """The cell's driver; a checked call compares ``check_rows`` of its
    recordings, drawn from the seed (all of them where the cell file
    gives none)."""
    return load_module('drivers', cell.spec['driver']).Driver(
        torch, cell.config, cell.traffic, seed, device,
        check_rows=cell.spec.get('check_rows'))


def run(cell, seed, seconds, traced, *, torch, device, process_start,
        log=print):
    """One run; returns the result line's dict. ``log`` takes the lines
    for standard error."""
    import_program()
    driver = make_driver(cell, seed, torch, device)
    metric_specs = cell.per_layer if traced else cell.end_to_end
    readers = {m['name']: load_module('metrics', m['name'])
               for m in metric_specs}
    on_card = device.type == 'cuda'
    if on_card:
        build(cell.spec['kernels'])
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    wrappers = spans_module.Wrappers()
    driver.install(wrappers)
    if traced:
        spans_module.install_layers(wrappers, cell.layers)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    try:
        # warm-up: every shape of the window, the capture's too
        driver.call(-1, capture=True)
        sync()
        setup_s = time.time() - process_start
        before = device_info.smi() if on_card else {}
        window = Window(driver, seed, cell.spec['check_calls'], sync, torch)
        prof = None
        if traced:
            # the reservoir's first slots filled and the allocator grown
            # by untraced calls, so that the profile holds none of it
            for _ in range(cell.spec['check_calls'] + 2):
                window.step()

            def traced_run():
                for _ in range(cell.spec['trace_calls']):
                    window.step()
            prof, wall = trace_module.capture(torch, traced_run)
            log(f'traced calls {window.index - cell.spec["trace_calls"]}-'
                f'{window.index - 1}, '
                f'{"a capture" if prof is not None else "no capture"} of '
                f'{wall:.3f} s')
            # the spans' host times of the calls outside the profiler
            for times in wrappers.host_times.values():
                times.clear()
        counters_before = counter_values(readers.values())
        window.mark()
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            window.step()
        window_s = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        after = device_info.smi() if on_card else {}
        counters_after = counter_values(readers.values())
    finally:
        wrappers.close()
    reduced, traced_calls = None, 0
    if prof is not None:
        reduced = trace_module.Reduced(
            trace_module.events(prof), wall,
            {span: layer.get('kernels', ())
             for span, layer in cell.layers.items()})
        traced_calls = cell.spec['trace_calls']
        del prof
        log(f'trace: {reduced.busy_s:.4f} s busy in {reduced.window_s:.4f} '
            f's; {reduced.unmatched} device operations with no launch found')
    found = forbidden_modules()
    if found:
        raise Failure(3, f'modules of JAX or the JAX package loaded: {found}')
    failed = int(window.failed()) if window.bad is not None else 0
    log(f'{len(window.times) - window.timed_from} calls in '
        f'{window_s:.3f} s of window; '
        f'set-up {setup_s:.3f} s; sampled calls {window.sampled_indices()}')
    samples = window.samples()
    window.release()
    if on_card:
        torch.cuda.empty_cache()
    try:
        checks, info = check(driver, samples, cell.spec['limits'])
    except (RuntimeError, ValueError) as error:
        # a check that cannot be made (a non-finite output the
        # reference's solvers refuse) is a check failed
        log(f'the check raised: {error!r}')
        checks, info = [(name, math.nan, limit) for name, limit
                        in cell.spec['limits'].items()], {}
    for name, value in info.items():
        log(f'reading {name} {value!r} (not compared)')
    correct = all(value <= limit for _, value, limit in checks)
    timed = window.times[window.timed_from:]
    ctx = Context(
        config=cell.config, traffic=cell.traffic, cell=cell.spec,
        batch=driver.batch, setup_s=setup_s, window_s=window_s,
        calls=len(timed), call_times=timed,
        work_per_call=driver.work_per_call(),
        counters={k: counters_after[k] - counters_before[k]
                  for k in counters_after},
        trace=reduced, traced_calls=traced_calls,
        span_host_times={k: list(v) for k, v in
                         wrappers.host_times.items()})
    metrics = {}
    for spec in metric_specs:
        value = readers[spec['name']].read(ctx)
        if value is not None:
            metrics[spec['name']] = {'value': value, 'unit': spec['unit']}
    record = device_info.record(torch, cell.chips, peak, before, after) \
        if on_card else {'platform': 'cpu', 'kind': 'cpu', 'count': 0,
                         'memory_peak_bytes': 0}
    result = {'correct': bool(correct),
              'attempted': len(timed) * driver.batch, 'failed': failed,
              'metrics': metrics, 'device': record}
    if traced and reduced is not None:
        record['busy_s'] = reduced.busy_s
        record['window_s'] = reduced.window_s
        result['breakdown'] = {'device_ops': reduced.device_ops,
                               'idle_gaps': reduced.idle_gaps}
    result['checks'] = {name: {'value': _number(value), 'limit': limit}
                        for name, value, limit in checks}
    return result


def _number(value):
    """A float for the JSON line; a non-finite one as its name."""
    value = float(value)
    return value if math.isfinite(value) else repr(value)


class Window:
    """The calls of a run after its warm-up, back to back, each timed
    from the call to the end of ``torch.cuda.synchronize()``; those
    from :meth:`mark` on are the measured window. A reservoir drawn from
    the seed keeps the captures of ``keep`` of all the calls."""

    def __init__(self, driver, seed, keep, sync, torch):
        self.driver, self.sync, self.torch = driver, sync, torch
        self.rng = random.Random(f'sepbench-sample-{seed}')
        self.keep = keep
        self.slots = {}
        self.times = []
        self.index = 0
        self.timed_from = 0
        self.bad = None

    def mark(self):
        """The measured window starts with the next call; the failed
        outputs are counted from there."""
        self.timed_from = len(self.times)
        self.bad = None

    def step(self):
        i = self.index
        slot = i if i < self.keep else self.rng.randrange(i + 1)
        capture = slot < self.keep
        t0 = time.perf_counter()
        out, captured = self.driver.call(i, capture=capture)
        self.sync()
        self.times.append(time.perf_counter() - t0)
        # utterances with a non-finite output, counted on the device
        bad = (~self.torch.isfinite(out)).flatten(1).any(1).sum()
        self.bad = bad if self.bad is None else self.bad + bad
        if capture:
            self.slots[slot] = (i, captured)
        self.index += 1

    def failed(self):
        return self.bad.item()

    def sampled_indices(self):
        return sorted(i for i, _ in self.slots.values())

    def samples(self):
        return sorted(self.slots.values(), key=lambda s: s[0])

    def release(self):
        self.slots = {}


__all__ = ['Cell', 'Failure', 'run', 'make_driver', 'sample_rows', 'check', 'set_cache_dirs',
           'import_program', 'load_module', 'percentile', 'read_json']
