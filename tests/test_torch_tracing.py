"""The program's spans and counters (pb_bss_tpu_torch.utils.profiling):
one request per call of separate_batch, its spans nested by layer, the
EM route and DHTV's iterations counted, the kernels' launches carried
over from their ``.launches`` attributes (counted by the one launch
seam, ``ops._build.launch``, in wrappers that ``ops._build.counted``
registers), the ring bounded, the spans on the profiler's host clock,
and profiler ranges only inside ``profiling.trace()``."""
import ast
import importlib
import importlib.util
import json
import os
import threading

import pytest
import torch

import pb_bss_tpu_torch.models.cacgmm as mc
from pb_bss_tpu_torch import separate_batch
from pb_bss_tpu_torch.evaluation.batch_wrapper import bss_eval_stoi_fused_batch
from pb_bss_tpu_torch.models.cbmm import CBMMTrainer
from pb_bss_tpu_torch.models.cwmm import CWMMTrainer
from pb_bss_tpu_torch.ops import _build, em_loop, gev
from pb_bss_tpu_torch.permutation_alignment import DHTVPermutationAlignment
from pb_bss_tpu_torch.utils import profiling

torch.set_num_threads(2)

LAYERS = ['init', 'stft', 'em', 'dhtv', 'beamformer', 'istft']
PLAN = DHTVPermutationAlignment.from_stft_size(512).alignment_plan
MAX_ITERATIONS = sum(iterations for iterations, _, _ in PLAN)  # 34


def _observations(batch=2, samples=8000, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 6, samples, generator=g)


def _separate(observations):
    return separate_batch(observations, iterations=3, beamformer='gev+ban',
                          generator=torch.Generator().manual_seed(1))


@pytest.fixture(scope='module')
def call():
    """(request, output) of one small separate_batch."""
    profiling.clear()
    out = _separate(_observations())
    [request] = profiling.requests()
    return request, out


def _children(request, parent):
    return [s.name for s in request.spans if s.parent == parent]


def test_one_call_is_one_request_with_its_layers_nested(call):
    request, _ = call
    assert request.root == 'separate_batch'
    root = request.spans[0]
    assert root.name == 'separate_batch' and root.parent is None
    assert _children(request, 0) == LAYERS
    dhtv = [s.name for s in request.spans].index('dhtv')
    reads = _children(request, dhtv)
    assert reads and set(reads) == {'dhtv.read'}
    assert len(request.spans) == 1 + len(LAYERS) + len(reads)
    for span in request.spans[1:]:
        parent = request.spans[span.parent]
        assert parent.start_ns <= span.start_ns <= span.end_ns \
            <= parent.end_ns, (span, parent)


def test_dhtv_counts_the_iterations_that_ran(call):
    request, _ = call
    reads = sum(s.name == 'dhtv.read' for s in request.spans)
    iterations = request.counters['dhtv.iterations']
    # a read either runs an iteration or ends its block early
    assert reads - len(PLAN) <= iterations <= min(reads, MAX_ITERATIONS)


def test_the_cpu_fit_takes_the_scan_route(call):
    request, _ = call
    routes = {k: v for k, v in request.counters.items()
              if k.startswith('em.route.')}
    assert routes == {'em.route.scan': 1}


def _launches():
    return {name: function.launches
            for name, function in profiling._launch_counters.items()}


def test_the_request_counts_the_change_in_launches(monkeypatch):
    before = _launches()
    profiling.clear()
    _separate(_observations(batch=1))
    after = _launches()
    [request] = profiling.requests()
    launched = {k: v for k, v in request.counters.items()
                if k.startswith('launches.')}
    assert launched == {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
    # the plain twins on the CPU count none: a launch made by hand
    monkeypatch.setattr(em_loop.cacgmm_em_full, 'launches',
                        em_loop.cacgmm_em_full.launches)
    monkeypatch.setattr(gev.gev, 'launches', gev.gev.launches)
    with profiling.span('outer'):
        em_loop.cacgmm_em_full.launches += 2
        with profiling.span('inner'):
            gev.gev.launches += 1
    assert profiling.requests()[-1].counters == {
        'launches.em_loop.cacgmm_em_full': 2, 'launches.gev.gev': 1}


def test_every_launch_counter_of_the_kernels_is_carried():
    """The registry holds every kernel wrapper with ``.launches`` and
    every wrapper that ``launch`` counts in (one that forgot ``@counted``
    is missing from it), under ``launches.<module>.<function>``."""
    import pb_bss_tpu_torch.ops as ops
    found, launched = {}, {}
    for entry in os.scandir(os.path.dirname(ops.__file__)):
        name, ext = os.path.splitext(entry.name)
        if ext != '.py' or name == '__init__':
            continue
        module = importlib.import_module(f'pb_bss_tpu_torch.ops.{name}')
        for attr, value in vars(module).items():
            if callable(value) and hasattr(value, 'launches') \
                    and value.__module__ == module.__name__:
                found[f'launches.{name}.{attr}'] = value
        with open(entry.path) as f:
            for node in ast.walk(ast.parse(f.read())):
                if isinstance(node, ast.Call) \
                        and getattr(node.func, 'id', None) == 'launch':
                    wrapper = node.args[0].id
                    launched[f'launches.{name}.{wrapper}'] = getattr(
                        module, wrapper)
    assert launched and found == launched == profiling._launch_counters


class _Library:
    """A kernel library whose entry ``kernel_launch`` returns ``code``."""

    def __init__(self, code):
        self.code = code
        self.calls = []

    def kernel_launch(self, *args):
        self.calls.append(args)
        return self.code


@pytest.fixture
def fake_kernel(monkeypatch):
    """(a ``@counted`` wrapper of this module, its library), with the
    registry restored afterwards and ``load`` giving the fake library."""
    monkeypatch.setattr(profiling, '_launch_counters',
                        dict(profiling._launch_counters))
    library = _Library(0)
    monkeypatch.setattr(_build, 'load', lambda name: library)

    def fake_wrapper():
        _build.launch(fake_wrapper, 'fake', 'kernel_launch', 7, 8)

    return fake_wrapper, library


def test_the_launch_seam_raises_on_an_error_and_counts_a_launch(
        fake_kernel):
    wrapper, library = fake_kernel
    _build.counted(wrapper)
    assert wrapper.launches == 0
    library.code = 700
    with pytest.raises(RuntimeError, match='^fake_wrapper kernel launch '
                       'failed: CUDA error 700$'):
        wrapper()
    assert wrapper.launches == 0 and library.calls == [(7, 8)]
    library.code = 0
    wrapper()
    wrapper()
    assert wrapper.launches == 2 and library.calls == [(7, 8)] * 3


def test_a_wrapper_registered_in_an_open_request_counts_from_zero(
        fake_kernel, monkeypatch):
    wrapper, _ = fake_kernel
    name = f'launches.{__name__.rpartition(".")[2]}.fake_wrapper'
    monkeypatch.setattr(gev.gev, 'launches', gev.gev.launches)
    profiling.clear()
    with profiling.span('outer'):
        gev.gev.launches += 1
        _build.counted(wrapper)
        with profiling.span('inner'):
            wrapper()
            wrapper()
    [request] = profiling.requests()
    assert request.counters == {name: 2, 'launches.gev.gev': 1}
    assert profiling._launch_counters[name] is wrapper


def test_profiling_imports_no_ops_module():
    """The registry is filled by the wrappers: the profiling layer names
    no module above it."""
    path = profiling.__file__
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            module = importlib.util.resolve_name(
                '.' * node.level + (node.module or ''),
                'pb_bss_tpu_torch.utils')
            imported.add(module)
            imported.update(f'{module}.{alias.name}' for alias in node.names)
    assert imported and not {m for m in imported
                             if m.startswith('pb_bss_tpu_torch.ops')}


@pytest.mark.parametrize('route,kwargs', [
    ('whole', dict(use_fused_em=True)),
    ('fc', dict(use_fused_em=True, weight_constant_axis=(-3, -1))),
    ('stream', dict(use_fused_em=True, frames=3200)),
    ('t_blocked', dict(use_fused_em=False, t_block=100)),
    ('scan', dict(use_fused_em=False)),
])
def test_the_em_route_is_counted(monkeypatch, route, kwargs):
    for attr in ('_fit_fused', '_fit_fused_fc', '_fit_fused_stream',
                 '_fit_em_t_blocked', '_fit_em'):
        monkeypatch.setattr(mc, attr, lambda *args, **kw: None)
    frames = kwargs.pop('frames', 300)
    g = torch.Generator().manual_seed(0)
    y = torch.randn(2, frames, 6, dtype=torch.complex64, generator=g)
    mc.CACGMMTrainer().fit(y, num_classes=3, iterations=2, **kwargs)
    request = profiling.requests()[-1]
    assert request.root == 'em'
    # the whole fit also counts the frame group of its scatter (2 at D=6)
    expected = {f'em.route.{route}': 1}
    if route == 'whole':
        expected['em.whole.scatter_frames.2'] = 1
    assert request.counters == expected


@pytest.mark.parametrize('trainer,route', [
    (CWMMTrainer, 'cwmm'), (CBMMTrainer, 'cbmm')])
def test_the_other_models_count_their_route(trainer, route):
    g = torch.Generator().manual_seed(0)
    y = torch.randn(1, 40, 6, dtype=torch.complex64, generator=g)
    trainer().fit(y, num_classes=3, iterations=1)
    request = profiling.requests()[-1]
    assert request.root == 'em' and [s.name for s in request.spans] == ['em']
    assert request.counters == {f'em.route.{route}': 1}


def test_scoring_is_a_request_with_its_read():
    g = torch.Generator().manual_seed(0)
    reference = torch.randn(1, 2, 16000, generator=g, dtype=torch.float64)
    estimate = reference + 0.1 * torch.randn(1, 2, 16000, generator=g,
                                             dtype=torch.float64)
    bss_eval_stoi_fused_batch(reference, estimate, 8000, device='cpu')
    request = profiling.requests()[-1]
    assert [(s.name, s.parent) for s in request.spans] == [
        ('score', None), ('score.read', 0)]


def test_the_ring_keeps_the_last_requests():
    profiling.clear()
    for _ in range(profiling.RING + 100):
        with profiling.span('tiny'):
            profiling.count('n', 2)
    done = profiling.requests()
    assert len(done) == profiling.RING == 1024
    assert [r.id for r in done] == list(range(done[0].id,
                                              done[0].id + 1024))
    assert all(r.counters == {'n': 2} for r in done)
    assert profiling.requests(last=3) == done[-3:]
    profiling.clear()
    assert profiling.requests() == []


def test_counts_outside_a_span_and_raising_bodies():
    profiling.clear()
    profiling.count('stray')
    with pytest.raises(RuntimeError):
        with profiling.span('failing'):
            profiling.count('seen')
            raise RuntimeError
    [request] = profiling.requests()
    assert request.root == 'failing' and request.counters == {'seen': 1}
    with pytest.raises(ValueError):
        profiling.span('sepbench.step')


def test_each_thread_has_its_own_requests():
    profiling.clear()
    barrier = threading.Barrier(2)

    def work(name):
        with profiling.span(name):
            barrier.wait()
            with profiling.span(f'{name}.child'):
                barrier.wait()

    threads = [threading.Thread(target=work, args=(n,)) for n in 'ab']
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    done = {r.root: [s.name for s in r.spans] for r in profiling.requests()}
    assert done == {'a': ['a', 'a.child'], 'b': ['b', 'b.child']}


def _host_events(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_spans_share_the_profilers_host_clock():
    """Under a bare capture, each span brackets the operations that only
    it runs: the forward FFTs (stft), the inverse ones (istft), the
    draws (init), and every operation of the call (separate_batch)."""
    observations = _observations(batch=1)
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _separate(observations)
    [request] = profiling.requests()
    events = _host_events(prof)
    assert not [e for e in events if e[0].startswith('pb_bss_tpu_torch.')]
    spans = {s.name: s for s in request.spans}
    owned = {'stft': 'aten::fft_rfft', 'istft': 'aten::fft_irfft',
             'init': 'aten::uniform_', 'separate_batch': 'aten::'}
    for name, op in owned.items():
        inside = [e for e in events if e[0].startswith(op)]
        assert inside, op
        span = spans[name]
        for _, start, end in inside:
            assert span.start_ns <= start <= end <= span.end_ns, (name, op)


def test_trace_shows_the_spans_nested(tmp_path):
    observations = _observations(batch=1)
    profiling.clear()
    with profiling.trace(str(tmp_path)):
        _separate(observations)
    [request] = profiling.requests()
    [path] = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
        trace = json.load(f)
    events = sorted((e for e in trace['traceEvents']
                     if e.get('name', '').startswith('pb_bss_tpu_torch.')
                     and e.get('ph') == 'X'), key=lambda e: e['ts'])
    assert [e['name'] for e in events] == [
        f'pb_bss_tpu_torch.{s.name}' for s in request.spans]
    root = events[0]
    for event in events:
        assert root['ts'] <= event['ts'] \
            and event['ts'] + event['dur'] <= root['ts'] + root['dur']
    # each range lies inside its span on the shared clock (the trace's
    # times are us after baseTimeNanoseconds)
    base = trace['baseTimeNanoseconds'] / 1e3
    for span, event in zip(request.spans, events):
        assert span.start_ns / 1e3 - 2 <= base + event['ts'] \
            and base + event['ts'] + event['dur'] <= span.end_ns / 1e3 + 2
    # outside trace() no range is opened
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span('quiet'):
            torch.ones(3) + 1
    assert not [e for e in _host_events(prof)
                if e[0].startswith('pb_bss_tpu_torch.')]


def test_trace_leaves_the_output_unchanged(tmp_path):
    observations = _observations()
    # the first call of a process can round differently on the CPU
    # (seen with and without spans), so the two compared calls follow
    # a first one
    _separate(observations)
    out = _separate(observations)
    with profiling.trace(str(tmp_path)):
        traced = _separate(observations)
    assert torch.equal(out, traced)
