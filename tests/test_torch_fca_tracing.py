"""The FCA refinement's spans and counters and the benchmark's readers
of them: ``separate_batch(refine='fca')`` records an ``fca`` span in
the beamformer's place with ``fca.fit`` and ``fca.separate`` inside it
and the counters ``fca.iterations``, ``fca.ip_rows`` and
``fca.ip_sweeps`` (D rows a sweep: the sweep's covariances batched);
``sepbench/metrics/fca_host_ms.py`` reads the span as a hand count does,
and nothing where the program keeps no requests; the device-trace
readers (``fca_device_ms``, ``fca_kernels``, ``fca_roofline``) read the
``fca`` span of a reduced trace; ``sepbench/harness/fca_counts.py`` is
pinned against a hand count."""
import pathlib
import sys
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pb_bss_tpu_torch import separate_batch  # noqa: E402
from pb_bss_tpu_torch.models.fca import FCATrainer  # noqa: E402
from pb_bss_tpu_torch.utils import profiling  # noqa: E402
from sepbench.harness import counts, fca_counts, runner  # noqa: E402

torch.set_num_threads(2)

ITERATIONS = 4


def _observations(batch=2, samples=8000, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 6, samples, generator=g)


def _refine(observations):
    return separate_batch(observations, iterations=3, refine='fca',
                          refine_iterations=ITERATIONS,
                          generator=torch.Generator().manual_seed(1))


@pytest.fixture(scope='module')
def calls():
    """The requests of two small refined calls."""
    profiling.clear()
    _refine(_observations())
    _refine(_observations(seed=1))
    return profiling.requests()


def _children(request, parent):
    return [s.name for s in request.spans if s.parent == parent]


def test_the_refinement_is_a_span_in_the_beamformers_place(calls):
    for request in calls:
        assert request.root == 'separate_batch'
        assert _children(request, 0) == ['init', 'stft', 'em', 'dhtv',
                                          'fca', 'istft']
        names = [s.name for s in request.spans]
        fca = names.index('fca')
        assert _children(request, fca) == ['fca.fit', 'fca.separate']
        span = request.spans[fca]
        for child in request.spans:
            if child.parent == fca:
                assert span.start_ns <= child.start_ns <= child.end_ns \
                    <= span.end_ns
        assert 'beamformer' not in names


def test_the_counters(calls):
    for request in calls:
        assert request.counters['fca.iterations'] == ITERATIONS
        assert request.counters['fca.ip_rows'] == 6 * 1 * ITERATIONS
        assert request.counters['fca.ip_sweeps'] == 1 * ITERATIONS


def test_a_fit_alone_is_a_request_of_its_own():
    y = torch.complex(torch.randn(5, 40, 3), torch.randn(5, 40, 3))
    masks = torch.full((5, 2, 40), 0.5)
    FCATrainer(q_iterations=2).fit(y, initialization=masks, iterations=3)
    [request] = profiling.requests(last=1)
    assert request.root == 'fca.fit'
    assert request.counters == {'fca.iterations': 3, 'fca.ip_rows': 18,
                                'fca.ip_sweeps': 6}


def _ctx(calls=0, trace=None, traced_calls=0, batch=256):
    return types.SimpleNamespace(
        calls=calls, trace=trace, traced_calls=traced_calls, batch=batch,
        config=runner.Cell('utt.b256.fca').config)


def test_fca_host_ms_reads_the_window_by_hand():
    reader = runner.load_module('metrics', 'fca_host_ms')
    profiling.clear()
    _refine(_observations())
    _refine(_observations(seed=1))
    calls = profiling.requests()
    want = sum(s.end_ns - s.start_ns for r in calls for s in r.spans
               if s.name == 'fca') / 1e6 / 2
    assert reader.read(_ctx(calls=2)) == pytest.approx(want, rel=1e-12)
    assert want > 0
    # the last call alone
    last = [s for s in calls[-1].spans if s.name == 'fca'][0]
    assert reader.read(_ctx(calls=1)) == pytest.approx(
        (last.end_ns - last.start_ns) / 1e6, rel=1e-12)


def test_fca_host_ms_reads_nothing_without_the_requests(monkeypatch):
    reader = runner.load_module('metrics', 'fca_host_ms')
    profiling.clear()
    with profiling.span('separate_batch'):
        pass
    assert reader.read(_ctx(calls=2)) is None  # fewer than the window's
    assert reader.read(_ctx(calls=0)) is None
    # a call with no refinement (the parent of the FCA spans)
    assert reader.read(_ctx(calls=1)) is None
    monkeypatch.delattr(profiling, 'requests')
    assert reader.read(_ctx(calls=1)) is None


def test_the_device_trace_readers():
    span = {'device_s': 6.0, 'host_s': 6.5, 'count': 12, 'syncs': 0,
            'operations': 60_000}
    trace = types.SimpleNamespace(spans={'fca': span})
    ctx = _ctx(trace=trace, traced_calls=6)
    read = {name: runner.load_module('metrics', name).read
            for name in ('fca_device_ms', 'fca_kernels', 'fca_roofline')}
    assert read['fca_device_ms'](ctx) == pytest.approx(1000.0)
    assert read['fca_kernels'](ctx) == pytest.approx(10_000)
    least = fca_counts.fca_bound_ms(ctx.config, 256)
    assert read['fca_roofline'](ctx) == pytest.approx(100 * least / 1000)
    for empty in (_ctx(), _ctx(trace=types.SimpleNamespace(spans={}),
                               traced_calls=6)):
        assert all(r(empty) is None for r in read.values())


def test_the_work_count_by_hand():
    # F=5 bins (size 8), T=6 frames, D=2, K=2, one iteration, one
    # utterance, a (bin, frame): the covariances' 3 outer-product
    # entries at 6 and 2 rows x 3 weighted sums at 4 = 42; Q y 8 D^2 =
    # 32; the MUs 16 K D = 64; the back-transform 8 D^2 + 8 K D = 64:
    # 202 x 30 = 6060. Bytes: y (480) read 2 + 1 times, 2 spectra
    # (480) written; at this shape the bytes bound it.
    config = {'channels': 2, 'num_classes': 2, 'refine_iterations': 1,
              'stft_size': 8, 'stft_shift': 2, 'samples': 6}
    assert counts.frames(config) == 6
    assert fca_counts.fca_work(config, 1) == (6060, 1920)
    assert fca_counts.fca_bound_ms(config, 1) == pytest.approx(
        1e3 * 1920 / 3.35e12)


def test_the_cells_work():
    """B=256 (65,792 bins, T=304): 0.491 TFLOP over 20 iterations and
    the back-transform (7.3 ms), bound by the bytes at 11.9 ms (39.8
    GB)."""
    config = runner.Cell('utt.b256.fca').config
    flops, moved = fca_counts.fca_work(config, 256)
    assert flops == 491_058_855_936
    assert moved == 39_841_529_856
    assert counts.bound(moved, flops)[1] == 'bytes'
    assert fca_counts.fca_bound_ms(config, 256) == pytest.approx(
        11.893, rel=1e-4)
