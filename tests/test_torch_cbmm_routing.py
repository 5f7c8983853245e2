"""Auto-routing contract of the port's CBMMTrainer.fit: which route each
(shape, knobs) combination selects on the accelerator, ported from the
JAX package's pins (tests/test_models/test_mm_routing.py, CBMM cases).

The accelerator predicate and the three route entry points are
monkeypatched, so the real trainer code runs right up to the dispatch on
the CPU and nothing is computed. T=3751 is one frame past the whole-fit
Bingham kernel's gate at D=6, K=3 (the JAX pins use T=2000, past their
own, smaller gate)."""
import numpy as np
import pytest
import torch

import pb_bss_tpu_torch.models.cbmm as mcb
from pb_bss_tpu_torch.models.cbmm import CBMMTrainer
from pb_bss_tpu_torch.ops import cbmm_loop, mm_stream
from pb_bss_tpu_torch.permutation_alignment import DHTVPermutationAlignment

F, D, K = 9, 6, 3
LONG = 3751


class _Route(Exception):
    def __init__(self, name):
        super().__init__(name)
        self.name = name


def _sentinel(name):
    def fn(*args, **kwargs):
        raise _Route(name)
    return fn


def _y(T, dtype=np.complex64, channels=D):
    rng = np.random.default_rng(0)
    y = rng.standard_normal((F, T, channels)) \
        + 1j * rng.standard_normal((F, T, channels))
    return torch.as_tensor(y.astype(dtype))


def _aff(T):
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(F, K, T)).astype(np.float32)
    return torch.as_tensor(a / a.sum(-2, keepdims=True))


@pytest.fixture
def route_of(monkeypatch):
    monkeypatch.setattr(mcb, '_on_accelerator', lambda y: True)
    monkeypatch.setattr(cbmm_loop, 'cbmm_em_full', _sentinel('whole'))
    monkeypatch.setattr(mm_stream, 'cbmm_em_long', _sentinel('stream'))
    monkeypatch.setattr(mcb, 'run_em', _sentinel('scan'))

    def run(y, **kwargs):
        kwargs.setdefault('initialization', _aff(y.shape[-2]))
        kwargs.setdefault('iterations', 3)
        with pytest.raises(_Route) as e:
            CBMMTrainer().fit(y, **kwargs)
        return e.value.name

    return run


def test_short_per_bin_routes_whole_fit(route_of):
    assert route_of(_y(300)) == 'whole'


def test_short_fc_routes_stream(route_of):
    # frequency-constant weights have no whole-fit variant: the streamed
    # kernel carries the fc weight mode
    assert route_of(_y(300), weight_constant_axis=(-3, -1)) == 'stream'


def test_long_routes_stream(route_of):
    assert route_of(_y(LONG)) == 'stream'
    assert route_of(_y(LONG - 1)) == 'whole'


def test_aligner_falls_back_to_scan(route_of):
    aligner = DHTVPermutationAlignment.from_stft_size(512)
    assert route_of(_y(300), inline_permutation_aligner=aligner,
                    weight_constant_axis=(-3, -1)) == 'scan'


def test_c128_falls_back_to_scan(route_of):
    assert route_of(_y(300, dtype=np.complex128)) == 'scan'


def test_d_gt_8_falls_back_to_scan(route_of):
    # the Bingham kernels take 2 <= D <= 8
    assert route_of(_y(300, channels=9)) == 'scan'
    assert route_of(_y(300, channels=8)) == 'whole'


def test_use_fused_em_false_routes_scan(route_of):
    assert route_of(_y(300), use_fused_em=False) == 'scan'


def test_saliency_shrinks_the_whole_fit_gate(route_of):
    """Saliency lives in the whole-fit kernel's shared memory (T <= 3515
    at D=6, K=3): past that, per-bin fits take the stream."""
    assert route_of(_y(3516), saliency=torch.ones(F, 3516)) == 'stream'
    assert route_of(_y(3515), saliency=torch.ones(F, 3515)) == 'whole'


def test_cpu_auto_routes_scan(monkeypatch):
    """Without an accelerator 'auto' takes no kernel route."""
    monkeypatch.setattr(mcb, 'run_em', _sentinel('scan'))
    with pytest.raises(_Route) as e:
        CBMMTrainer().fit(_y(300), num_classes=K, iterations=1)
    assert e.value.name == 'scan'


def test_use_fused_em_true_with_an_aligner_asserts():
    aligner = DHTVPermutationAlignment.from_stft_size(512)
    with pytest.raises(AssertionError, match='inline_permutation_aligner'):
        CBMMTrainer().fit(_y(40), num_classes=K, iterations=1,
                          weight_constant_axis=(-3, -1),
                          inline_permutation_aligner=aligner,
                          use_fused_em=True)
