"""Routing contract of the port's integration trainers (VMFCACGMMTrainer,
GCACGMMTrainer): which route each (shape, knobs) combination selects on
the accelerator, ported from the JAX package's pins
(tests/test_ops/test_pallas_integration_em.py:
test_integration_routing_matrix). The accelerator predicate and the two
kernel entry points are monkeypatched, so the real trainer code runs on
the CPU right up to the kernel call; a fit that reaches neither kernel
took the scan."""
import numpy as np
import pytest
import torch

import pb_bss_tpu_torch.models.vmfcacgmm as mv
from pb_bss_tpu_torch.models.gcacgmm import GCACGMMTrainer
from pb_bss_tpu_torch.models.vmfcacgmm import (
    VMFCACGMMTrainer,
    _fused_integration_eligible,
    _resolve_fused_mode,
    _whole_fit_integration_eligible,
)
from pb_bss_tpu_torch.ops import integration_em, integration_em_loop

F, T, D, E, K = 9, 60, 4, 5, 2


class _Route(Exception):
    def __init__(self, name):
        super().__init__(name)
        self.name = name


def _sentinel(name):
    def fn(*args, **kwargs):
        raise _Route(name)
    return fn


def _y(dtype=np.complex64, channels=D, batch=()):
    rng = np.random.default_rng(0)
    shape = (*batch, F, T, channels)
    return torch.as_tensor((rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape)).astype(dtype))


def _emb(batch=()):
    rng = np.random.default_rng(1)
    return torch.as_tensor(rng.standard_normal((*batch, F, T, E)).astype(
        np.float32))


@pytest.fixture
def route_of(monkeypatch):
    monkeypatch.setattr(mv, '_on_accelerator', lambda x: True)
    monkeypatch.setattr(integration_em, 'e_stats', _sentinel('step'))
    monkeypatch.setattr(integration_em_loop, 'integration_em_full',
                        _sentinel('loop'))

    def run(trainer=VMFCACGMMTrainer, y=None, emb=None, **kwargs):
        y = _y() if y is None else y
        emb = _emb() if emb is None else emb
        kwargs.setdefault('num_classes', K)
        kwargs.setdefault('iterations', 2)
        try:
            trainer().fit(y, emb, **kwargs)
        except _Route as e:
            return e.name
        return 'scan'

    return run


@pytest.mark.parametrize('trainer', [VMFCACGMMTrainer, GCACGMMTrainer])
def test_auto_takes_the_step_kernel_when_eligible(route_of, trainer):
    assert route_of(trainer) == 'step'
    # saliency rides the per-iteration kernel
    assert route_of(trainer, saliency=torch.ones(F, T)) == 'step'
    assert route_of(trainer, y=_y(batch=(2,)), emb=_emb(batch=(2,))) \
        == 'step'


@pytest.mark.parametrize('trainer', [VMFCACGMMTrainer, GCACGMMTrainer])
def test_auto_keeps_the_scan_outside_the_gate(route_of, trainer):
    assert route_of(trainer, weight_constant_axis=(-3, -1)) == 'scan'
    assert route_of(trainer, inline_permutation_alignment=True) == 'scan'
    assert route_of(trainer, y=_y(np.complex128)) == 'scan'
    assert route_of(trainer, y=_y(channels=17)) == 'scan'
    assert route_of(trainer, use_fused_em=False) == 'scan'


def test_gcacgmm_full_covariance_stays_on_the_scan(route_of):
    assert route_of(GCACGMMTrainer, covariance_type='full') == 'scan'
    assert route_of(GCACGMMTrainer, covariance_type='diagonal') == 'step'
    assert route_of(GCACGMMTrainer, covariance_type='spherical') == 'step'


@pytest.mark.parametrize('trainer', [VMFCACGMMTrainer, GCACGMMTrainer])
def test_loop_is_an_explicit_opt_in(route_of, trainer):
    assert route_of(trainer, use_fused_em='loop') == 'loop'
    assert route_of(trainer, use_fused_em=True) == 'step'
    assert route_of(trainer, use_fused_em='step') == 'step'
    with pytest.raises(AssertionError, match='saliency'):
        route_of(trainer, use_fused_em='loop', saliency=torch.ones(F, T))


def test_forced_kernels_assert_on_knobs_they_do_not_take(route_of):
    with pytest.raises(AssertionError, match='weight_constant_axis'):
        route_of(use_fused_em=True, weight_constant_axis=(-3, -1))
    with pytest.raises(AssertionError, match='inline_permutation'):
        route_of(use_fused_em='loop', inline_permutation_alignment=True)
    with pytest.raises(AssertionError, match='covariance'):
        route_of(GCACGMMTrainer, use_fused_em=True, covariance_type='full')
    with pytest.raises(AssertionError, match='fixed_covariance'):
        route_of(GCACGMMTrainer, use_fused_em='loop',
                 fixed_covariance=torch.ones(K))


def test_resolve_fused_mode_table():
    assert _resolve_fused_mode('auto', True, True) == 'step'
    assert _resolve_fused_mode('auto', False, True) == 'off'
    assert _resolve_fused_mode('loop', False, True) == 'loop'
    assert _resolve_fused_mode(True, False, False) == 'step'
    assert _resolve_fused_mode('step', False, False) == 'step'
    assert _resolve_fused_mode(False, True, True) == 'off'
    with pytest.raises(AssertionError):
        _resolve_fused_mode('sometimes', True, True)


def test_eligibility_predicates(monkeypatch):
    """The two gates, with the accelerator reported (the JAX pins' knob
    set, plus the whole-fit gate's own knobs)."""
    monkeypatch.setattr(mv, '_on_accelerator', lambda x: True)
    y, emb = _y(), _emb()

    def step(y=y, emb=emb, sal=None, wca=(-1,), inline_pa=False):
        return _fused_integration_eligible(y, emb, K, sal, wca, inline_pa)

    def loop(y=y, emb=emb, sal=None, iterations=20, norm='eigenvalue',
             hermitize=True, mode='vmf'):
        return _whole_fit_integration_eligible(
            y, emb, K, sal, (-1,), False, iterations, norm, hermitize, mode)

    assert step() and step(sal=torch.ones(F, T)) and step(wca=-1)
    assert not step(wca=(-3, -1))
    assert not step(inline_pa=True)
    assert not step(y=y.to(torch.complex128))
    assert not step(y=y[..., :1, :, :][0])  # (T, D): no bin axis
    assert not step(emb=torch.zeros(F, T, 5000))  # past the smem budget
    assert loop() and loop(mode='gaussian')
    assert not loop(sal=torch.ones(F, T))
    assert not loop(iterations=1)
    assert not loop(norm='trace')
    assert not loop(hermitize=False)
    big = torch.zeros((129, 1, 2, D), dtype=torch.complex64)
    assert not loop(y=big, emb=torch.zeros((129, 1, 2, E)))
    assert loop(y=big[:128], emb=torch.zeros((128, 1, 2, E)))


def test_cpu_auto_takes_the_scan(monkeypatch):
    """Without an accelerator 'auto' takes no kernel route."""
    monkeypatch.setattr(integration_em, 'e_stats', _sentinel('step'))
    VMFCACGMMTrainer().fit(_y(), _emb(), num_classes=K, iterations=2)
    GCACGMMTrainer().fit(_y(), _emb(), num_classes=K, iterations=2)
