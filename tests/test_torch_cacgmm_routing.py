"""Auto-routing contract of the port's CACGMMTrainer.fit: which route
each (shape, knobs) combination selects on the accelerator, ported from
the JAX package's pins (tests/test_models/test_cacgmm_routing.py).

The accelerator predicate and the five route entry points are
monkeypatched, so the real trainer code runs right up to the dispatch
on the CPU and nothing is computed. T=3200 is past the whole-fit
kernel's gate at D=6, K=3 (3178 frames) and the frequency-constant
kernels' (3190 frames); the JAX pins use T=2000, past their own, smaller
gates.
"""
import numpy as np
import pytest
import torch

import pb_bss_tpu_torch.models.cacgmm as mc
from pb_bss_tpu_torch.models.cacgmm import CACGMM, CACGMMTrainer
from pb_bss_tpu_torch.models.complex_angular_central_gaussian import (
    ComplexAngularCentralGaussian,
)
from pb_bss_tpu_torch.permutation_alignment import DHTVPermutationAlignment

F, D, K = 9, 6, 3
LONG = 3200


class _Route(Exception):
    def __init__(self, name):
        super().__init__(name)
        self.name = name


def _sentinel(name):
    def fn(*args, **kwargs):
        raise _Route(name)
    return fn


@pytest.fixture
def route_of(monkeypatch):
    monkeypatch.setattr(mc, '_on_accelerator', lambda y: True)
    for attr, name in (('_fit_fused', 'whole'),
                       ('_fit_fused_fc', 'fc'),
                       ('_fit_fused_stream', 'stream'),
                       ('_fit_em_t_blocked', 't_blocked'),
                       ('_fit_em', 'scan')):
        monkeypatch.setattr(mc, attr, _sentinel(name))

    def run(y, **kwargs):
        if 'initialization' not in kwargs:
            kwargs.setdefault('num_classes', K)
        kwargs.setdefault('iterations', 3)
        with pytest.raises(_Route) as e:
            CACGMMTrainer().fit(y, **kwargs)
        return e.value.name

    return run


def _y(T, dtype=np.complex64, batch=None):
    rng = np.random.default_rng(0)
    shape = (F, T, D) if batch is None else (batch, F, T, D)
    y = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.as_tensor(y.astype(dtype))


def _model(weight_shape):
    """A cACGMM with identity covariances and the given weight shape."""
    return CACGMM(
        weight=torch.full(weight_shape, 1. / K),
        cacg=ComplexAngularCentralGaussian(
            covariance_eigenvectors=torch.eye(
                D, dtype=torch.complex64).expand(F, K, D, D),
            covariance_eigenvalues=torch.ones(F, K, D)))


def test_short_per_bin_routes_whole_fit(route_of):
    assert route_of(_y(300)) == 'whole'


def test_short_fc_routes_step_kernel(route_of):
    assert route_of(_y(300), weight_constant_axis=(-3, -1)) == 'fc'


def test_long_per_bin_routes_stream(route_of):
    assert route_of(_y(LONG), t_block=None) == 'stream'


def test_long_fc_routes_stream(route_of):
    assert route_of(_y(LONG), weight_constant_axis=(-3, -1),
                    t_block=None) == 'stream'


def test_fc_inline_aligner_routes_step_kernel(route_of):
    aligner = DHTVPermutationAlignment.from_stft_size(512)
    assert route_of(_y(300), weight_constant_axis=(-3, -1),
                    inline_permutation_aligner=aligner) == 'fc'


def test_per_bin_inline_aligner_falls_back_to_scan(route_of):
    aligner = DHTVPermutationAlignment.from_stft_size(512)
    assert route_of(_y(300), inline_permutation_aligner=aligner,
                    t_block=None) == 'scan'


def test_batched_fc_aligner_falls_back_to_scan(route_of):
    # the frequency-constant route hosts the aligner only for unbatched
    # input
    aligner = DHTVPermutationAlignment.from_stft_size(512)
    assert route_of(_y(300, batch=2), weight_constant_axis=(-3, -1),
                    inline_permutation_aligner=aligner,
                    t_block=None) == 'scan'


def test_c128_falls_back_to_scan(route_of):
    assert route_of(_y(300, dtype=np.complex128), t_block=None) == 'scan'


def test_c128_long_signal_routes_t_blocked(route_of):
    # kernel-ineligible signals beyond T_BLOCK_AUTO_THRESHOLD keep the
    # t-blocked memory bound under the default t_block='auto'
    assert route_of(_y(mc.T_BLOCK_AUTO_THRESHOLD + 8,
                       dtype=np.complex128)) == 't_blocked'


def test_use_fused_em_false_routes_scan(route_of):
    assert route_of(_y(300), use_fused_em=False, t_block=None) == 'scan'


def test_batched_short_routes_whole_fit(route_of):
    assert route_of(_y(300, batch=2)) == 'whole'


def test_batched_long_routes_stream(route_of):
    assert route_of(_y(LONG, batch=2)) == 'stream'


def test_per_bin_inline_aligner_rejected_like_reference():
    """Inline alignment needs frequency-constant weight axes: with
    per-bin weights the model is invariant under per-bin class
    relabeling. Running the combination (not just routing it) raises
    with that explanation, as in the JAX package."""
    y = _y(40)[..., :3]
    aligner = DHTVPermutationAlignment.from_stft_size(512)
    with pytest.raises(AssertionError,
                       match='frequency-constant weight_constant'):
        CACGMMTrainer().fit(y, num_classes=2, iterations=2,
                            inline_permutation_aligner=aligner,
                            t_block=None)


@pytest.mark.parametrize('use_fused_em', ['auto', True])
def test_fc_aligner_past_the_step_gate_routes_scan(route_of, use_fused_em):
    """An fc fit with an inline aligner past the frequency-constant
    kernels' gate: the streamed kernel has no aligner hook, so 'auto'
    takes the scan path and use_fused_em=True finds no kernel variant
    (JAX cacgmm.py:316-334, 968-973)."""
    aligner = DHTVPermutationAlignment.from_stft_size(512)
    kwargs = dict(weight_constant_axis=(-3, -1), t_block=None,
                  inline_permutation_aligner=aligner,
                  use_fused_em=use_fused_em)
    if use_fused_em == 'auto':
        assert route_of(_y(LONG), **kwargs) == 'scan'
    else:
        with pytest.raises(AssertionError, match='no fused-kernel variant'):
            route_of(_y(LONG), **kwargs)


def test_saliency_and_mask_shrink_the_whole_fit_gate(route_of):
    """Saliency and a source-activity mask live in the whole-fit kernel's
    shared memory (T <= 2600 at D=6, K=3 with both): a T inside the
    reduced gate takes the whole fit, one frame past it the stream, as
    the JAX router does (choose_tile_f(has_sal, has_mask))."""
    from pb_bss_tpu_torch.ops import em_loop
    T_max = em_loop.max_frames(D, K, has_sal=True, has_mask=True)
    assert T_max == 2600 < em_loop.max_frames(D, K)

    def extras(T):
        return dict(saliency=torch.ones(F, T),
                    source_activity_mask=torch.ones((F, K, T), dtype=bool),
                    t_block=None)
    assert route_of(_y(T_max), **extras(T_max)) == 'whole'
    assert route_of(_y(T_max + 1), **extras(T_max + 1)) == 'stream'
    assert route_of(_y(T_max + 1), t_block=None) == 'whole'


def test_fc_step_gate_is_its_own(route_of):
    """T=3185 is past the whole-fit kernel's gate (3178) and inside the
    frequency-constant kernels' (3190)."""
    assert route_of(_y(3185), t_block=None) == 'stream'
    assert route_of(_y(3185), weight_constant_axis=(-3, -1),
                    t_block=None) == 'fc'


# ---- repairs against the JAX dispatch ----------------------------------

@pytest.mark.parametrize('T', [300, LONG], ids=['short', 'long'])
def test_fc_resume_from_per_bin_model_routes_scan(route_of, T):
    """A frequency-constant fit resumed from a model whose weight is per
    bin is eligible for neither frequency-constant kernel (JAX
    ``_fc_init_weight`` is None): the scan path, not a K5 error."""
    assert route_of(_y(T), initialization=_model((F, K, 1)),
                    weight_constant_axis=(-3, -1), t_block=None) == 'scan'


@pytest.mark.parametrize('T,route', [(300, 'fc'), (LONG, 'stream')],
                         ids=['short', 'long'])
def test_fc_resume_from_fc_model_routes_kernels(route_of, T, route):
    assert route_of(_y(T), initialization=_model((1, K, 1)),
                    weight_constant_axis=(-3, -1), t_block=None) == route


def test_int_t_block_routes_t_blocked(route_of):
    assert route_of(_y(300), use_fused_em=False, t_block=128) == 't_blocked'


def test_auto_t_block_on_cpu_past_threshold(monkeypatch, route_of):
    monkeypatch.setattr(mc, '_on_accelerator', lambda y: False)
    assert route_of(_y(mc.T_BLOCK_AUTO_THRESHOLD + 8)) == 't_blocked'
    assert route_of(_y(mc.T_BLOCK_AUTO_THRESHOLD)) == 'scan'


def test_t_block_with_saliency_is_rejected(route_of):
    with pytest.raises(AssertionError, match='standard knobs'):
        CACGMMTrainer().fit(_y(300), num_classes=K, iterations=1,
                            saliency=torch.ones(F, 300),
                            use_fused_em=False, t_block=64)


def test_initialization_shape_is_checked():
    init = torch.full((F, K, 299), 1. / K)
    with pytest.raises(AssertionError):
        CACGMMTrainer().fit(_y(300), initialization=init, iterations=1)


def test_source_activity_mask_shape_is_checked():
    mask = torch.ones((F, K + 1, 300), dtype=torch.bool)
    with pytest.raises(AssertionError):
        CACGMMTrainer().fit(_y(300), num_classes=K, iterations=1,
                            source_activity_mask=mask)


def test_cpu_auto_routes_scan(monkeypatch):
    """Without an accelerator 'auto' takes no kernel route."""
    monkeypatch.setattr(mc, '_fit_em', _sentinel('scan'))
    with pytest.raises(_Route) as e:
        CACGMMTrainer().fit(_y(300), num_classes=K, iterations=1)
    assert e.value.name == 'scan'
