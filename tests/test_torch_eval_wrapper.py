"""The port's metric facades (InputMetrics / OutputMetrics and their
batch forms) against pb_bss_tpu.evaluation's on the same numpy signals
(x64 JAX on the CPU), and against the reference's external-library
goldens on its pure-NumPy scenario."""
import numpy as np
import pytest
import scipy.signal
import torch
from numpy.testing import assert_allclose, assert_array_equal

import pb_bss_tpu.evaluation as jev
from pb_bss_tpu.testing import dummy_data as jax_dummy
from pb_bss_tpu_torch import evaluation as ev
from pb_bss_tpu_torch.evaluation import (
    InputMetrics,
    InputMetricsBatch,
    OutputMetrics,
    OutputMetricsBatch,
)
from pb_bss_tpu_torch.evaluation.wrapper import VerboseKeyError
from pb_bss_tpu_torch.testing import dummy_data

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def scenario():
    """Bit-for-bit the reference's scenario (its
    tests/test_evaluation/test_wrapper_values.py:7-41, reproduced in
    tests/test_evaluation/test_reference_goldens.py): seed 1, 2 speakers
    x 3 channels, fftconvolve RIRs."""
    samples, rir_length, channels = 10_000, 4, 3
    rng = np.random.RandomState(1)
    s1, s2 = rng.rand(samples), rng.rand(samples)
    h1 = rng.rand(channels, rir_length)
    h2 = rng.rand(channels, rir_length)
    i1 = np.array([scipy.signal.fftconvolve(s1, h, mode='same')
                   for h in h1])
    i2 = np.array([scipy.signal.fftconvolve(s2, h, mode='same')
                   for h in h2])
    noise = 0.01 * rng.rand(channels, samples)
    return {'speech_source': np.array([s1, s2]),
            'speech_image': np.array([i1, i2]),
            'noise_image': noise, 'observation': i1 + i2 + noise}


def _output_inputs(scenario):
    prediction = (scenario['speech_image'][..., 0, :]
                  + scenario['noise_image'][..., 0, :])
    i1, i2 = scenario['speech_image'][..., 0, :]
    contribution = np.array([[i1, np.zeros_like(i2)],
                             [np.zeros_like(i1), i2]])
    noise = np.array([scenario['noise_image'][0]] * 2)
    return prediction, contribution, noise


INPUT_GOLDENS = {
    'invasive_sdr': ([[4.634096, 1.821645, 5.012743],
                      [-4.634303, -1.821825, -5.013139]], 1e-6),
    'invasive_sir': ([[4.63425, 1.821754, 5.013044],
                      [-4.63425, -1.821754, -5.013044]], 1e-6),
    'invasive_snr': ([[49.137625, 47.859369, 46.598417],
                      [44.503376, 46.037615, 41.585373]], 1e-6),
    'mir_eval_sdr': ([[16.286314, 15.048399, 17.420134],
                      [14.386505, 14.606471, 12.842921]], 1e-6),
    'mir_eval_sir': ([[18.172265, 17.323722, 18.868235],
                      [15.523357, 16.609909, 13.310729]], 1e-6),
    'mir_eval_sar': ([[20.883413, 19.02361, 22.949934],
                      [20.883413, 19.02361, 22.949934]], 1e-6),
    'stoi': ([[0.691546, 0.626544, 0.717809],
              [0.28424, 0.345368, 0.279996]], 3e-2),
    'srmr': ([0.51612031, 0.50214891, 0.48237807], 4e-2),
}
OUTPUT_GOLDENS = {
    'invasive_sdr': ([49.137625, 44.503376], 1e-6),
    'invasive_snr': ([49.137625, 44.503376], 1e-6),
    'mir_eval_sdr': ([17.071665, 24.711722], 1e-6),
    'mir_eval_sir': ([29.423133, 37.060289], 1e-6),
    'mir_eval_sar': ([17.336992, 24.973125], 1e-6),
    'stoi': ([0.968833, 0.976151], 1e-2),
    'srmr': ([0.54593548, 0.49966431], 4e-2),
}


@pytest.mark.parametrize('device_metrics', [None, True])
def test_input_metrics_against_the_reference_goldens(scenario,
                                                     device_metrics):
    metrics = InputMetrics(
        observation=scenario['observation'],
        speech_source=scenario['speech_source'],
        speech_image=scenario['speech_image'],
        noise_image=scenario['noise_image'], sample_rate=8000,
        device='cpu', device_metrics=device_metrics)
    assert (metrics.K_source, metrics.channels) == (2, 3)
    m = metrics.as_dict()
    for key, (value, rtol) in INPUT_GOLDENS.items():
        assert_allclose(m[key], value, rtol=rtol, err_msg=key)


@pytest.mark.parametrize('device_metrics', [None, True])
def test_output_metrics_against_the_reference_goldens(scenario,
                                                      device_metrics):
    prediction, contribution, noise = _output_inputs(scenario)
    m = OutputMetrics(
        speech_prediction=prediction,
        speech_source=scenario['speech_source'],
        speech_contribution=contribution, noise_contribution=noise,
        sample_rate=8000, device='cpu',
        device_metrics=device_metrics).as_dict()
    for key, (value, rtol) in OUTPUT_GOLDENS.items():
        assert_allclose(m[key], value, rtol=rtol, err_msg=key)
    assert np.all(np.isinf(m['invasive_sir']))
    assert_array_equal(m['mir_eval_selection'], [0, 1])


def _assert_same(got, expected, rtol):
    assert list(got) == list(expected)
    for key in expected:
        assert_allclose(got[key], expected[key], rtol=rtol, atol=1e-12,
                        err_msg=key)


def test_host_facades_equal_jax(scenario):
    m = InputMetrics(scenario['observation'], scenario['speech_source'],
                     scenario['speech_image'], scenario['noise_image'],
                     sample_rate=8000, enable_si_sdr=True, device='cpu')
    j = jev.InputMetrics(scenario['observation'], scenario['speech_source'],
                         scenario['speech_image'], scenario['noise_image'],
                         sample_rate=8000, enable_si_sdr=True,
                         device_metrics=False)
    _assert_same(m.as_dict(), j.as_dict(), 1e-12)
    prediction, contribution, noise = _output_inputs(scenario)
    m = OutputMetrics(prediction[::-1], scenario['speech_source'],
                      contribution[:, ::-1], noise, sample_rate=8000,
                      enable_si_sdr=True, device='cpu')
    j = jev.OutputMetrics(prediction[::-1], scenario['speech_source'],
                          contribution[:, ::-1], noise, sample_rate=8000,
                          enable_si_sdr=True, device_metrics=False)
    got = m.as_dict()
    _assert_same(got, j.as_dict(), 1e-12)
    assert_array_equal(got['mir_eval_selection'], [1, 0])


def _separated(seed, samples=16000):
    """3 estimates (2 speakers and a noise-like one) of a short cut of
    one dummy utterance."""
    d = dummy_data.low_reverberation_data(seed)
    images = d['speech_image'][:, 0, :samples]
    rng = np.random.RandomState(seed)
    noise = d['noise_image'][0, :samples] + 0.3 * rng.randn(samples)
    ests = np.stack([images[1] + 0.2 * images[0], noise,
                     images[0] + 0.1 * images[1]])
    return d['speech_source'][:, :samples], ests


@pytest.mark.parametrize('device_metrics', [True, False])
def test_k_plus_one_output_facade_matches_jax(device_metrics):
    sources, ests = _separated(0)
    m = OutputMetrics(ests, sources, sample_rate=8000, enable_si_sdr=True,
                      device='cpu', device_metrics=device_metrics)
    j = jev.OutputMetrics(ests, sources, sample_rate=8000,
                          enable_si_sdr=True, device_metrics=False)
    got, expected = m.as_dict(), j.as_dict()
    assert_array_equal(got['mir_eval_selection'], [2, 0])
    assert_array_equal(got['mir_eval_selection'],
                       expected['mir_eval_selection'])
    rtol = 1e-3 if device_metrics else 1e-12
    _assert_same(got, expected, rtol)
    assert_allclose(m.speech_prediction_selection.numpy(), ests[[2, 0]])


def test_compute_permutation_off():
    sources, ests = _separated(1)
    m = OutputMetrics(ests[[2, 0]], sources, sample_rate=8000,
                      compute_permutation=False, device='cpu',
                      device_metrics=True)
    j = jev.OutputMetrics(ests[[2, 0]], sources, sample_rate=8000,
                          compute_permutation=False, device_metrics=False)
    assert 'selection' not in m.mir_eval
    assert_array_equal(m.mir_eval_selection, [0, 1])
    for key in ('mir_eval_sdr', 'mir_eval_sir', 'mir_eval_sar', 'stoi'):
        assert_allclose(m[key], j[key], rtol=1e-6, err_msg=key)
    with pytest.raises(AssertionError):
        OutputMetrics(ests, sources, compute_permutation=False,
                      device='cpu').mir_eval_selection


@pytest.mark.parametrize('seed', [0, 1])
def test_input_metrics_on_the_dummy_scenarios_match_jax(seed):
    """Both synthetic scenarios (the 512-tap reverberant one too), a
    short cut of two channels, host and device routes."""
    d = (dummy_data.low_reverberation_data(seed) if seed == 0
         else dummy_data.reverberation_data(seed))
    assert_array_equal(d['observation'], (
        jax_dummy.low_reverberation_data(seed) if seed == 0
        else jax_dummy.reverberation_data(seed))['observation'])
    obs = d['observation'][:2, 4000:12000]
    src = d['speech_source'][:, 4000:12000]
    images = d['speech_image'][:, :2, 4000:12000]
    noise = d['noise_image'][:2, 4000:12000]
    j = jev.InputMetrics(obs, src, images, noise, sample_rate=8000,
                         device_metrics=False).as_dict()
    host = InputMetrics(obs, src, images, noise, sample_rate=8000,
                        device='cpu').as_dict()
    _assert_same(host, j, 1e-12)
    device = InputMetrics(obs, src, images, noise, sample_rate=8000,
                          device='cpu', device_metrics=True).as_dict()
    # the device SRMR takes its Hilbert envelope over the padded bucket
    # (the JAX package's design; 1.5e-3 from the host on this 1 s cut):
    # hold it to the JAX device program, which does the same
    host_srmr = j.pop('srmr')
    assert_allclose(device.pop('srmr'), jev.srmr_batch(obs, 8000),
                    rtol=1e-4)
    assert_allclose(host.pop('srmr'), host_srmr, rtol=1e-12)
    _assert_same(device, j, 1e-6)


def test_batch_facades_match_jax():
    """The batch forms against the JAX batch forms (which run the device
    programs, in float64 here) with leading batch dims, K+1 routing and
    the invasive metrics."""
    pairs = [_separated(seed, samples=12000) for seed in range(4)]
    sources = np.stack([p[0] for p in pairs]).reshape(2, 2, 2, 12000)
    ests = np.stack([p[1] for p in pairs]).reshape(2, 2, 3, 12000)
    m = OutputMetricsBatch(torch.as_tensor(ests), sources,
                           sample_rate=8000, enable_si_sdr=True,
                           device='cpu')
    j = jev.OutputMetricsBatch(ests, sources, sample_rate=8000,
                               enable_si_sdr=True)
    got = m.as_dict()
    assert got['mir_eval_sdr'].shape == (2, 2, 2)
    _assert_same(got, j.as_dict(), 1e-8)
    assert_allclose(m.speech_prediction_selection.numpy(),
                    np.asarray(j.speech_prediction_selection))

    obs = ests[..., :2, :] + 0.5 * ests[..., 2:, :]
    mi = InputMetricsBatch(obs, sources, sample_rate=8000,
                           enable_si_sdr=True, device='cpu')
    ji = jev.InputMetricsBatch(obs, sources, sample_rate=8000,
                               enable_si_sdr=True)
    got = mi.as_dict()
    assert got['stoi'].shape == (2, 2, 2, 2)
    assert got['srmr'].shape == (2, 2, 2)
    _assert_same(got, ji.as_dict(), 1e-8)


def test_batch_facades_invasive_and_no_sample_rate(scenario):
    prediction, contribution, noise = _output_inputs(scenario)
    m = OutputMetricsBatch(prediction[None], scenario['speech_source'][None],
                           contribution[None], noise[None],
                           sample_rate=8000, device='cpu')
    single = OutputMetrics(prediction, scenario['speech_source'],
                           contribution, noise, sample_rate=8000,
                           device='cpu')
    for key in ('invasive_sdr', 'invasive_sir', 'invasive_snr'):
        assert_allclose(m[key][0], single[key], rtol=1e-12)
    mi = InputMetricsBatch(scenario['observation'][None],
                           scenario['speech_source'][None],
                           scenario['speech_image'][None],
                           scenario['noise_image'][None], device='cpu')
    assert 'stoi' not in mi.mir_eval
    assert_allclose(mi.mir_eval_sdr[0],
                    INPUT_GOLDENS['mir_eval_sdr'][0], rtol=1e-6)
    for key in ('invasive_sdr', 'invasive_sir', 'invasive_snr'):
        assert_allclose(mi[key][0], INPUT_GOLDENS[key][0], rtol=1e-6)
    mo = OutputMetricsBatch(prediction[None], scenario['speech_source'][None],
                            device='cpu')
    assert_allclose(mo.mir_eval_sdr[0], OUTPUT_GOLDENS['mir_eval_sdr'][0],
                    rtol=1e-6)


def test_verbose_key_error_and_disabled_metrics(scenario):
    m = OutputMetrics(scenario['speech_source'], scenario['speech_source'],
                      device='cpu')
    j = jev.OutputMetrics(scenario['speech_source'],
                          scenario['speech_source'], device_metrics=False)
    with pytest.raises(VerboseKeyError) as ours:
        m['mir_eval_sd']
    with pytest.raises(KeyError) as ref:
        j['mir_eval_sd']
    assert str(ours.value) == str(ref.value)
    assert 'Close matches' in str(ours.value)
    assert m._disabled_metric_names() == j._disabled_metric_names()
    with pytest.raises(ValueError, match='enable_si_sdr'):
        m.si_sdr
    for batch in (OutputMetricsBatch(scenario['speech_source'][None],
                                     scenario['speech_source'][None],
                                     device='cpu'),
                  InputMetricsBatch(scenario['observation'][None],
                                    scenario['speech_source'][None],
                                    device='cpu')):
        with pytest.raises(VerboseKeyError, match='Disabled'):
            batch['sdr']


def test_pesq_error_path_and_disabled_listing(scenario):
    pytest.importorskip('numpy')
    try:
        import pesq  # noqa: F401
        pytest.skip('the pesq library is installed here')
    except ImportError:
        pass
    with pytest.raises(AssertionError, match='pip install pesq'):
        ev.pesq(scenario['speech_source'][0], scenario['observation'][0],
                8000)
    metrics = [InputMetrics(scenario['observation'],
                            scenario['speech_source'], device='cpu'),
               OutputMetrics(scenario['speech_source'],
                             scenario['speech_source'], device='cpu'),
               InputMetricsBatch(scenario['observation'][None],
                                 scenario['speech_source'][None],
                                 device='cpu'),
               OutputMetricsBatch(scenario['speech_source'][None],
                                  scenario['speech_source'][None],
                                  device='cpu')]
    for m in metrics:
        assert 'pesq' in m._disabled_metric_names()
        assert 'pesq' not in m._available_metric_names()
        with pytest.raises(AssertionError, match='pip install pesq'):
            m['pesq']


def test_shape_contracts(scenario):
    src = scenario['speech_source']
    with pytest.raises(AssertionError, match='Shapes'):
        OutputMetrics(np.concatenate([src, src]), src, device='cpu')
    with pytest.raises(AssertionError, match='sample count'):
        OutputMetrics(src[:, :5000], src, device='cpu')
    prediction, contribution, noise = _output_inputs(scenario)
    with pytest.raises(AssertionError, match='add up'):
        OutputMetrics(prediction, src, contribution,
                      noise + np.random.RandomState(0).randn(*noise.shape),
                      device='cpu')
    with pytest.raises(AssertionError, match='together'):
        OutputMetrics(prediction, src, contribution, device='cpu')
    with pytest.raises(AssertionError):
        InputMetrics(scenario['observation'][None], src, device='cpu')
    with pytest.raises(AssertionError, match='batched'):
        OutputMetricsBatch(prediction, src, device='cpu')


def test_device_cuda_raises_without_cuda(monkeypatch, scenario):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    src = scenario['speech_source']
    obs = scenario['observation']
    for make in (lambda: InputMetrics(obs, src),
                 lambda: OutputMetrics(src, src),
                 lambda: OutputMetrics(src, src, device_metrics=False),
                 lambda: InputMetricsBatch(obs[None], src[None]),
                 lambda: OutputMetricsBatch(src[None], src[None])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_routing_follows_the_device(scenario):
    src = scenario['speech_source']
    assert not OutputMetrics(src, src, device='cpu')._use_device_metrics
    assert OutputMetrics(src, src, device='cpu',
                         device_metrics=True)._use_device_metrics
    m = OutputMetrics(torch.as_tensor(src, dtype=torch.float32),
                      torch.as_tensor(src), sample_rate=8000,
                      device='cpu', device_metrics=True)
    assert m.mir_eval_sdr.dtype == np.float32
