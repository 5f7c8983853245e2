"""pb_bss_tpu_torch.transform.filters / .gammatone against
pb_bss_tpu.transform's on the same numpy signals (x64 JAX on the CPU),
the designed filters bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch
from numpy.testing import assert_allclose, assert_array_equal

from pb_bss_tpu.transform import filters as jfilters
from pb_bss_tpu.transform import gammatone as jgt
from pb_bss_tpu_torch.transform import filters, gammatone
from pb_bss_tpu_torch.transform import gammatone_filterbank

torch.set_num_threads(2)

SECTIONS = [([0.2, 0.1, -0.3], [1.0, -1.2, 0.5]),
            ([1.0, 0.0, 0.0], [1.0, -0.9, 0.0]),
            ([0.5, -0.4, 0.25], [2.0, -1.9, 0.95])]


def _signal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize('T', [1, 2, 7, 1000, 1025])
@pytest.mark.parametrize('section', range(len(SECTIONS)))
def test_biquad_matches_lfilter_and_jax(T, section):
    b, a = SECTIONS[section]
    x = _signal((3, T))
    expected = scipy.signal.lfilter(b, a, x)
    out = filters.biquad_filter(torch.as_tensor(x), b, a)
    assert out.dtype == torch.float64
    scale = np.abs(expected).max()
    assert_allclose(out.numpy(), expected, atol=1e-12 * scale)
    ref = np.asarray(jfilters.biquad_filter(jnp.asarray(x), b, a))
    assert_allclose(out.numpy(), ref, atol=1e-12 * scale)


def test_biquad_per_filter_coefficient_tensors():
    """Coefficients with a leading filter axis filter each row with its
    own section, as the JAX scan does."""
    x = _signal((3, 1, 500), seed=1)
    b = np.array([s[0] for s in SECTIONS])
    a = np.array([s[1] for s in SECTIONS])
    out = filters.biquad_filter(
        torch.as_tensor(x), [torch.as_tensor(b[:, i])[:, None]
                             for i in range(3)],
        [torch.as_tensor(a[:, i])[:, None] for i in range(3)])
    assert out.shape == (3, 1, 500)
    for i in range(3):
        assert_allclose(out[i, 0].numpy(),
                        scipy.signal.lfilter(b[i], a[i], x[i, 0]),
                        atol=1e-12)


def test_lfilter_sos_is_the_cascade():
    x = _signal(800, seed=2)
    expected = x
    for b, a in SECTIONS:
        expected = scipy.signal.lfilter(b, a, expected)
    out = filters.lfilter_sos(torch.as_tensor(x), SECTIONS)
    ref = np.asarray(jfilters.lfilter_sos(jnp.asarray(x), SECTIONS))
    assert_allclose(out.numpy(), expected, atol=1e-10)
    assert_allclose(out.numpy(), ref, atol=1e-10)


@pytest.mark.parametrize('sample_rate,n,low', [(8000, 23, 125),
                                               (16000, 23, 125),
                                               (16000, 8, 300)])
def test_designed_filters_bit_for_bit(sample_rate, n, low):
    high = sample_rate / 2
    for f in (125.0, 1000.0, 3999.0):
        assert gammatone.Hz_2_ERBS(f) == jgt.Hz_2_ERBS(f)
        assert gammatone.ERBS_2_Hz(10.0) == jgt.ERBS_2_Hz(10.0)
    cfs = gammatone.calculate_cfs(low, high, n)
    assert_array_equal(cfs, jgt.calculate_cfs(low, high, n))
    for ours, ref in zip(gammatone._calculate_coefficients(cfs, sample_rate),
                         jgt._calculate_coefficients(cfs, sample_rate)):
        assert_array_equal(ours, ref)
    for ours, ref in zip(
            gammatone._section_coefficients(low, high, n, sample_rate),
            jgt._section_coefficients(low, high, n, sample_rate)):
        assert_array_equal(ours, ref)
    assert_array_equal(
        gammatone._impulse_response_rfft(low, high, n, sample_rate, 700,
                                         2048),
        jgt._impulse_response_rfft(low, high, n, sample_rate, 700, 2048))


def test_host_route_equals_jax():
    x = _signal((2, 1200), seed=3)
    out = gammatone_filterbank(x, 8000, n=23, device=False)
    assert isinstance(out, np.ndarray) and out.shape == (23, 2, 1200)
    assert_array_equal(out, jgt.gammatone_filterbank(x, 8000, n=23,
                                                     device=False))


@pytest.mark.parametrize('method', ['fft', 'scan'])
def test_device_routes_float64_match_jax_and_host(method):
    x = _signal((2, 3, 900), seed=4)
    host = gammatone_filterbank(x, 8000, n=12, device=False)
    out = gammatone_filterbank(torch.as_tensor(x), 8000, n=12,
                               method=method)
    assert out.shape == (12, 2, 3, 900) and out.dtype == torch.float64
    ref = np.asarray(jgt.gammatone_filterbank(jnp.asarray(x), 8000, n=12,
                                              method=method))
    scale = np.abs(host).max()
    assert_allclose(out.numpy(), host, atol=1e-10 * scale)
    assert_allclose(out.numpy(), ref, atol=1e-10 * scale)


@pytest.mark.parametrize('method,rtol', [('fft', 1e-5), ('scan', 1e-3)])
def test_device_routes_float32_against_host(method, rtol):
    """The JAX package's finding holds in the port: the gammatone
    cascade is float32-safe on both routes."""
    x = _signal(4000, seed=5)
    host = gammatone_filterbank(x, 16000, device=False)
    out = gammatone_filterbank(torch.as_tensor(x, dtype=torch.float32),
                               16000, method=method)
    assert out.dtype == torch.float32
    assert_allclose(out.numpy(), host, atol=rtol * np.abs(host).max())


def test_fft_route_uploads_the_spectra_once():
    gammatone._impulse_response_rfft_device.cache_clear()
    x = torch.as_tensor(_signal(300, seed=6))
    for _ in range(3):
        gammatone_filterbank(x, 8000, n=4)
    info = gammatone._impulse_response_rfft_device.cache_info()
    assert (info.misses, info.hits) == (1, 2)


def test_an_array_goes_to_the_card_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    x = _signal(300, seed=7)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gammatone_filterbank(x, 8000, n=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gammatone_filterbank(torch.as_tensor(x), 8000, n=4, device='cuda')
    out = gammatone_filterbank(x, 8000, n=4, device='cpu')
    assert out.device.type == 'cpu'
