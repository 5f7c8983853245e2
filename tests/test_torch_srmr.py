"""The port's SRMR (host oracle, device program) against
pb_bss_tpu.evaluation's on the same numpy signals (x64 JAX on the CPU);
the designed filters bit for bit."""
import numpy as np
import pytest
import scipy.signal
import torch
from numpy.testing import assert_allclose, assert_array_equal

from pb_bss_tpu.evaluation import module_srmr as jhost
from pb_bss_tpu.evaluation import module_srmr_device as jdev
from pb_bss_tpu.transform import gammatone as jgt
from pb_bss_tpu_torch.evaluation import srmr, srmr_batch, srmr_device
from pb_bss_tpu_torch.evaluation import module_srmr as host
from pb_bss_tpu_torch.evaluation import module_srmr_device as dev

torch.set_num_threads(2)


def _speechlike(seed, n, sr, gap=None):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / sr
    x = (0.5 + 0.5 * np.sin(2 * np.pi * 4.1 * t + rng.rand() * 6)) \
        * rng.randn(n)
    if gap is not None:
        x[gap[0]:gap[1]] *= 1e-6  # silent region -> VAD splice
    return x


@pytest.mark.parametrize('sr', [8000, 16000])
def test_designed_filters_bit_for_bit(sr):
    for ours, ref in zip(dev._modulation_coefficients(sr),
                         jdev._modulation_coefficients(sr)):
        assert_array_equal(ours, ref)
    m = 4 * int(sr / 1000) * 256
    design = dev._design(sr, m, 23, 125)
    n_fft = int(2 ** np.ceil(np.log2(2 * m - 1)))
    # the JAX SRMR program's host design, step by step
    b_mod, a_mod = jdev._modulation_coefficients(sr)
    impulse = np.zeros(m)
    impulse[0] = 1.0
    h_mod = np.stack([scipy.signal.lfilter(b_mod[k], a_mod[k], impulse)
                      for k in range(8)])
    assert_array_equal(design['hf_mod'], np.fft.rfft(h_mod, n_fft))
    assert_array_equal(design['hf_gt'], jgt._impulse_response_rfft(
        125, sr / 2, 23, sr, m, n_fft))
    assert_array_equal(design['hamm'], scipy.signal.windows.hamming(
        int(sr / 1000) * 256, sym=True))
    assert_array_equal(design['erbs'],
                       jgt.calculate_cfs(125, sr / 2, 23) / 9.26449 + 24.7)


def test_vad_and_host_oracle_match_jax():
    sr = 8000
    x = _speechlike(0, 3 * sr, sr, gap=(4000, 9000))
    assert_array_equal(host._preprocessing_vad(x, sr),
                       jhost._preprocessing_vad(x, sr))
    xs = np.stack([x, _speechlike(1, 3 * sr, sr)])
    assert_allclose(srmr(xs, sr), jhost.srmr(xs, sr), rtol=1e-12)
    assert srmr(x, sr) == jhost.srmr(x, sr)


@pytest.mark.parametrize('sr', [8000, 16000])
def test_device_float64_matches_host_and_jax(sr):
    xs = np.stack([_speechlike(s, 2 * sr, sr) for s in range(2)])
    expected = np.array([srmr(x, sr) for x in xs])
    got = srmr_batch(xs, sr, device='cpu')
    assert got.dtype == np.float64
    assert_allclose(got, expected, rtol=1e-3)
    # the JAX device program runs in float32 whatever the input
    assert_allclose(got, jdev.srmr_batch(xs, sr), rtol=2e-3)


def test_vad_splice_and_ragged_lengths_share_a_bucket():
    sr = 8000
    xs = np.stack([_speechlike(0, 3 * sr, sr),
                   _speechlike(1, 3 * sr, sr, gap=(4000, 9000)),
                   _speechlike(2, 3 * sr, sr, gap=(1000, 11000))])
    expected = np.array([srmr(x, sr) for x in xs])
    assert_allclose(srmr_batch(xs, sr, device='cpu'), expected, rtol=1e-3)
    got32 = srmr_batch(torch.as_tensor(xs, dtype=torch.float32), sr,
                       device='cpu')
    assert got32.dtype == np.float32
    assert_allclose(got32, expected, rtol=2e-3)


def test_chunks_and_leading_dims(monkeypatch):
    sr = 8000
    xs = np.stack([_speechlike(s, sr + 500 * s, sr)[:sr]
                   for s in range(4)]).reshape(2, 2, sr)
    whole = srmr_batch(xs, sr, device='cpu')
    assert whole.shape == (2, 2)
    # a working set of one signal: four chunks of one
    m = dev._bucket(np.array([sr]), sr)
    monkeypatch.setattr(dev, '_WORKING_SET_BYTES',
                        dev._working_set_per_signal(m, 23, 8))
    assert_array_equal(srmr_batch(xs, sr, device='cpu'), whole)
    assert_allclose(whole[1, 0], srmr(xs[1, 0], sr), rtol=1e-3)


def test_single_signal_and_too_short_is_nan():
    sr = 8000
    x = _speechlike(3, 2 * sr, sr)
    got = srmr_device(x, sr, device='cpu')
    assert isinstance(got, float)
    assert abs(got - srmr(x, sr)) < 1e-3 * srmr(x, sr)
    short = _speechlike(4, 1000, sr)      # shorter than one 2,048 frame
    assert np.isnan(srmr_device(short, sr, device='cpu'))
    with np.errstate(all='ignore'), pytest.warns(RuntimeWarning):
        assert np.isnan(srmr(short, sr))


def test_device_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    x = _speechlike(5, 8000, 8000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        srmr_batch(x[None], 8000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        srmr_device(x, 8000)
