"""The port's STOI (host float64 oracle, device program) against
pb_bss_tpu.evaluation's on the same numpy signals (x64 JAX on the CPU);
the resampler FIR and the third-octave matrix bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch
from numpy.testing import assert_allclose, assert_array_equal

from pb_bss_tpu.evaluation import module_stoi as jhost
from pb_bss_tpu.evaluation import module_stoi_device as jdev
from pb_bss_tpu_torch.evaluation import stoi, stoi_batch, stoi_device
from pb_bss_tpu_torch.evaluation import module_stoi as host
from pb_bss_tpu_torch.evaluation import module_stoi_device as dev

torch.set_num_threads(2)


def _speechlike(seed, n, fs):
    """Modulated noise with a few silent gaps (exercises frame
    removal)."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / fs
    x = rng.randn(n) * (0.2 + np.abs(np.sin(2 * np.pi * 3.1 * t)))
    gap = int(0.05 * fs)
    for start in (int(0.2 * n), int(0.7 * n)):
        x[start:start + gap] *= 1e-4
    return x


def test_designed_filters_and_constants_bit_for_bit():
    for name in ('FS', 'N_FRAME', 'NFFT', 'NUMBAND', 'MINFREQ', 'N_SEG',
                 'BETA', 'DYN_RANGE'):
        assert getattr(host, name) == getattr(jhost, name), name
    for ours, ref in zip(host._thirdoct(10000, 512, 15, 150),
                         jhost._thirdoct(10000, 512, 15, 150)):
        assert_array_equal(ours, ref)
    for up, down, n in ((10000, 8000, 16000), (10000, 16000, 32000),
                        (10000, 44100, 4410)):
        ours = dev._resampler_design(up, down, n)
        ref = jdev._resampler_design(up, down, n)
        assert ours[:2] == ref[:2] and ours[3:] == ref[3:]
        assert_array_equal(ours[2], ref[2])
    window, obm = dev._window_and_bands(torch.float64, torch.device('cpu'))
    assert_array_equal(window.numpy(), np.hanning(258)[1:-1])
    assert_array_equal(obm.numpy(), jhost._thirdoct(10000, 512, 15, 150)[0])


@pytest.mark.parametrize('fs', [8000, 16000])
def test_resampler_matches_resample_poly(fs):
    x = np.random.RandomState(0).randn(fs)
    design = dev._resampler_design(10000, fs, fs)
    got = dev._resample(torch.as_tensor(x), *design).numpy()
    assert_allclose(got, scipy.signal.resample_poly(x, 10000, fs),
                    atol=1e-10)


@pytest.mark.parametrize('fs', [10000, 8000])
def test_host_oracle_matches_jax(fs):
    ref = np.stack([_speechlike(s, 2 * fs, fs) for s in (1, 2)])
    est = ref + 0.3 * np.stack([_speechlike(s, 2 * fs, fs) for s in (3, 4)])
    assert_allclose(stoi(ref, est, fs), jhost.stoi(ref, est, fs),
                    atol=1e-12)


@pytest.mark.parametrize('fs', [10000, 8000, 16000])
def test_device_float64_matches_jax_and_host(fs):
    ref = _speechlike(1, 2 * fs, fs)
    est = ref + 0.3 * _speechlike(2, 2 * fs, fs)
    got = stoi_device(ref, est, fs, device='cpu')
    assert abs(got - stoi(ref, est, fs)) < 1e-9
    assert abs(got - jdev.stoi_device(ref, est, fs)) < 1e-9


def test_device_float32_against_the_float64_oracle():
    fs = 8000
    ref = _speechlike(3, 2 * fs, fs)
    est = ref + 0.4 * _speechlike(4, 2 * fs, fs)
    got = stoi_batch(ref.astype(np.float32)[None],
                     est.astype(np.float32)[None], fs, device='cpu')
    assert got.dtype == np.float32
    assert abs(float(got[0]) - stoi(ref, est, fs)) < 2e-3


def test_batch_leading_dims_and_broadcast():
    fs, n = 10000, 16000
    ref = _speechlike(11, n, fs)
    ests = np.stack([ref + a * _speechlike(12 + i, n, fs)
                     for i, a in enumerate((0.2, 0.5, 0.8, 1.1))])
    out = stoi_batch(torch.as_tensor(ref)[None, None],
                     ests.reshape(2, 2, n), fs, device='cpu')
    assert out.shape == (2, 2)
    assert_allclose(out.reshape(-1), [stoi(ref, e, fs) for e in ests],
                    atol=1e-9)
    assert_allclose(out, jdev.stoi_batch(ref[None, None],
                                         ests.reshape(2, 2, n), fs),
                    atol=1e-9)


def test_all_silent_is_nan_where_the_host_raises():
    fs, n = 10000, 16000
    ref = np.zeros(n)
    ref[:256] = _speechlike(14, 256, fs)  # one loud frame, < N_SEG
    est = ref.copy()
    with pytest.raises(ValueError):
        stoi(ref + 1e-12, est, fs)
    out = stoi_batch((ref + 1e-12)[None], est[None], fs, device='cpu')
    assert np.isnan(out[0])
    assert np.isnan(jdev.stoi_batch((ref + 1e-12)[None], est[None], fs)[0])


def test_device_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    x = _speechlike(15, 16000, 8000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stoi_batch(x[None], x[None], 8000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stoi_device(x, x, 8000)


def test_jax_reference_resampler_agrees():
    """The two packages' device resamplers on the same taps."""
    x = np.random.RandomState(1).randn(4000)
    design = dev._resampler_design(10000, 8000, 4000)
    ours = dev._resample(torch.as_tensor(x), *design).numpy()
    ref = np.asarray(jdev._resample_device(jnp.asarray(x), *design))
    assert_allclose(ours, ref, atol=1e-12)
