"""pb_bss_tpu_torch.transform against pb_bss_tpu.transform on the same
numpy signals."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.transform import STFT as JSTFT, istft as jistft, stft as jstft
from pb_bss_tpu_torch.transform import STFT, istft, stft
from pb_bss_tpu_torch.transform.stft_module import stft_frames

torch.set_num_threads(2)


@pytest.mark.parametrize('num_samples,size,shift', [
    (4000, 512, 128), (4001, 512, 128), (300, 512, 128), (2000, 256, 96)])
def test_stft_matches_jax(num_samples, size, shift):
    x = np.random.default_rng(0).standard_normal(
        (2, num_samples)).astype(np.float32)
    ref = np.asarray(jstft(jnp.asarray(x, jnp.float32), size, shift))
    out = stft(torch.as_tensor(x), size, shift).numpy()
    assert out.shape == ref.shape
    assert out.shape[-2] == stft_frames(num_samples, size, shift)
    # two f32 FFT implementations: rounding at ~1e-6 of |X| ~ 10
    assert_allclose(out, ref, atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize('num_samples', [4000, 3900, 4100])
def test_istft_matches_jax_and_num_samples_cut(num_samples):
    rng = np.random.default_rng(1)
    X = (rng.standard_normal((3, 35, 257))
         + 1j * rng.standard_normal((3, 35, 257))).astype(np.complex64)
    ref = np.asarray(jistft(jnp.asarray(X), num_samples=num_samples))
    out = istft(torch.as_tensor(X), num_samples=num_samples).numpy()
    assert out.shape == ref.shape == (3, num_samples)
    assert_allclose(out, ref, atol=1e-5)


def test_istft_without_shift_dividing_size_matches_jax():
    rng = np.random.default_rng(2)
    X = (rng.standard_normal((20, 129))
         + 1j * rng.standard_normal((20, 129))).astype(np.complex64)
    ref = np.asarray(jistft(jnp.asarray(X), 256, 96))
    out = istft(torch.as_tensor(X), 256, 96).numpy()
    assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize('dtype,atol', [
    (torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_perfect_reconstruction(dtype, atol):
    x = torch.as_tensor(
        np.random.default_rng(3).standard_normal((6, 5000)), dtype=dtype)
    x_hat = istft(stft(x), num_samples=5000)
    assert x_hat.dtype == dtype
    assert_allclose(x_hat.numpy(), x.numpy(), atol=atol)


def _ramp_window(size):
    return np.linspace(0.1, 1.0, size) ** 2


@pytest.mark.parametrize('window', ['hann', 'hamming', _ramp_window])
def test_windows_by_name_and_callable_match_jax(window):
    x = np.random.default_rng(4).standard_normal((2, 3000))
    ref = np.asarray(jstft(jnp.asarray(x), 256, 64, window=window))
    out = stft(torch.as_tensor(x), 256, 64, window=window)
    assert_allclose(out.numpy(), ref, atol=1e-10)
    X = ref.astype(np.complex128)
    ref_x = np.asarray(jistft(jnp.asarray(X), 256, 64, window=window,
                              num_samples=3000))
    out_x = istft(torch.as_tensor(X), 256, 64, window=window,
                  num_samples=3000)
    assert_allclose(out_x.numpy(), ref_x, atol=1e-10)
    assert_allclose(out_x.numpy(), x, atol=1e-10)


def test_a_callable_window_equals_its_named_twin():
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(2000))
    named = stft(x, 128, 32, window='hann')
    called = stft(x, 128, 32, window=lambda size: scipy.signal.get_window(
        'hann', size, fftbins=True))
    assert torch.equal(named, called)


@pytest.mark.parametrize('fading', [True, False])
def test_stft_class_matches_jax(fading):
    x = np.random.default_rng(6).standard_normal((3, 2500))
    ours = STFT(256, 64, window='hann', fading=fading)
    ref = JSTFT(256, 64, window='hann', fading=fading)
    assert ours.frequencies == ref.frequencies == 129
    X = ours(torch.as_tensor(x))
    assert_allclose(X.numpy(), np.asarray(ref(jnp.asarray(x))), atol=1e-10)
    back = ours.inverse(X, num_samples=2500)
    assert_allclose(back.numpy(), np.asarray(
        ref.inverse(jnp.asarray(X.numpy()), num_samples=2500)), atol=1e-10)
    if fading:
        assert_allclose(back.numpy(), x, atol=1e-10)


@pytest.mark.parametrize('size,shift,window', [
    (512, 128, 'blackman'), (256, 96, 'hann'), (512, 128, _ramp_window)])
def test_matmul_stft_matches_jax_and_fft(size, shift, window):
    """stft(method='matmul') (the port's one FFT path) equals the JAX
    package's 'matmul' (the windowed DFT as two real products) at 1e-5
    of the peak, and the port's 'fft' bit for bit."""
    x = np.random.default_rng(4).standard_normal((2, 3000)).astype(
        np.float32)
    ref = np.asarray(jstft(jnp.asarray(x, jnp.float32), size, shift,
                           window=window, method='matmul'))
    out = stft(torch.as_tensor(x), size, shift, window=window,
               method='matmul').numpy()
    fft = stft(torch.as_tensor(x), size, shift, window=window,
               method='fft').numpy()
    peak = np.abs(ref).max()
    assert out.shape == ref.shape == fft.shape
    assert_allclose(out, ref, rtol=0, atol=1e-5 * peak)
    np.testing.assert_array_equal(out, fft)


@pytest.mark.parametrize('size,shift,window', [
    (512, 128, 'blackman'), (256, 96, 'hann')])
def test_matmul_istft_matches_jax_and_fft(size, shift, window):
    """istft(method='matmul') (the port's one FFT path) equals the JAX
    package's 'matmul' (the synthesis-windowed real iDFT as two real
    products) at 1e-5 of the peak, and the port's 'fft' bit for bit."""
    rng = np.random.default_rng(5)
    X = (rng.standard_normal((3, 30, size // 2 + 1))
         + 1j * rng.standard_normal((3, 30, size // 2 + 1))).astype(
        np.complex64)
    ref = np.asarray(jistft(jnp.asarray(X), size, shift, window=window,
                            num_samples=3000, method='matmul'))
    out = istft(torch.as_tensor(X), size, shift, window=window,
                num_samples=3000, method='matmul').numpy()
    fft = istft(torch.as_tensor(X), size, shift, window=window,
                num_samples=3000, method='fft').numpy()
    peak = np.abs(ref).max()
    assert out.shape == ref.shape == (3, 3000)
    assert_allclose(out, ref, rtol=0, atol=1e-5 * peak)
    np.testing.assert_array_equal(out, fft)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_auto_method_is_the_fft_bit_for_bit(dtype):
    """method='auto' (the default) is 'fft' on every device: the calls
    without method= give the same bits, and an unknown method raises."""
    x = torch.as_tensor(np.random.default_rng(6).standard_normal((2, 3000)),
                        dtype=dtype)
    X = stft(x)
    assert torch.equal(stft(x, method='auto'), X)
    assert torch.equal(stft(x, method='fft'), X)
    assert torch.equal(istft(X, method='auto'), istft(X))
    assert torch.equal(istft(X, method='fft'), istft(X))
    with pytest.raises(ValueError, match='method'):
        stft(x, method='dft')
