"""pb_bss_tpu_torch.transform against pb_bss_tpu.transform on the same
numpy signals."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.transform import istft as jistft, stft as jstft
from pb_bss_tpu_torch.transform import istft, stft
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
