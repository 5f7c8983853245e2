"""The port's si_sdr against the JAX package's: the float64 contract
(int16 PCM and float32 raise unless allow_float32, as in
pb_bss_tpu/evaluation/module_si_sdr.py), the float64 value and the
float32 opt-in path, on the same numpy inputs."""
import numpy as np
import pytest
import torch

from pb_bss_tpu.evaluation.module_si_sdr import (
    si_sdr as jax_si_sdr,
    si_sdr_allow_float32 as jax_allow_float32,
)
from pb_bss_tpu_torch.evaluation import si_sdr, si_sdr_allow_float32


def _pcm(seed=0, n=16000):
    rng = np.random.RandomState(seed)
    reference = (rng.randn(n) * 8000).astype(np.int16)
    estimation = (0.9 * reference + rng.randn(n) * 800).astype(np.int16)
    return reference, estimation


@pytest.mark.parametrize('as_tensor', [False, True])
def test_int16_pcm_raises_as_jax_does(as_tensor):
    """int16 squares overflow: the value would be garbage (2.18 dB where
    the truth is 19.01 dB), so both packages refuse integer input."""
    reference, estimation = _pcm()
    with pytest.raises(AssertionError, match='float64'):
        jax_si_sdr(reference, estimation)
    args = ((torch.as_tensor(reference), torch.as_tensor(estimation))
            if as_tensor else (reference, estimation))
    with pytest.raises(AssertionError, match='float64'):
        si_sdr(*args)
    # the opt-in policy never opts integer input in
    assert not si_sdr_allow_float32(*args)
    assert not jax_allow_float32(reference, estimation)


def test_float64_value_matches_jax():
    reference, estimation = (x.astype(np.float64) for x in _pcm())
    ours = float(si_sdr(torch.as_tensor(reference),
                        torch.as_tensor(estimation)))
    theirs = float(jax_si_sdr(reference, estimation))
    assert abs(ours - 19.01) < 0.01, ours
    # both in float64: the same sums in two orders
    assert abs(ours - theirs) < 1e-9, (ours, theirs)


def test_float32_needs_the_opt_in():
    rng = np.random.default_rng(1)
    reference = rng.standard_normal((2, 4000)).astype(np.float32)
    estimation = (reference + 0.1 * rng.standard_normal((2, 4000))).astype(
        np.float32)
    with pytest.raises(AssertionError, match='allow_float32'):
        si_sdr(torch.as_tensor(reference), torch.as_tensor(estimation))
    assert si_sdr_allow_float32(torch.as_tensor(reference),
                                torch.as_tensor(estimation))
    assert jax_allow_float32(reference, estimation)
    ours = si_sdr(torch.as_tensor(reference), torch.as_tensor(estimation),
                  allow_float32=True).numpy()
    theirs = np.asarray(jax_si_sdr(reference, estimation,
                                   allow_float32=True))
    # float32 sums of 4000 samples in two orders (~0.01 dB of noise at
    # most, the contract's own estimate)
    np.testing.assert_allclose(ours, theirs, atol=1e-3)
