"""models.base's three observation normalizers against the JAX
package's: ``_unit_norm`` (an alias of ops.linalg.unit_norm),
``_phase_norm`` and ``_frequency_norm`` on the same numpy inputs, in
float32 (rtol 1e-6, atol 1e-6) and complex128 (1e-12)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_bss_tpu.models import base as jax_base
from pb_bss_tpu_torch.models import base


def _signal(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _tolerance(dtype):
    return 1e-6 if dtype == np.complex64 else 1e-12


@pytest.mark.parametrize('dtype', [np.complex64, np.complex128])
@pytest.mark.parametrize('options', [
    dict(), dict(eps_style='max'), dict(eps_style='where', eps=1e-8),
    dict(ord=1, axis=-2)])
def test_unit_norm_matches_jax(dtype, options):
    x = _signal((5, 7, 3), dtype)
    x[0, 0] = 0
    ours = base._unit_norm(torch.from_numpy(x), **options).numpy()
    theirs = np.asarray(jax_base._unit_norm(jnp.asarray(x), **options))
    tol = _tolerance(dtype)
    np.testing.assert_allclose(ours, theirs, rtol=tol, atol=tol)


@pytest.mark.parametrize('dtype', [np.complex64, np.complex128])
@pytest.mark.parametrize('reference_channel', [0, 2])
def test_phase_norm_matches_jax(dtype, reference_channel):
    x = _signal((4, 9, 3), dtype, 1)
    ours = base._phase_norm(torch.from_numpy(x), reference_channel)
    theirs = np.asarray(jax_base._phase_norm(jnp.asarray(x),
                                             reference_channel))
    tol = _tolerance(dtype)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        np.angle(ours[..., reference_channel].numpy()), 0, atol=tol)


@pytest.mark.parametrize('dtype', [np.complex64, np.complex128])
def test_frequency_norm_matches_jax(dtype):
    """fft_size 1024 at 16 kHz: 513 bins, sensors 1.5 cm apart (the
    factor stays >= 1 up to 8 kHz). The DC bin's factor is the huge
    finite value of nan_to_num in both packages."""
    x = _signal((513, 6, 3), dtype, 2)
    kwargs = dict(max_sensor_distance=0.015)
    ours = base._frequency_norm(torch.from_numpy(x), **kwargs)
    theirs = np.asarray(jax_base._frequency_norm(jnp.asarray(x), **kwargs))
    assert ours.dtype == torch.from_numpy(x).dtype
    tol = _tolerance(dtype)
    # the factor (610 at bin 1) scales the phase, and with it the last
    # ulp by which torch's and XLA's float32 angles part: complex64 is
    # held at 610 ulps of the phase times the magnitude (measured 2.0e-4)
    atol = 610 * 1.2e-7 * np.abs(x).max() if dtype == np.complex64 else tol
    np.testing.assert_allclose(ours.numpy()[1:], theirs[1:], rtol=tol,
                               atol=atol)
    np.testing.assert_array_equal(np.isnan(ours.numpy()[0]),
                                  np.isnan(theirs[0]))
    np.testing.assert_allclose(np.abs(ours.numpy()[1:]), np.abs(x[1:]),
                               rtol=tol)


def test_frequency_norm_raises_for_distant_sensors():
    x = _signal((513, 6, 3), np.complex64, 3)
    with pytest.raises(ValueError, match='too high'):
        base._frequency_norm(torch.from_numpy(x), max_sensor_distance=0.05)
    with pytest.raises(ValueError, match='too high'):
        jax_base._frequency_norm(jnp.asarray(x), max_sensor_distance=0.05)


def test_base_exports_the_norms():
    for name in ('_unit_norm', '_phase_norm', '_frequency_norm'):
        assert name in base.__all__ and name in jax_base.__all__
    assert set(jax_base.__all__) <= set(base.__all__)
