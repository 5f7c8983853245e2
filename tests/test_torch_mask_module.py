"""The port's masks (``extraction.mask_module``) and geometry helpers
(``extraction.beamform_utils``) against the JAX package's on the same
seeded inputs (complex64 unless noted), and the quantile mask against
``np.percentile``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from pb_bss_tpu.extraction import beamform_utils as jbu
from pb_bss_tpu.extraction import mask_module as jmm
from pb_bss_tpu_torch.extraction import beamform_utils as tbu
from pb_bss_tpu_torch.extraction import mask_module as tmm

torch.set_num_threads(2)


def _cn(seed, *shape, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _both(name, x, **kwargs):
    ref = np.asarray(getattr(jmm, name)(jnp.asarray(x), **kwargs))
    out = getattr(tmm, name)(torch.as_tensor(x), **kwargs).numpy()
    return out, ref


@pytest.mark.parametrize('name,kwargs', [
    ('ideal_binary_mask', {}),
    ('ideal_binary_mask', dict(sensor_axis=1)),
    ('ideal_binary_mask', dict(sensor_axis=1, keepdims=True)),
    ('ideal_binary_mask', dict(source_axis=1)),
    ('wiener_like_mask', {}),
    ('wiener_like_mask', dict(sensor_axis=1)),
    ('ideal_ratio_mask', {}),
    ('ideal_amplitude_mask', {}),
    ('phase_sensitive_mask', {}),
    ('ideal_complex_mask', {}),
    ('lorenz_mask', {}),
    ('lorenz_mask', dict(axis=-1)),
    ('lorenz_mask', dict(sensor_axis=1, lorenz_fraction=0.9)),
    ('lorenz_mask', dict(sensor_axis=1, keepdims=True)),
    ('quantile_mask', {}),
    ('quantile_mask', dict(quantile=0.3, axis=-1)),
    ('quantile_mask', dict(quantile=-0.45, axis=(-2, -1))),
])
def test_mask_matches_jax(name, kwargs):
    x = _cn(len(name) + len(kwargs), 2, 3, 16, 40)  # (K, D, F, T)
    out, ref = _both(name, x, **kwargs)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    # elementwise f32 in two libraries; the hard decisions exactly
    assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_biased_binary_mask_matches_jax():
    # complex128: the JAX package compares the f32 power with its f64
    # thresholds in f64 (x64), the port in the power's dtype
    x = _cn(3, 2, 30, 513, dtype=np.complex128)  # (speech/noise, T, F)
    out, ref = _both('biased_binary_mask', x)
    assert out.dtype == bool and out.shape == (2, 30, 513)
    assert_array_equal(out, ref)
    assert not out[0, :, :4].any() and out[1, :, :4].all()
    assert not out[0, :, 500:].any() and out[1, :, 500:].all()


def test_masks_reject_a_sensor_axis():
    x = torch.as_tensor(_cn(4, 2, 3, 5))
    for name in ('ideal_ratio_mask', 'ideal_amplitude_mask',
                 'phase_sensitive_mask', 'ideal_complex_mask',
                 'quantile_mask'):
        with pytest.raises(AssertionError):
            getattr(tmm, name)(x, sensor_axis=1)
    with pytest.raises(NotImplementedError):
        tmm.biased_binary_mask(x, sensor_axis=1)


@pytest.mark.parametrize('q', [0.1, 0.3, -0.4, -0.9, 0.0])
def test_quantile_mask_matches_numpy_percentile(q):
    rng = np.random.default_rng(10)
    x = np.abs(rng.standard_normal((5, 41)))
    out = tmm.quantile_mask(torch.as_tensor(x), quantile=q, axis=-1).numpy()
    if q >= 0:
        threshold = np.percentile(x, (1 - q) * 100, axis=-1)
        expected = (x > threshold[:, None]).astype(float)
    else:
        threshold = np.percentile(x, abs(q) * 100, axis=-1)
        expected = (x < threshold[:, None]).astype(float)
    assert_allclose(out, 0.5 + 0.999 * (expected - 0.5))


def test_voiced_unvoiced_split_matches_jax():
    for args in ((257,), (513, 100, 40)):
        for ours, theirs in zip(
                tmm.voiced_unvoiced_split_characteristic(*args),
                jmm.voiced_unvoiced_split_characteristic(*args)):
            assert_array_equal(ours, theirs)


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(6)
    tdoa = rng.uniform(-1e-3, 1e-3, size=(4, 2))
    for normalize in (False, True):
        assert_allclose(
            tbu.get_steering_vector(tdoa, 256, 8000, normalize=normalize),
            jbu.get_steering_vector(tdoa, 256, 8000, normalize=normalize))
    sensors = rng.uniform(-0.1, 0.1, size=(3, 6))
    distances = np.linalg.norm(sensors[:, :, None] - sensors[:, None], axis=0)
    assert_allclose(tbu.get_diffuse_noise_psd(distances, 256, 8000),
                    jbu.get_diffuse_noise_psd(distances, 256, 8000))
    sources = rng.uniform(-2, 2, size=(3, 2))
    assert_allclose(tbu.get_nearfield_time_of_flight(sources, sensors),
                    jbu.get_nearfield_time_of_flight(sources, sensors))
    angles = rng.uniform(-np.pi, np.pi, size=(2, 3))
    for reference_channel in (0, 1):
        assert_allclose(
            tbu.get_farfield_time_difference_of_arrival(
                angles, sensors, reference_channel=reference_channel),
            jbu.get_farfield_time_difference_of_arrival(
                angles, sensors, reference_channel=reference_channel))
