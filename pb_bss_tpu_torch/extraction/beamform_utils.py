"""Array-geometry helpers for beamforming (counterpart of
``pb_bss_tpu.extraction.beamform_utils``): steering vectors from the
TDoA, the diffuse-noise spatial coherence, the near-field time of flight
and the far-field TDoA from the geometry. Set-up helpers in numpy (no
hot path), as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from ..utils import get_stft_center_frequencies

__all__ = [
    'get_steering_vector',
    'get_diffuse_noise_psd',
    'get_nearfield_time_of_flight',
    'get_farfield_time_difference_of_arrival',
]


def _angle_to_rotation_matrix(rotation_angles):
    """Rotation matrix from (azimuth, elevation)."""
    azimuth = rotation_angles[0]
    elevation = rotation_angles[1]

    rotate_y = np.asarray([
        [np.cos(-elevation), 0, np.sin(-elevation)],
        [0, 1, 0],
        [-np.sin(-elevation), 0, np.cos(-elevation)],
    ])
    rotate_z = np.asarray([
        [np.cos(azimuth), -np.sin(azimuth), 0],
        [np.sin(azimuth), np.cos(azimuth), 0],
        [0, 0, 1],
    ])
    return rotate_y @ rotate_z


def get_steering_vector(
        time_difference_of_arrival,
        stft_size=1024,
        sample_rate=16000,
        normalize=False,
):
    """Analytic steering vector from TDoA.

    Returns shape ``time_difference_of_arrival.shape + (F,)``.
    """
    center_frequencies = get_stft_center_frequencies(stft_size, sample_rate)
    steering_vector = np.exp(
        -2j * np.pi
        * center_frequencies
        * np.asarray(time_difference_of_arrival)[..., None]
    )
    if normalize:
        steering_vector = steering_vector / np.linalg.norm(
            steering_vector, axis=-2, keepdims=True)
    return steering_vector


def get_diffuse_noise_psd(
        sensor_distances,
        fft_size=1024,
        sample_rate=16000,
        sound_velocity=343,
):
    """Spatial coherence of a spherically isotropic field
    [Bitzer & Simmer 2001, Eq. 2.17].

    Args:
        sensor_distances: (D, D) pairwise distances in meters.
    Returns:
        (F, D, D) coherence matrices.
    """
    f = get_stft_center_frequencies(size=fft_size, sample_rate=sample_rate)
    return np.sinc(
        2.0 * f[:, None, None]
        * np.asarray(sensor_distances)[None, :, :]
        / sound_velocity
    )


def get_nearfield_time_of_flight(
        source_positions, sensor_positions, sound_velocity=343):
    """Exact time of flight without far-field assumption.

    Args:
        source_positions: (3, K) column vectors.
        sensor_positions: (3, D) column vectors.
    Returns:
        (K, D) time of flight in seconds.
    """
    source_positions = np.asarray(source_positions)
    sensor_positions = np.asarray(sensor_positions)
    assert source_positions.shape[0] == 3
    assert sensor_positions.shape[0] == 3
    difference = source_positions[:, :, None] - sensor_positions[:, None, :]
    difference = np.linalg.norm(difference, axis=0)
    return np.asarray(difference / sound_velocity)


def get_farfield_time_difference_of_arrival(
        source_angles,
        sensor_positions,
        reference_channel=1,
        sound_velocity=343.,
):
    """Far-field TDoA for planar waves.

    Args:
        source_angles: (2, K) azimuth/elevation in radians.
        sensor_positions: (3, D).
        reference_channel: index of the reference microphone.
    Returns:
        (D, K) time differences of arrival in seconds.
    """
    source_angles = np.asarray(source_angles)
    sensor_positions = np.asarray(sensor_positions)
    sensors = sensor_positions.shape[1]
    angles = source_angles.shape[1]

    sensor_distance_vector = (
        sensor_positions - sensor_positions[:, reference_channel, None])
    source_direction_vector = np.zeros([3, angles])
    for k in range(angles):
        source_direction_vector[:, k] = (
            -_angle_to_rotation_matrix(source_angles[:, k])
            @ np.eye(N=3, M=1)
        )[:, 0]

    projected_distance = np.zeros([sensors, angles])
    for s in range(sensors):
        projected_distance[s, :] = (
            sensor_distance_vector[:, s] @ source_direction_vector)
    return projected_distance / sound_velocity
