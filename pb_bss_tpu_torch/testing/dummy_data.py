"""Deterministic synthetic multi-channel BSS scenarios.

NumPy/SciPy only (no torch, no jax): the same generator as
``pb_bss_tpu.testing.dummy_data``, so both packages see bit-equal
signals from the same seed. 2 speakers, 6 channels, 8 kHz, with
simulated room impulse responses (direct path from distinct directions
+ exponentially decaying diffuse tail) convolved with speech-like
sources (amplitude-modulated, low-pass shaped noise with pauses).

Returned dict: ``observation`` (D, T), ``speech_source`` (K, T),
``speech_image`` (K, D, T), ``noise_image`` (D, T), plus
``sample_rate``.
"""
from __future__ import annotations

import numpy as np
import scipy.signal

__all__ = ['low_reverberation_data']

SAMPLE_RATE = 8000
NUM_SAMPLES = 38520
K, D = 2, 6


def _speech_like_source(rng, samples, sample_rate):
    """Speech surrogate: low-pass-shaped noise with syllabic (4 Hz)
    amplitude modulation and pauses."""
    x = rng.randn(samples)
    a = 0.9
    x = scipy.signal.lfilter([1 - a], [1, -a], x)
    x = scipy.signal.lfilter([1 - a], [1, -a], x)
    t = np.arange(samples) / sample_rate
    envelope = np.clip(
        np.sin(2 * np.pi * 3.1 * t + rng.uniform(0, 2 * np.pi)), 0, None
    ) + 0.1
    gate = (np.sin(2 * np.pi * 0.37 * t + rng.uniform(0, 2 * np.pi))
            > -0.7).astype(float)
    x = x * envelope * gate
    return x / np.maximum(np.std(x), 1e-10)


def _rir(rng, taps, direct_delay, decay):
    """Direct path + exponentially decaying diffuse tail."""
    h = np.zeros(taps)
    h[direct_delay] = 1.0
    tail = rng.randn(taps - direct_delay - 1) * np.exp(
        -np.arange(taps - direct_delay - 1) / decay)
    h[direct_delay + 1:] += 0.3 * tail
    return h


def _scenario(seed, rir_taps, decay, snr_db=15):
    rng = np.random.RandomState(seed)
    sources = np.stack([
        _speech_like_source(rng, NUM_SAMPLES, SAMPLE_RATE)
        for _ in range(K)
    ])
    # distinct direct-path delays per speaker simulate distinct
    # directions of arrival
    speech_image = np.zeros((K, D, NUM_SAMPLES))
    for k in range(K):
        base_delay = 8 + 5 * k
        for d in range(D):
            delay = base_delay + int(round(
                3 * np.sin(2 * np.pi * (d / D) + k * 2.2)))
            h = _rir(rng, rir_taps, max(delay, 0), decay)
            speech_image[k, d] = np.convolve(
                sources[k], h)[:NUM_SAMPLES]

    signal_power = np.mean(speech_image.sum(0) ** 2)
    noise = rng.randn(D, NUM_SAMPLES)
    noise *= np.sqrt(
        signal_power / np.mean(noise ** 2) * 10 ** (-snr_db / 10))

    observation = speech_image.sum(0) + noise
    audio_data = {
        'observation': observation,
        'speech_source': sources,
        'speech_image': speech_image,
        'noise_image': noise,
    }
    return {**audio_data, 'audio_data': audio_data,
            'sample_rate': SAMPLE_RATE}


def low_reverberation_data(seed=0):
    """2-speaker 6-channel scenario with a short RIR (mostly direct
    path)."""
    return _scenario(seed, rir_taps=64, decay=12.0, snr_db=20)
