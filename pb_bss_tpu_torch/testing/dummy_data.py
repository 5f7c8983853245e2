"""Deterministic synthetic multi-channel BSS scenarios.

NumPy/SciPy only (no torch, no jax): the same generator as
``pb_bss_tpu.testing.dummy_data``, so both packages see bit-equal
signals from the same seed. 2 speakers, 6 channels, 8 kHz, with
simulated room impulse responses (direct path from distinct directions
+ exponentially decaying diffuse tail) convolved with speech-like
sources (amplitude-modulated, low-pass shaped noise with pauses).

``reverberation_data`` has a 512-tap room response with a long diffuse
tail. Returned dict: ``observation`` (D, T), ``speech_source`` (K, T),
``speech_image`` (K, D, T), ``noise_image`` (D, T), plus
``sample_rate``.

``real_audio_data`` reads the same schema from a local checkout of
pb_test_data named by ``$PB_BSS_TPU_TEST_DATA`` (nothing is
downloaded).
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import scipy.signal

__all__ = ['low_reverberation_data', 'reverberation_data',
           'real_test_data_root', 'real_audio_data']

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


def reverberation_data(seed=1):
    """2-speaker 6-channel scenario with a longer diffuse tail (512-tap
    RIR)."""
    return _scenario(seed, rir_taps=512, decay=180.0, snr_db=15)


# The reference fetches github.com/fgnt/pb_test_data at test time; this
# package never touches the network. Point PB_BSS_TPU_TEST_DATA at a
# local checkout (the repository root holding bss_data/, or bss_data/
# itself) to read its recordings.
_TEST_DATA_ENV = 'PB_BSS_TPU_TEST_DATA'


def real_test_data_root():
    """The bss_data directory of a locally cached pb_test_data
    checkout (from ``$PB_BSS_TPU_TEST_DATA``), or None when absent."""
    root = os.environ.get(_TEST_DATA_ENV)
    if not root:
        return None
    root = Path(root)
    for candidate in (root, root / 'bss_data',
                      root / 'pb_test_data-master' / 'bss_data'):
        if (candidate / 'bss_data.json').is_file():
            return candidate
    return None


def _read_wav(path):
    """(channels-first, float64 in [-1, 1]) like soundfile.read().T;
    scipy's reader when soundfile is not installed."""
    try:
        import soundfile
    except ImportError:
        import scipy.io.wavfile
        _, data = scipy.io.wavfile.read(path)
        if data.dtype.kind == 'i':
            data = data / float(np.iinfo(data.dtype).max + 1)
        elif data.dtype.kind == 'u':  # 8-bit wav is unsigned
            data = (data - 128.0) / 128.0
        return np.asarray(data, np.float64).T
    data, _ = soundfile.read(path)
    return data.T


def _read_audio_tree(obj):
    if isinstance(obj, dict):
        return {k: _read_audio_tree(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return np.array([_read_audio_tree(e) for e in obj])
    return _read_wav(obj)


def real_audio_data(example_id):
    """One example ('low_reverberation' / 'reverberation') of the
    locally cached pb_test_data, in the reference's schema: the json
    entry plus 'audio_data' with observation (D, T), speech_source
    (K, T), speech_image (K, D, T), noise_image (D, T), as NumPy arrays.

    Raises FileNotFoundError when ``$PB_BSS_TPU_TEST_DATA`` does not
    point at a pb_test_data checkout.
    """
    root = real_test_data_root()
    if root is None:
        raise FileNotFoundError(
            f'set ${_TEST_DATA_ENV} to a local pb_test_data checkout '
            f'(https://github.com/fgnt/pb_test_data) to enable '
            f'real-audio tests')
    text = (root / 'bss_data.json').read_text()
    text = text.replace('${DB_DIR}', str(root))
    data = json.loads(text)
    example = data['datasets']['test'][example_id]
    example = dict(example, example_id=example_id)
    example['audio_data'] = _read_audio_tree(example['audio_path'])
    example['sample_rate'] = SAMPLE_RATE
    return example
