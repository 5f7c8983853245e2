"""The traffic generator: SMS-WSJ-shaped multichannel scenarios from a
seed, joined into recordings and grouped into batches.

The scenario generator is a copy of the system's numpy-only test
scenarios (2 speakers, 6 channels, 8 kHz, simulated room responses and
white noise; ``pb_bss_tpu_torch.testing.dummy_data``), kept here so
that the yardstick cannot move with the program. A traffic file
(``sepbench/traffic/<name>.json``) and a configuration file
(``sepbench/configs/<name>.json``) give the parameters; nothing here
names a cell.
"""
from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import scipy.signal

# set-up makes many scenarios; numpy and scipy release the GIL in the
# filters, the convolutions and the draws, so a few threads divide the
# time (each scenario has its own generator: the order does not matter)
THREADS = min(8, os.cpu_count() or 1)


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


def scenario(seed, *, speakers=2, channels=6, samples=38520,
             sample_rate=8000, rir_taps=64, decay=12.0, snr_db=20):
    """One scenario: {'observation': (D, N), 'speech_source': (K, N),
    'speech_image': (K, D, N), 'noise_image': (D, N)}. The defaults are
    the low-reverberation scenario."""
    rng = np.random.RandomState(seed)
    sources = np.stack([
        _speech_like_source(rng, samples, sample_rate)
        for _ in range(speakers)])
    # distinct direct-path delays per speaker simulate distinct
    # directions of arrival
    speech_image = np.zeros((speakers, channels, samples))
    for k in range(speakers):
        base_delay = 8 + 5 * k
        for d in range(channels):
            delay = base_delay + int(round(
                3 * np.sin(2 * np.pi * (d / channels) + k * 2.2)))
            h = _rir(rng, rir_taps, max(delay, 0), decay)
            speech_image[k, d] = np.convolve(sources[k], h)[:samples]
    signal_power = np.mean(speech_image.sum(0) ** 2)
    noise = rng.randn(channels, samples)
    noise *= np.sqrt(
        signal_power / np.mean(noise ** 2) * 10 ** (-snr_db / 10))
    return {'observation': speech_image.sum(0) + noise,
            'speech_source': sources, 'speech_image': speech_image,
            'noise_image': noise}


def scenario_seeds(seed, count):
    """``count`` distinct 32-bit scenario seeds drawn from a run's seed
    (any non-negative integer)."""
    return [int(s) for s in
            np.random.SeedSequence(int(seed)).generate_state(count)]


def scenario_kwargs(config):
    """The scenario parameters a configuration file fixes."""
    keys = ('speakers', 'channels', 'sample_rate', 'rir_taps', 'decay',
            'snr_db')
    kwargs = {key: config[key] for key in keys}
    kwargs['samples'] = config['scenario_samples']
    return kwargs


def scenarios(seeds, pick, **kwargs):
    """[pick(scenario(s, **kwargs)) for s in seeds], made by a few
    threads; ``pick`` keeps what is needed, so that a large pool does not
    hold every scenario's images."""
    with concurrent.futures.ThreadPoolExecutor(THREADS) as threads:
        return list(threads.map(lambda s: pick(scenario(s, **kwargs)),
                                seeds))


def recordings(config, seeds):
    """(len(seeds) // pieces, D, samples) float32 observations: every
    ``pieces`` consecutive scenarios joined and cut to the recording
    length. The direct-path delays depend only on the speaker and the
    channel, so the speakers stand still across the joins."""
    pieces, samples = config['pieces'], config['samples']
    made = scenarios(seeds[:len(seeds) // pieces * pieces],
                     lambda scene: scene['observation'],
                     **scenario_kwargs(config))
    out = np.empty((len(made) // pieces, config['channels'], samples),
                   np.float32)
    for r in range(len(out)):
        parts = made[r * pieces:(r + 1) * pieces]
        out[r] = np.concatenate(parts, -1)[:, :samples]
    return out


def pool(config, traffic, seed):
    """(pool_batches, batch, D, samples) float32: the batches a closed
    loop cycles through, every recording distinct."""
    count = traffic['pool_batches'] * traffic['batch']
    seeds = scenario_seeds(seed, count * config['pieces'])
    rec = recordings(config, seeds)
    return rec.reshape(traffic['pool_batches'], traffic['batch'],
                       *rec.shape[1:])


__all__ = ['scenario', 'scenarios', 'scenario_seeds', 'recordings', 'pool']
