"""The copied scenario generator, the pools a seed makes, and the
counts of work."""
from __future__ import annotations

import math

import numpy as np
import pytest

from small import cell
from sepbench.harness import counts, runner, traffic


@pytest.mark.parametrize('seed', [0, 2 ** 32 - 5])
def test_generator_equals_the_programs_bit_for_bit(seed):
    from pb_bss_tpu_torch.testing import dummy_data
    want = dummy_data.low_reverberation_data(seed)
    got = traffic.scenario(seed)
    for key in ('observation', 'speech_source', 'speech_image',
                'noise_image'):
        assert np.array_equal(got[key], want[key]), key


def test_pool_is_made_from_the_seed():
    c = cell('minute.b64', samples=50000, pieces=2, batch=1)
    traffic_ = dict(c.traffic, pool_batches=2)
    a = traffic.pool(c.config, traffic_, 2 ** 31 + 11)
    b = traffic.pool(c.config, traffic_, 2 ** 31 + 11)
    other = traffic.pool(c.config, traffic_, 2 ** 31 + 12)
    assert a.shape == (2, 1, 6, 50000) and a.dtype == np.float32
    assert np.array_equal(a, b) and not np.array_equal(a, other)
    # two joined scenarios, cut to the recording's length
    seeds = traffic.scenario_seeds(2 ** 31 + 11, 4)
    first = traffic.scenario(seeds[0])['observation']
    second = traffic.scenario(seeds[1])['observation']
    joined = np.concatenate([first, second], -1)[:, :50000]
    assert np.array_equal(a[0, 0], joined.astype(np.float32))
    assert len(set(seeds)) == 4


def test_threads_make_the_scenarios_of_one_thread():
    seeds = traffic.scenario_seeds(2 ** 31 + 5, 5)
    got = traffic.scenarios(seeds, lambda scene: scene['observation'])
    for seed, observation in zip(seeds, got):
        assert np.array_equal(observation,
                              traffic.scenario(seed)['observation'])


def test_checked_rows_are_drawn_from_the_seed():
    rows = runner.sample_rows(2 ** 33 + 1, 7, 512, 16)
    assert rows == runner.sample_rows(2 ** 33 + 1, 7, 512, 16)
    assert rows != runner.sample_rows(2 ** 33 + 1, 8, 512, 16)
    assert rows == sorted(set(rows)) and len(rows) == 16
    assert 0 <= rows[0] and rows[-1] < 512
    assert runner.sample_rows(1, 0, 4, 16) == [0, 1, 2, 3]
    assert runner.sample_rows(1, 0, 4, None) == [0, 1, 2, 3]


def test_frames_match_the_programs_stft():
    from pb_bss_tpu_torch.transform.stft_module import stft_frames
    for name in ('utt.b512', 'minute.b64'):
        config = cell(name).config
        assert counts.frames(config) == stft_frames(
            config['samples'], config['stft_size'], config['stft_shift'])
    assert counts.frames(cell('utt.b512').config) == 304
    assert counts.frames(cell('minute.b64').config) == 3753


def test_counts_by_hand():
    # D=2: P=3; projection form 8*4 + 3*2 = 38, +10 = 48 for the E-step,
    # 4*3 = 12 for the scatter, per frame 3*2 + 6*(3-2) = 12 shared
    assert counts.em_flops(1, 1, 2) == 12 + 48 + 12
    assert counts.em_flops(10, 3, 2) == 10 * (12 + 3 * 60)
    assert counts.em_flops(1, 1, 2, e_step=False) == 12 + 12
    # one rotation of a 2x2: 1 pair, 60*2 + 30 = 150 per sweep
    assert counts.jacobi_flops(1, 2, 1) == 150
    assert counts.jacobi_flops(4, 3, 2) == 4 * 2 * 3 * 210
    assert counts.fft_flops(8, 2) == 2 * 2.5 * 8 * 3
    assert counts.bound(3.35e12, 0) == (1e3, 'bytes')
    assert counts.bound(0, 67e12) == (1e3, 'operations')
    import torch
    assert counts.nbytes(torch.zeros(3), None,
                         torch.zeros(2, dtype=torch.complex64)) == 12 + 16


def test_em_work_of_a_small_fit():
    config = dict(channels=2, num_classes=1, iterations=3, stft_size=2,
                  stft_shift=1, samples=1)
    # F = 2 bins, T = ceil((1 + 2 - 2 + 1) / 1) = 2 frames, batch 1
    assert counts.frames(config) == 2
    flops, moved = counts.em_work(config, 1)
    n, T = 2, 2
    want = 3 * counts.em_flops(n * T, 1, 2) \
        + counts.jacobi_flops(n, 2, 6) \
        + 2 * (counts.jacobi_flops(n, 2, 2) + n * 16 * 8)
    assert flops == want
    assert moved == n * T * 2 * 8 + 2 * n * T * 4 + n * (1 + 2 + 8) * 4
    assert math.isclose(counts.separation_flops(config, 1), flops
                        + counts.fft_flops(2, 2 * 2) + counts.fft_flops(2, 2)
                        + n * T * (6 + 6 + 12)
                        + n * (8 * (8 / 3 + 8 + 4))
                        + counts.jacobi_flops(n, 2, 6)
                        + n * T * 16)
