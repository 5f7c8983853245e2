"""A run's check at a size the CPU holds: sound runs pass, the control
(the reference in TF32 in the program's place) fails, and so does a run
with the timed path broken underneath, once for each fault a separation
cell can have. The look for a card is skipped (``runner.run`` on the
CPU, where the program runs its plain versions of the kernels); the
limits are the cell's own."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from small import cell
from sepbench.harness import readings, runner

SEED = 2 ** 31 + 1234


def _run(name='utt.b512'):
    torch.manual_seed(0)
    return runner.run(cell(name), SEED, 0.5, False, torch=torch,
                      device=torch.device('cpu'),
                      process_start=time.time(), log=lambda line: None)


def _failed(result):
    return [name for name, row in result['checks'].items()
            if not isinstance(row['value'], float)
            or not row['value'] <= row['limit']]


@pytest.mark.parametrize('name', ['utt.b512', 'minute.b64'])
def test_a_sound_run_is_correct(name):
    kwargs = {} if name == 'utt.b512' else dict(samples=80000, pieces=3)
    c = cell(name, batch=1, **kwargs) if kwargs else cell(name)
    result = runner.run(c, SEED, 0.5, False, torch=torch,
                        device=torch.device('cpu'),
                        process_start=time.time(), log=lambda line: None)
    assert result['correct'], result['checks']
    assert list(result)[-1] == 'checks'
    assert result['failed'] == 0 and result['attempted'] >= c.traffic['batch']


def test_the_control_is_not_correct():
    c = cell()
    numbers = readings.control(c, SEED, 1, torch, torch.device('cpu'))
    failed = [n for n, limit in c.spec['limits'].items()
              if numbers[n] > limit]
    assert failed, numbers


def test_em_that_returns_its_state_unchanged(monkeypatch):
    from pb_bss_tpu_torch.models import cacgmm

    def unchanged(self, y, initialization=None, *args, **kwargs):
        return None, torch.as_tensor(initialization)
    monkeypatch.setattr(cacgmm.CACGMMTrainer, 'fit_predict_model',
                        unchanged)
    result = _run()
    assert not result['correct'] and 'em_gap' in _failed(result)


def test_half_of_the_batch_left_out(monkeypatch):
    from pb_bss_tpu_torch import pipeline
    separate = pipeline._separate

    def half(observations, initialization, **kwargs):
        keep = observations.shape[0] // 2
        out = separate(observations[:keep], initialization[:keep],
                       **kwargs)
        return torch.cat([out, out])[:observations.shape[0]]
    monkeypatch.setattr(pipeline, '_separate', half)
    result = _run()
    assert not result['correct'], result['checks']


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from pb_bss_tpu_torch import pipeline
    istft = pipeline.istft

    def altered(*args, **kwargs):
        out = istft(*args, **kwargs).clone()
        out[0, 0] += 1e-3 * out[0, 0].std()
        return out
    monkeypatch.setattr(pipeline, 'istft', altered)
    result = _run()
    assert not result['correct'] and 'istft_gap' in _failed(result)


def test_a_fault_in_a_band_of_bins(monkeypatch):
    # the upper two fifths of the bins of every beamformed spectrum off
    # by 1%: a fault that a median over the bins would pass
    from pb_bss_tpu_torch import pipeline
    apply = pipeline.apply_beamforming_vector

    def banded(*args, **kwargs):
        out = apply(*args, **kwargs).clone()  # (B, K, F, T)
        out[..., out.shape[-2] * 3 // 5:, :] *= 1.01
        return out
    monkeypatch.setattr(pipeline, 'apply_beamforming_vector', banded)
    result = _run()
    assert not result['correct'] and 'extract_gap' in _failed(result)


def _score_run():
    return runner.run(cell('score.b512', iterations=80), SEED, 0.3, False,
                      torch=torch, device=torch.device('cpu'),
                      process_start=time.time(), log=lambda line: None)


def test_a_sound_scoring_run_is_correct():
    result = _score_run()
    assert result['correct'], result['checks']


def test_scoring_half_of_the_batch_left_out(monkeypatch):
    from pb_bss_tpu_torch.evaluation import batch_wrapper
    fused = batch_wrapper.bss_eval_stoi_fused_batch

    def half(reference, estimation, **kwargs):
        keep = reference.shape[0] // 2
        out = fused(reference[:keep], estimation[:keep], **kwargs)
        return {k: np.concatenate([v, v])[:reference.shape[0]]
                for k, v in out.items()}
    monkeypatch.setattr(batch_wrapper, 'bss_eval_stoi_fused_batch', half)
    assert not _score_run()['correct']


@pytest.mark.parametrize('key, delta', [('sdr', 2.0), ('stoi', 1e-4)])
def test_scoring_answer_altered_where_it_is_produced(monkeypatch, key,
                                                     delta):
    from pb_bss_tpu_torch.evaluation import batch_wrapper
    fused = batch_wrapper.bss_eval_stoi_fused_batch

    def altered(*args, **kwargs):
        out = dict(fused(*args, **kwargs))
        out[key] = np.array(out[key], copy=True)
        out[key][0, 0] += delta
        return out
    monkeypatch.setattr(batch_wrapper, 'bss_eval_stoi_fused_batch', altered)
    result = _score_run()
    assert not result['correct'] and f'{key}_gap' in _failed(result)
