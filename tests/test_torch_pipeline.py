"""separate / separate_batch / the CLI of the port against the JAX
package on a shortened dummy scenario (2 s, F=257, D=6, K=3).

The two packages draw their EM initializations from different random
streams, so fits are held by separation quality (rule a of ROADMAP
queue 3), not sample by sample."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from pb_bss_tpu.pipeline import separate as jax_separate
from pb_bss_tpu.testing.dummy_data import low_reverberation_data
from pb_bss_tpu_torch import cli, separate, separate_batch
from pb_bss_tpu_torch.evaluation import si_sdr, si_sdr_stft
from pb_bss_tpu_torch.ops.em_loop import cacgmm_em_full
from pb_bss_tpu_torch.ops.gev import gev
from pb_bss_tpu_torch.pipeline import utterance_generators

torch.set_num_threads(2)

NUM_SAMPLES = 16000
ITERATIONS = 10


@pytest.fixture(scope='module')
def scenario():
    data = low_reverberation_data(1)
    observation = data['observation'][:, :NUM_SAMPLES].astype(np.float32)
    images = torch.as_tensor(data['speech_image'][:, 0, :NUM_SAMPLES])
    return observation, images


@pytest.mark.parametrize('beamformer,metric', [
    (None, si_sdr), ('gev+ban', si_sdr_stft)])
def test_separate_quality_matches_jax(scenario, beamformer, metric):
    observation, images = scenario
    out = separate(torch.as_tensor(observation), iterations=ITERATIONS,
                   beamformer=beamformer)
    assert out.shape == (3, NUM_SAMPLES) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    ref = np.array(jax_separate(jnp.asarray(observation),
                                iterations=ITERATIONS,
                                beamformer=beamformer))
    ours = metric(images[:, None], out[None].double()).max(-1).values
    theirs = metric(images[:, None],
                    torch.as_tensor(ref)[None].double()).max(-1).values
    # best estimate per speaker: measured within 1.2 dB of each other
    # here; different random initializations, so allow 3 dB
    assert ((ours - theirs).abs() < 3.0).all(), (ours, theirs)
    assert (ours > 5.0).all(), ours


def test_separate_batch_equals_separate_per_utterance(scenario):
    observation, _ = scenario
    observations = torch.stack([
        torch.as_tensor(observation[:, :8000]),
        torch.as_tensor(observation[:, 8000:])])
    batched = separate_batch(observations, iterations=5,
                             beamformer='gev+ban')
    generators = utterance_generators(torch.Generator().manual_seed(0), 2,
                                      'cpu')
    for i in range(2):
        single = separate(observations[i], iterations=5,
                          beamformer='gev+ban', generator=generators[i])
        # same initialization; batched vs unbatched f32 products only
        torch.testing.assert_close(batched[i], single, atol=1e-4,
                                   rtol=1e-3)


def test_cpu_run_launches_no_kernel(scenario):
    observation, _ = scenario
    before = (cacgmm_em_full.launches, gev.launches)
    separate(torch.as_tensor(observation[:, :4000]), iterations=2,
             beamformer='gev+ban')
    assert (cacgmm_em_full.launches, gev.launches) == before


def test_unported_options_raise(scenario):
    observation = torch.as_tensor(scenario[0][:, :2000])
    for kwargs in (dict(model='cwmm'), dict(refine='fca'),
                   dict(beamformer='mvdr_souden')):
        with pytest.raises(NotImplementedError):
            separate(observation, iterations=1, **kwargs)


def test_cli_on_cpu(scenario, tmp_path):
    observation, _ = scenario
    wav = tmp_path / 'mix.wav'
    wavfile.write(wav, 8000, (observation[:, :8000].T
                              / np.abs(observation).max() * 20000
                              ).astype(np.int16))
    paths = cli.main([str(wav), '-k', '3', '-b', 'gev+ban', '-i', '3',
                      '-o', str(tmp_path / 'out'), '--device', 'cpu'])
    assert len(paths) == 3
    for path in paths:
        rate, data = wavfile.read(path)
        assert rate == 8000 and data.shape == (8000,)
        assert np.abs(data).max() > 0


def test_cli_refuses_a_missing_gpu(scenario, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    wav = tmp_path / 'mix.wav'
    wavfile.write(wav, 8000, np.zeros((100, 6), np.int16))
    with pytest.raises(SystemExit, match='no CUDA device'):
        cli.main([str(wav)])
