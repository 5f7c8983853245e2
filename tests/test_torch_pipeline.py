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
from pb_bss_tpu_torch.ops.eigh import eigh_jacobi
from pb_bss_tpu_torch.ops.em_loop import cacgmm_em_full
from pb_bss_tpu_torch.ops.gev import gev
from pb_bss_tpu_torch.pipeline import (
    _init_shape,
    _separate,
    utterance_generators,
)

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


@pytest.mark.parametrize('beamformer,metric', [
    (None, si_sdr), ('gev+ban', si_sdr_stft)])
def test_separate_cwmm_quality_matches_jax(scenario, beamformer, metric):
    """model='cwmm': the complex Watson mixture in place of the cACGMM,
    held like the cACGMM path by the best estimate per speaker."""
    observation, images = scenario
    out = separate(torch.as_tensor(observation), iterations=ITERATIONS,
                   beamformer=beamformer, model='cwmm')
    assert out.shape == (3, NUM_SAMPLES) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    ref = np.array(jax_separate(jnp.asarray(observation),
                                iterations=ITERATIONS, beamformer=beamformer,
                                model='cwmm'))
    ours = metric(images[:, None], out[None].double()).max(-1).values
    theirs = metric(images[:, None],
                    torch.as_tensor(ref)[None].double()).max(-1).values
    # measured within 1.1 dB of each other here; different random
    # initializations, so allow 3 dB
    assert ((ours - theirs).abs() < 3.0).all(), (ours, theirs)
    assert (ours > 5.0).all(), ours


@pytest.mark.parametrize('options,metric', [
    (dict(beamformer='mvdr_souden+ban'), si_sdr_stft),
    (dict(beamformer='rank1_gev+mvdr_souden+ban'), si_sdr_stft),
    (dict(refine='fca'), si_sdr)])
def test_separate_matches_jax_from_its_initialization(scenario, options,
                                                      metric):
    """The extraction routes of this slice from the JAX package's own EM
    initialization (``jax.random.uniform`` at ``key(0)``, as its
    ``separate`` draws it) through the port's pipeline: the same EM, the
    same masks, the same beamformer or FCA refinement, so the quality
    agrees to a hundredth of a dB (measured: within 0.01 dB)."""
    import jax
    observation, images = scenario
    obs = torch.as_tensor(observation)
    init = np.asarray(jax.random.uniform(
        jax.random.key(0), _init_shape(obs, 3, 512, 128), jnp.float32))
    init = torch.as_tensor(init / init.sum(-2, keepdims=True))
    kwargs = dict(beamformer=None, refine=None, refine_iterations=20)
    kwargs.update(options)
    out = _separate(obs[None], init[None], iterations=ITERATIONS,
                    stft_size=512, stft_shift=128, reference_channel=0,
                    eigh_sweeps=None, model='cacgmm', **kwargs)[0]
    assert out.shape == (3, NUM_SAMPLES) and torch.isfinite(out).all()
    ref = np.array(jax_separate(jnp.asarray(observation),
                                iterations=ITERATIONS, **options))
    ours = metric(images[:, None], out[None].double()).max(-1).values
    theirs = metric(images[:, None],
                    torch.as_tensor(ref)[None].double()).max(-1).values
    assert ((ours - theirs).abs() < 0.1).all(), (ours, theirs)


def _check_batch_equals_single(observation, model, **options):
    options = options or dict(beamformer='gev+ban')
    observations = torch.stack([
        torch.as_tensor(observation[:, :8000]),
        torch.as_tensor(observation[:, 8000:])])
    batched = separate_batch(observations, iterations=5, model=model,
                             **options)
    generators = utterance_generators(torch.Generator().manual_seed(0), 2,
                                      'cpu')
    for i in range(2):
        single = separate(observations[i], iterations=5,
                          generator=generators[i], model=model, **options)
        # same initialization; batched vs unbatched f32 products only
        torch.testing.assert_close(batched[i], single, atol=1e-4,
                                   rtol=1e-3)


def test_separate_batch_equals_separate_per_utterance(scenario):
    _check_batch_equals_single(scenario[0], 'cacgmm')


def test_separate_batch_cwmm_equals_separate_per_utterance(scenario):
    _check_batch_equals_single(scenario[0], 'cwmm')


@pytest.mark.parametrize('options', [
    dict(beamformer='mvdr_souden+ban'), dict(beamformer='wmwf'),
    dict(refine='fca', refine_iterations=3)])
def test_separate_batch_extraction_equals_separate_per_utterance(scenario,
                                                                 options):
    """The batched call picks the MVDR-Souden / wMWF reference channel
    per utterance and class, and folds the batch into FCA's bins: each
    utterance's output equals its separate()."""
    _check_batch_equals_single(scenario[0], 'cacgmm', **options)


def test_separate_cbmm_runs_on_the_cpu_with_no_launch(scenario):
    """model='cbmm': the complex Bingham mixture in place of the cACGMM.
    On a CPU tensor the scan path runs and no kernel launches; a batch of
    one equals its separate() (a short utterance, two iterations: the
    scan path's cold moment inversion over 771 problems dominates)."""
    from pb_bss_tpu_torch.ops.bingham import bingham_chord_solve
    from pb_bss_tpu_torch.ops.cbmm_loop import cbmm_em_full
    from pb_bss_tpu_torch.ops.mm_stream import mm_stats

    def counts():
        return (cbmm_em_full.launches, mm_stats.launches,
                bingham_chord_solve.launches, gev.launches)
    before = counts()
    observations = torch.as_tensor(scenario[0][None, :, :2000])
    batched = separate_batch(observations, iterations=2,
                             beamformer='gev+ban', model='cbmm')
    assert batched.shape == (1, 3, 2000) and torch.isfinite(batched).all()
    generator = utterance_generators(torch.Generator().manual_seed(0), 1,
                                     'cpu')[0]
    single = separate(observations[0], iterations=2, beamformer='gev+ban',
                      generator=generator, model='cbmm')
    # same initialization; batched vs unbatched f32 products only
    torch.testing.assert_close(batched[0], single, atol=1e-4, rtol=1e-3)
    assert counts() == before


def test_cpu_run_launches_no_kernel(scenario):
    observation, _ = scenario

    def counts():
        return cacgmm_em_full.launches, gev.launches, eigh_jacobi.launches
    before = counts()
    for options in (dict(beamformer='gev+ban'),
                    dict(beamformer='rank1_pca+mvdr_souden'),
                    dict(refine='fca', refine_iterations=1)):
        separate(torch.as_tensor(observation[:, :4000]), iterations=2,
                 **options)
    assert counts() == before


def test_unported_options_raise(scenario):
    """A mesh that is not a DeviceMesh raises TypeError; an unknown
    beamformer or refine stage raises ValueError and LCMV fails its
    assert, before any work, as in the JAX package."""
    observation = torch.as_tensor(scenario[0][:, :2000])
    with pytest.raises(TypeError, match='DeviceMesh'):
        separate(observation, iterations=1, mesh='f')
    for kwargs in (dict(beamformer='mvdr_soudem'), dict(refine='nmf'),
                   dict(refine='fca', beamformer='gev+ban')):
        with pytest.raises(ValueError):
            separate(observation, iterations=1, **kwargs)
        with pytest.raises(ValueError):
            jax_separate(jnp.asarray(observation.numpy()), iterations=1,
                         **kwargs)
    with pytest.raises(AssertionError, match='LCMV'):
        separate_batch(observation[None], iterations=1, beamformer='lcmv')


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


@pytest.mark.slow
def test_cwmm_quality_on_the_smoke_utterances(capsys):
    """The numbers behind chip_smoke.py's CWMM floors: separate_batch(
    model='cwmm') of the smoke's eight 4.8 s utterances (20 iterations,
    'gev+ban') on the CPU, beside JAX's separate(model='cwmm') on each.
    Per-frequency SI-SDR of the best estimate per speaker."""
    from pb_bss_tpu_torch.testing import low_reverberation_data as data_of
    data = [data_of(seed=s) for s in range(8)]
    observations = np.stack([d['observation'] for d in data]).astype(
        np.float32)
    images = torch.as_tensor(np.stack([d['speech_image'][:, 0]
                                       for d in data]))
    ours = separate_batch(torch.as_tensor(observations), iterations=20,
                          beamformer='gev+ban', model='cwmm')
    theirs = torch.stack([torch.as_tensor(np.array(jax_separate(
        jnp.asarray(o), iterations=20, beamformer='gev+ban', model='cwmm')))
        for o in observations])
    scores = {name: si_sdr_stft(images[:, :, None],
                                out.double()[:, None]).max(-1).values
              for name, out in (('port', ours), ('jax', theirs))}
    with capsys.disabled():
        for name, s in scores.items():
            print(f'\n{name}: per speaker {s.numpy().round(2).tolist()}; '
                  f'batch means {s.mean(0).numpy().round(2).tolist()}; '
                  f'worst {s.min().item():.2f} dB')
    assert ((scores['port'].mean(0) - scores['jax'].mean(0)).abs()
            < 3.0).all()
    # chip_smoke.py's floors (CWMM_MEAN_FLOOR_DB, CWMM_SINGLE_FLOOR_DB)
    # sit below the port's numbers here
    assert (scores['port'].mean(0) >= 4.5).all()
    assert (scores['port'] >= -3.0).all()


@pytest.mark.slow
def test_cbmm_quality_on_the_smoke_utterances(capsys):
    """The numbers behind chip_smoke.py's CBMM floors on the smoke's eight
    4.8 s utterances (20 iterations, 'gev+ban'): separate_batch(model=
    'cbmm') from its random initialization on the CPU, beside JAX's
    separate(model='cbmm') on each utterance, and the warm-start recipe
    (the CBMM fit from cACGMM posteriors) with its random-start control
    (pb_bss_tpu_torch.testing.cbmm_quality). Per-frequency SI-SDR of the
    best estimate per speaker."""
    from pb_bss_tpu_torch.testing.cbmm_quality import (
        MEAN_FLOOR_DB, SINGLE_FLOOR_DB, WARM_MEAN_FLOOR_DB,
        WARM_SINGLE_FLOOR_DB, cbmm_quality, utterances)
    observations, images = utterances()
    ours = separate_batch(observations, iterations=20, beamformer='gev+ban',
                          model='cbmm')
    theirs = torch.stack([torch.as_tensor(np.array(jax_separate(
        jnp.asarray(o.numpy()), iterations=20, beamformer='gev+ban',
        model='cbmm'))) for o in observations])
    scores = {name: si_sdr_stft(images[:, :, None],
                                out.double()[:, None]).max(-1).values
              for name, out in (('port', ours), ('jax', theirs))}
    for recipe in ('random', 'warm'):
        scores[f'port {recipe} recipe'] = cbmm_quality(
            observations, images, recipe)
    with capsys.disabled():
        for name, s in scores.items():
            finite = torch.isfinite(s).all(-1)
            print(f'\n{name}: per speaker {s.numpy().round(2).tolist()}; '
                  f'{int(finite.sum())} finite, their means '
                  f'{s[finite].mean(0).numpy().round(2).tolist()}; worst '
                  f'{s[finite].min().item():.2f} dB')
    # a bin where one class takes every frame leaves the others' noise
    # PSD exactly 0 and its GEV vector non-finite, in both packages
    # (ROADMAP queue 3); chip_smoke.py's floors sit below the port's
    # numbers here: the random start's (MEAN_FLOOR_DB, SINGLE_FLOOR_DB)
    # over its finite utterances only catch a broken path; the warm
    # recipe's (WARM_MEAN_FLOOR_DB, WARM_SINGLE_FLOOR_DB) sit above its
    # control
    port = scores['port'][torch.isfinite(scores['port']).all(-1)]
    assert len(port) >= 5
    assert (port.mean(0) >= MEAN_FLOOR_DB).all()
    assert (port >= SINGLE_FLOOR_DB).all()
    warm = scores['port warm recipe']
    control = scores['port random recipe']
    assert (warm.mean(0) >= WARM_MEAN_FLOOR_DB).all()
    assert (warm >= WARM_SINGLE_FLOOR_DB).all()
    assert not ((control.mean(0) >= WARM_MEAN_FLOOR_DB).all()
                and (control >= WARM_SINGLE_FLOOR_DB).all())


EXTRACTION_ROUTES = [
    'mvdr_souden', 'mvdr_souden+ban', 'wmwf', 'rank1_gev+mvdr_souden+ban',
    'scaled_gev_atf+mvdr', 'rank1_pca+mvdr_souden', 'pca+mvdr', 'pca',
    'ch0', 'fca']


@pytest.mark.slow
def test_extraction_quality_on_the_smoke_utterances(capsys):
    """The numbers behind chip_smoke.py's extraction and FCA floors:
    separate_batch of the smoke's eight 4.8 s utterances (20 iterations)
    with each extraction route of the slice (``'fca'``: refine='fca',
    20 refinement iterations) on the CPU, beside JAX's separate on each
    utterance. Per-frequency SI-SDR of the best estimate per speaker,
    and for 'fca' also the plain SI-SDR."""
    from pb_bss_tpu_torch.testing import low_reverberation_data as data_of
    data = [data_of(seed=s) for s in range(8)]
    observations = np.stack([d['observation'] for d in data]).astype(
        np.float32)
    images = torch.as_tensor(np.stack([d['speech_image'][:, 0]
                                       for d in data]))
    for route in EXTRACTION_ROUTES:
        options = dict(refine='fca') if route == 'fca' \
            else dict(beamformer=route)
        ours = separate_batch(torch.as_tensor(observations), iterations=20,
                              **options)
        assert torch.isfinite(ours).all(), route
        theirs = torch.stack([torch.as_tensor(np.array(jax_separate(
            jnp.asarray(o), iterations=20, **options)))
            for o in observations])
        metrics = (si_sdr_stft, si_sdr) if route == 'fca' else (si_sdr_stft,)
        for metric in metrics:
            with capsys.disabled():
                for name, out in (('port', ours), ('jax', theirs)):
                    s = metric(images[:, :, None],
                               out.double()[:, None]).max(-1).values
                    print(f'\n{route} {metric.__name__} {name}: batch means '
                          f'{s.mean(0).numpy().round(2).tolist()}; worst '
                          f'{s.min().item():.2f} dB')
