"""The port's StreamingSeparator (pb_bss_tpu_torch.streaming) on the CPU:
the JAX tests' properties (reconstruction identity, chunk-size
independence, snapshot/resume in mask and beamformer mode, flush ends
the stream), snapshots carried between the packages in both directions
with both streams continued, the stream alignment and the one-call
beamformer against their JAX / per-class counterparts, and the device
rule. The JAX file's slow quality tests have slow twins here, scored
with the port's SI-SDR (per frequency against the reverberant images on
the 2-speaker scene; in the time domain against the sources on the
moving scene, which has no reverberation)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.streaming import (
    StreamingSeparator as JaxSeparator,
    _align_stream as jax_align_stream,
)
from pb_bss_tpu_torch.evaluation import si_sdr, si_sdr_stft
from pb_bss_tpu_torch.extraction.beamformer import phase_correction
from pb_bss_tpu_torch.extraction.beamformer_wrapper import get_bf_vector
from pb_bss_tpu_torch.models.cacgmm_streaming import StreamingCACGMMState
from pb_bss_tpu_torch.permutation_alignment import DHTVPermutationAlignment
from pb_bss_tpu_torch.streaming import (
    StreamingSeparator,
    _align_stream,
    _beamform_block,
)
from pb_bss_tpu_torch.testing import low_reverberation_data

torch.set_num_threads(2)

BLOCK = 128 * 16  # samples of one block at the defaults


def _run_stream(sep, x, chunk=1000):
    outs = [sep.process(x[:, i:i + chunk])
            for i in range(0, x.shape[-1], chunk)]
    outs.append(sep.flush())
    return np.concatenate(outs, axis=-1)


def _noise(seed, D, n):
    return np.random.default_rng(seed).standard_normal((D, n)).astype(
        np.float32)


def test_masks_sum_to_reference_channel():
    """The K posteriors sum to one per T-F bin, so the summed outputs
    reconstruct the (delayed) reference channel: the whole analysis /
    overlap-add chain, sample by sample (the JAX test's tolerance on
    unit-variance input)."""
    D, n = 3, BLOCK * 6
    x = _noise(0, D, n)
    sep = StreamingSeparator(num_classes=2, block_frames=16,
                             init_iterations=3, device='cpu')
    out = _run_stream(sep, x, chunk=997)  # deliberately odd chunks
    delay = sep.size - sep.shift
    assert out.shape == (2, n + delay), out.shape
    assert out.dtype == np.float32
    assert_allclose(out.sum(0)[delay:n], x[0, :n - delay], atol=2e-4)


def test_chunk_size_independence():
    """Different chunkings of one stream give the same output
    (buffering is transparent)."""
    D, n = 2, BLOCK * 4
    x = _noise(1, D, n)
    outs = []
    for chunk in (512, 2048, n):
        sep = StreamingSeparator(num_classes=2, block_frames=16,
                                 init_iterations=3, device='cpu')
        outs.append(_run_stream(sep, x, chunk=chunk))
    assert_allclose(outs[0], outs[1], atol=1e-5)
    assert_allclose(outs[0], outs[2], atol=1e-5)


@pytest.mark.parametrize('beamformer', [None, 'mvdr_souden', 'gev+ban'])
def test_snapshot_resume_continues_exactly(beamformer):
    """state_dict() / load_state_dict(): a stream snapshotted mid-way
    and resumed on a fresh separator continues to the same samples, the
    beamformer state (decayed PSDs, phase-continuous weights) included;
    a separator of other arguments refuses the snapshot."""
    D, n = 3, BLOCK * 8
    x = _noise(3, D, n)
    kwargs = dict(num_classes=2, block_frames=16, init_iterations=3,
                  init_frames=32, beamformer=beamformer, device='cpu')
    sep_a = StreamingSeparator(**kwargs)
    out_a1 = sep_a.process(x[:, :n // 2])
    state = sep_a.state_dict()
    out_a2 = np.concatenate([sep_a.process(x[:, n // 2:]), sep_a.flush()],
                            axis=-1)
    sep_b = StreamingSeparator(**kwargs).load_state_dict(state)
    out_b2 = np.concatenate([sep_b.process(x[:, n // 2:]), sep_b.flush()],
                            axis=-1)
    assert_allclose(out_b2, out_a2, atol=1e-6)
    assert out_a1.shape[-1] + out_a2.shape[-1] > n
    assert np.isfinite(out_a2).all()

    other = dict(kwargs)
    for change in (dict(num_classes=3), dict(inner_iterations=2),
                   dict(align=False)):
        with pytest.raises(AssertionError, match='mismatch'):
            StreamingSeparator(**{**other, **change}).load_state_dict(state)


def test_snapshot_before_warm_up_holds_the_buffered_blocks():
    """Before warm-up the snapshot holds the buffered analysis blocks
    (not the random start): a resume with the same generator continues
    to the same samples."""
    D, n = 2, BLOCK * 5
    x = _noise(5, D, n)
    kwargs = dict(num_classes=2, init_iterations=2, init_frames=48,
                  device='cpu')
    sep_a = StreamingSeparator(**kwargs)
    assert sep_a.process(x[:, :BLOCK * 2]).shape == (2, 0)
    state = sep_a.state_dict()
    assert state['em_state'] is None and len(state['warmup_blocks']) == 2
    out_a = _run_stream(sep_a, x[:, BLOCK * 2:])
    sep_b = StreamingSeparator(**kwargs).load_state_dict(state)
    assert_allclose(_run_stream(sep_b, x[:, BLOCK * 2:]), out_a, atol=1e-6)


def test_flush_ends_the_stream():
    D, n = 2, BLOCK * 3
    x = _noise(2, D, n)
    sep = StreamingSeparator(num_classes=2, block_frames=16,
                             init_iterations=2, device='cpu')
    sep.process(x)
    assert np.isfinite(sep.flush()).all()
    assert sep.flush().shape == (2, 0)
    with pytest.raises(RuntimeError, match='flushed'):
        sep.process(x[:, :100])


def test_latency_samples():
    sep = StreamingSeparator(num_classes=3, device='cpu')
    assert sep.latency_samples == 2432


def test_the_default_device_is_the_card():
    """The separator runs on the card unless the caller asks for the
    CPU; without CUDA the default raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        assert StreamingSeparator(num_classes=3).device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingSeparator(num_classes=3)


# ---------------------------------------------------------------------
# snapshots carried between the packages
# ---------------------------------------------------------------------

CARRY = dict(num_classes=2, block_frames=16, init_iterations=3,
             init_frames=32, realign_interval=2)


def _continue(sep, x, blocks):
    return [sep.process(x[:, i * BLOCK:(i + 1) * BLOCK])
            for i in range(blocks)]


@pytest.mark.parametrize('beamformer', [None, 'gev+ban'])
def test_jax_snapshot_resumes_in_the_port(beamformer):
    """A JAX state_dict() taken after warm-up loads into the port, and
    both streams continue: the next block agrees tightly (one E-step and
    M-step from the same state in f32), and the blocks through the next
    realignment (DHTV on the rolling window, then the state permuted)
    agree within a stated tolerance."""
    D = 3
    x = _noise(7, D, BLOCK * 6)
    warm = BLOCK * 2  # init_frames=32: the warm-up ends with block 2
    jax_sep = JaxSeparator(beamformer=beamformer, **CARRY)
    jax_sep.process(x[:, :warm])
    state = jax_sep.state_dict()
    assert state['em_state'] is not None
    ours = StreamingSeparator(beamformer=beamformer, device='cpu',
                              **CARRY).load_state_dict(state)
    rest = x[:, warm:]
    jax_out = _continue(jax_sep, rest, 4)
    our_out = _continue(ours, rest, 4)
    # the first block after the snapshot: the same model and statistics
    assert_allclose(our_out[0], jax_out[0], atol=2e-5)
    # the second block is a realignment block (realign_interval=2):
    # the E-steps and M-steps in between part by f32 rounding (measured
    # up to 8e-6 on outputs of magnitude ~3)
    for a, b in zip(our_out[1:], jax_out[1:]):
        assert_allclose(a, b, atol=1e-4)
    assert ours._blocks_since_align == jax_sep._blocks_since_align


def test_port_snapshot_resumes_in_jax():
    D = 3
    x = _noise(8, D, BLOCK * 5)
    warm = BLOCK * 2
    ours = StreamingSeparator(device='cpu', **CARRY)
    ours.process(x[:, :warm])
    state = ours.state_dict()
    assert state['em_state']['scatter'].dtype == np.complex64
    jax_sep = JaxSeparator(**CARRY).load_state_dict(state)
    rest = x[:, warm:]
    jax_out = _continue(jax_sep, rest, 3)
    our_out = _continue(ours, rest, 3)
    assert_allclose(our_out[0], jax_out[0], atol=2e-5)
    for a, b in zip(our_out[1:], jax_out[1:]):
        assert_allclose(a, b, atol=1e-4)


def _stream_state(seed, F=257, K=3, D=3, W=64):
    rng = np.random.default_rng(seed)

    def cn(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    a = cn(F, K, D, D)
    scatter = a @ np.conj(np.swapaxes(a, -1, -2))
    eigenvalues, eigenvectors = np.linalg.eigh(scatter)
    history = rng.random((F, K, W)).astype(np.float32)
    history /= history.sum(1, keepdims=True)
    # a planted per-bin permutation of a shared activity pattern, so the
    # aligner has something to find
    for f in range(F):
        history[f] = history[0][rng.permutation(K)]
    return {'model': {
        'weight': rng.random((F, K, 1)).astype(np.float32),
        'cacg': {'covariance_eigenvectors': eigenvectors.astype(np.complex64),
                 'covariance_eigenvalues': eigenvalues.astype(np.float32)}},
        'scatter': scatter.astype(np.complex64),
        'count': rng.random((F, K)).astype(np.float32),
        'frames': np.full((F,), 100., np.float32)}, history


@pytest.mark.parametrize('seed', [0, 1])
def test_align_stream_matches_jax(seed):
    """The index gathers give JAX's one-hot contractions' permutations,
    on every K-indexed leaf, the affiliation and the window."""
    from pb_bss_tpu.models.cacgmm_streaming import (
        StreamingCACGMMState as JaxState,
    )
    from pb_bss_tpu.permutation_alignment import (
        DHTVPermutationAlignment as JaxDHTV,
    )
    tree, history = _stream_state(seed)
    affiliation = history[..., -16:]
    j_state, j_aff, j_hist = jax_align_stream(
        JaxState.from_dict(jax_tree(tree)), jnp.asarray(affiliation),
        jnp.asarray(history), JaxDHTV.from_stft_size(512))
    state, aff, hist = _align_stream(
        StreamingCACGMMState.from_dict(tree), torch.as_tensor(affiliation),
        torch.as_tensor(history), DHTVPermutationAlignment.from_stft_size(512))
    assert_allclose(aff.numpy(), np.asarray(j_aff))
    assert_allclose(hist.numpy(), np.asarray(j_hist))
    assert_allclose(state.scatter.numpy(), np.asarray(j_state.scatter))
    assert_allclose(state.count.numpy(), np.asarray(j_state.count))
    assert_allclose(state.model.weight.numpy(),
                    np.asarray(j_state.model.weight))
    for name in ('covariance_eigenvectors', 'covariance_eigenvalues'):
        assert_allclose(getattr(state.model.cacg, name).numpy(),
                        np.asarray(getattr(j_state.model.cacg, name)))
    # the data had per-bin permutations: the mapping is not the identity
    assert not np.array_equal(hist.numpy(), history)


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize('beamformer', ['gev+ban', 'mvdr_souden'])
def test_one_call_beamformer_equals_the_per_class_loop(beamformer):
    """_beamform_block's one get_bf_vector call on (K, F, D, D) pencils
    gives the weights of the JAX package's loop over the classes."""
    rng = np.random.default_rng(11)
    F, K, D, B = 65, 3, 4, 16

    def cn(*shape):
        return torch.complex(torch.as_tensor(rng.standard_normal(shape)),
                             torch.as_tensor(rng.standard_normal(shape))
                             ).to(torch.complex64)

    a = cn(F, K, D, 6)
    psd_acc = a @ a.conj().transpose(-1, -2)
    psd_count = torch.as_tensor(rng.uniform(1, 10, (F, K)),
                                dtype=torch.float32)
    w_prev = cn(K, F, D)
    Y = cn(F, B, D)
    _, _, w = _beamform_block(
        Y, torch.zeros(K, 384), psd_acc, psd_count, w_prev, size=512,
        shift=128, window='blackman', beamformer=beamformer)
    psds = psd_acc / psd_count[..., None, None]
    for k in range(K):
        phi_xx = psds[:, k]
        ref = phase_correction(get_bf_vector(
            beamformer, phi_xx, psds.sum(1) - phi_xx))
        inner = (ref.conj() * w_prev[k]).sum(-1)
        ref = ref * (inner / inner.abs())[:, None]
        assert_allclose(w[k].numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------
# quality (the JAX file's slow tests, scored with the port's SI-SDR)
# ---------------------------------------------------------------------

def _best_si_sdr(references, estimates, metric=si_sdr):
    """(K_ref,) score of the best estimate per reference, float64."""
    scores = metric(torch.as_tensor(references)[:, None],
                    torch.as_tensor(np.float64(estimates))[None])
    return scores.max(-1).values.numpy()


@pytest.mark.slow
def test_separates_two_speakers():
    """Mask-based streaming on the synthetic reverberant 2-speaker
    scene: the per-frequency SI-SDR of every speaker's best estimate
    against its reverberant image at the reference channel (the target
    of a mask there) improves on the mixture's reference channel by more
    than 1 dB. The JAX test scores BSS-Eval SDR against the dry sources,
    which the port does not have yet."""
    example = low_reverberation_data(seed=0)
    obs = example['observation'].astype(np.float32)
    images = example['speech_image'][:, 0].astype(np.float64)
    sep = StreamingSeparator(num_classes=3, block_frames=32, forgetting=1.0,
                             inner_iterations=2, init_iterations=20,
                             device='cpu')
    out = _run_stream(sep, obs, chunk=4096)
    delay = sep.size - sep.shift
    out = out[:, delay:delay + obs.shape[-1]]
    mix = _best_si_sdr(images, np.broadcast_to(obs[0], images.shape),
                       si_sdr_stft)
    ours = _best_si_sdr(images, out, si_sdr_stft)
    print('per frequency: mixture', mix, 'stream', ours, '| time domain: '
          'mixture', _best_si_sdr(images, np.broadcast_to(
              obs[0], images.shape)), 'stream', _best_si_sdr(images, out))
    assert np.all(ours > mix + 1.0), (ours, mix)


def _moving_scene(duration_s, sr=8000, d=4, seed=0):
    """Two sources whose mixing vectors rotate to new random directions
    over the stream; (observation (D, N) f32, sources (2, N))."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * sr)
    t = np.arange(n)
    src = np.stack([
        (0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t / sr))
        * rng.standard_normal(n),
        (0.6 + 0.4 * np.sin(2 * np.pi * 4.7 * t / sr + 1.0))
        * rng.standard_normal(n)])
    alpha = (t / n)[None, :]
    obs = np.zeros((d, n))
    for k in range(2):
        a = rng.standard_normal(d)
        b = rng.standard_normal(d)
        a /= np.linalg.norm(a)
        b /= np.linalg.norm(b)
        mix = (1 - alpha) * a[:, None] + alpha * b[:, None]
        mix /= np.linalg.norm(mix, axis=0, keepdims=True)
        obs += mix * src[k][None, :]
    obs += 0.05 * rng.standard_normal((d, n))
    return obs.astype(np.float32), src


def _quarter_scores(out, src):
    """(mean SI-SDR per quarter, best assignment per quarter)."""
    n = src.shape[-1]
    rows = []
    for q in range(4):
        sl = slice(q * n // 4, (q + 1) * n // 4)
        scores = si_sdr(torch.as_tensor(src[:, sl])[:, None],
                        torch.as_tensor(out[:, sl])[None]).numpy()
        best = max((np.mean([scores[i, j] for i, j in enumerate(perm)]),
                    perm)
                   for perm in itertools.permutations(range(out.shape[0]),
                                                      src.shape[0]))
        rows.append(best)
    return [r[0] for r in rows], [r[1] for r in rows]


@pytest.mark.slow
def test_moving_sources_drift_correction():
    """On a slowly moving 60 s scene the default periodic realignment
    keeps the class identity stable and beats the warm-up-only policy in
    the second half by more than 1 dB."""
    obs, src = _moving_scene(60.0)

    def run(realign_interval):
        sep = StreamingSeparator(
            num_classes=3, block_frames=32, forgetting=0.995,
            inner_iterations=2, init_iterations=20,
            realign_interval=realign_interval, device='cpu')
        out = _run_stream(sep, obs, chunk=4096)
        delay = sep.size - sep.shift
        return np.float64(out[:, delay:delay + obs.shape[-1]])

    scores_default, perms_default = _quarter_scores(run(8), src)
    scores_off, _ = _quarter_scores(run(None), src)
    print('interval 8', scores_default, perms_default, 'off', scores_off)
    assert len(set(perms_default)) == 1, perms_default
    assert np.mean(scores_default[2:]) > np.mean(scores_off[2:]) + 1.0, (
        scores_default, scores_off)


@pytest.mark.slow
def test_beamformed_streaming():
    """GEV-beamformed streaming on decayed class PSDs: finite output,
    the mean per-frequency SI-SDR against the reverberant images above
    the mixture's by more than 1 dB (a beamformer's output is its
    target up to a filter, which the time-domain SI-SDR would count as
    distortion), and no block-boundary bursts."""
    example = low_reverberation_data(seed=0)
    obs = example['observation'].astype(np.float32)
    images = example['speech_image'][:, 0].astype(np.float64)
    sep = StreamingSeparator(num_classes=3, block_frames=32, forgetting=1.0,
                             inner_iterations=2, init_iterations=20,
                             beamformer='gev+ban', device='cpu')
    out = _run_stream(sep, obs, chunk=4096)
    assert np.isfinite(out).all()
    delay = sep.size - sep.shift
    out = np.float64(out[:, delay:delay + obs.shape[-1]])
    mix = _best_si_sdr(images, np.broadcast_to(obs[0], images.shape),
                       si_sdr_stft)
    ours = _best_si_sdr(images, out, si_sdr_stft)
    print('per frequency: mixture', mix, 'stream', ours, '| time domain: '
          'stream', _best_si_sdr(images, out))
    assert np.mean(ours) > np.mean(mix) + 1.0, (ours, mix)
    block = sep.block_frames * sep.shift
    bounds = np.arange(block, out.shape[-1] - 1, block)
    jumps = np.abs(out[:, bounds] - out[:, bounds - 1])
    typical = np.mean(np.abs(np.diff(out, axis=-1))) + 1e-9
    assert np.mean(jumps) < 20 * typical, (np.mean(jumps), typical)


@pytest.mark.slow
def test_streaming_quality_on_the_smoke_recording():
    """The numbers behind chip_smoke.py's streaming floors: both
    packages stream its 60 s recording at the defaults in mask and
    'gev+ban' mode; prints the time-domain SI-SDR of the best output per
    speaker against the reverberant images (and the mixture's channel
    0), and holds the port's CPU stream to the smoke's floors
    (STREAM_FLOORS_DB: mean over the speakers, worst speaker)."""
    from pb_bss_tpu_torch.testing.streaming_quality import (
        recording, run_stream, scores)
    floors = {None: (-5.0, -8.0), 'gev+ban': (-22.0, -27.0)}
    obs, images = recording()
    print('mixture channel 0',
          scores(images, np.broadcast_to(obs[0], images.shape)))
    for beamformer, (mean_floor, single_floor) in floors.items():
        ours = run_stream(StreamingSeparator(
            num_classes=3, beamformer=beamformer, device='cpu'), obs)
        theirs = run_stream(JaxSeparator(num_classes=3,
                                         beamformer=beamformer), obs)
        ours_scores = scores(images, ours)
        print(beamformer, 'port', ours_scores, 'JAX', scores(images, theirs))
        assert np.isfinite(ours).all()
        assert ours_scores['si_sdr'].mean() >= mean_floor
        assert ours_scores['si_sdr'].min() >= single_floor
