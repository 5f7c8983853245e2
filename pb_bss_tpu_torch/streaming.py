"""Sample-level streaming separation (counterpart of
``pb_bss_tpu.streaming``).

The offline pipeline (:mod:`pb_bss_tpu_torch.pipeline`) separates a
complete recording. This module is the *serving* form: audio arrives in
fixed-size multichannel sample chunks; each block of ``block_frames``
STFT frames is analyzed, fed to the block-online cACGMM
(:class:`~pb_bss_tpu_torch.models.cacgmm_streaming.StreamingCACGMM`),
masked or beamformed, and synthesized, with deterministic latency.

Latency contract: one block (``block_frames * shift`` samples) of
buffering plus ``size - shift`` samples of overlap-add completion, i.e.
with the defaults (512/128, 16 frames) ``16 * 128 + 384 = 2432``
samples. Steady-state reconstruction is exact; only the first
``size - shift`` output samples lack full window overlap, as the
offline transform with ``fading=False``.

Class identity is consistent across blocks (each block's EM is warm
started from the previous model) and across frequency (the stream state
is DHTV-aligned on the warm-up segment and realigned every
``realign_interval`` blocks, anchored by a majority vote).

On the card a stream runs the JAX package's kernels: the warm-up fit is
one launch of the whole-fit EM kernel K2, each block's M-step one launch
of the batched Jacobi kernel K1 per inner iteration, and in beamformer
mode each block's weights are ONE ``get_bf_vector`` call over all
classes, (K, F, D, D) pencils: one launch of the GEV kernel K3 a block
for ``'gev+ban'`` (the JAX package calls it once per class). Audio comes
from the host as numpy, and each block is copied to the device once;
``process`` and ``flush`` return host float32 arrays.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from .extraction.beamformer import apply_beamforming_vector, phase_correction
from .extraction.beamformer_wrapper import get_bf_vector
from .models._precision import full_fp32
from .models.cacgmm import CACGMM
from .models.cacgmm_streaming import StreamingCACGMM, StreamingCACGMMState
from .models.complex_angular_central_gaussian import (
    ComplexAngularCentralGaussian,
)
from .permutation_alignment import DHTVPermutationAlignment
from .transform.stft_module import istft, stft
from .utils import to_numpy

__all__ = ['StreamingSeparator']


def _permute_classes(x, index):
    """x (F, K, ...) with its classes taken as ``index`` (F, K) says:
    ``out[f, n] = x[f, index[f, n]]``."""
    index = index.reshape(index.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, index.expand(x.shape))


def _align_stream(em_state, affiliation, history, aligner):
    """Frequency permutation alignment of the WHOLE stream state.

    The aligner's mapping is computed on a window of recent
    affiliations and applied to the block's affiliation, to the window
    and to every K-indexed leaf of the persistent state (the weight, the
    eigenvectors and eigenvalues, the scatter and the count), so the
    warm-started blocks that follow inherit the alignment. The mapping
    is composed with the global permutation that turns the
    per-frequency majority into the identity, so that a realignment
    never swaps the output channels mid-stream. Index gathers take the
    place of the JAX package's one-hot contractions; the permutations
    are the same.

    Args:
        em_state: :class:`StreamingCACGMMState`.
        affiliation: (F, K, B) this block's posteriors.
        history: (F, K, W) rolling affiliation window (this block at
            the newest positions).
    Returns:
        (aligned state, aligned affiliation, aligned history).
    """
    mapping = aligner.calculate_mapping(history.transpose(0, 1))  # (K, F)
    K = affiliation.shape[1]
    table = torch.tensor(list(itertools.permutations(range(K))),
                         device=mapping.device)  # (K!, K)
    votes = (mapping.T[:, None, :] == table[None]).all(-1).sum(0)  # (K!,)
    majority = table[torch.argmax(votes)]
    inverse = torch.argsort(majority)  # majority[inverse[n]] == n
    # new class n of bin f is old class mapping[inverse[n], f]
    index = mapping[inverse].T  # (F, K)

    cacg = em_state.model.cacg
    model = CACGMM(
        weight=_permute_classes(em_state.model.weight, index),
        cacg=ComplexAngularCentralGaussian(
            covariance_eigenvectors=_permute_classes(
                cacg.covariance_eigenvectors, index),
            covariance_eigenvalues=_permute_classes(
                cacg.covariance_eigenvalues, index)))
    state = StreamingCACGMMState(
        model=model, scatter=_permute_classes(em_state.scatter, index),
        count=_permute_classes(em_state.count, index),
        frames=em_state.frames)
    return (state, _permute_classes(affiliation, index),
            _permute_classes(history, index))


def _accumulate_psd(psd_acc, psd_count, Y, affiliation, *, forgetting):
    """Blend one block into the decayed class PSDs
    (``Phi_k <- rho Phi_k + sum_t gamma_kt y_t y_t^H``), so that the
    beamformer sees the whole (discounted) past, not just one block.
    Y (F, B, D), affiliation (F, K, B)."""
    rho = forgetting ** Y.shape[1]
    Y_fdt = Y.transpose(1, 2)
    weighted = Y_fdt[:, None] * affiliation[:, :, None, :].to(Y.dtype)
    with full_fp32():
        block_psd = weighted @ Y_fdt.conj().transpose(-1, -2)[:, None]
    return (rho * psd_acc + block_psd,
            rho * psd_count + affiliation.sum(-1))


def _overlap_add_block(block, ola_tail, *, size, shift, frames):
    """Split a synthesized block (..., size + (frames-1) shift) into the
    finished samples (with the previous block's tail added) and the new
    tail."""
    out = block[..., :frames * shift].clone()
    out[..., :size - shift] += ola_tail
    return out, block[..., frames * shift:]


def _beamform_block(Y, ola_tail, psd_acc, psd_count, w_prev, *, size, shift,
                    window, beamformer):
    """Beamform one block with the current decayed class PSDs: every
    class's weights in one ``get_bf_vector`` call on (K, F, D, D), each
    class against the sum of the others as noise.

    Eigenvector beamformers carry an arbitrary per-frequency phase that
    would jump between blocks; after the within-block phase correction
    each weight is rotated onto the previous block's weight
    (``w <- w exp(-i angle(w^H w_prev))``), a no-op while ``w_prev`` is
    the zero start.

    Args:
        Y: (F, B, D) analysis block.
        psd_acc / psd_count: (F, K, D, D) / (F, K) decayed statistics.
        w_prev: (K, F, D) previous block's weights.
    Returns:
        (out (K, B*shift), new_tail, w (K, F, D)).
    """
    B = Y.shape[1]
    psds = psd_acc / torch.clamp(
        psd_count, min=1e-10)[..., None, None].to(psd_acc.dtype)
    phi_xx = psds.transpose(0, 1)  # (K, F, D, D)
    phi_nn = psds.sum(1)[None] - phi_xx
    w = phase_correction(get_bf_vector(beamformer, phi_xx, phi_nn))
    inner = torch.einsum('kfd,kfd->kf', w.conj(), w_prev)
    magnitude = inner.abs()
    g = torch.where(magnitude > 1e-12,
                    inner / torch.clamp(magnitude, min=1e-30),
                    torch.ones_like(inner))
    w = w * g[..., None]
    out = apply_beamforming_vector(w, Y.transpose(1, 2)[None])  # (K, F, B)
    block = istft(out.transpose(-1, -2), size, shift, window=window,
                  fading=False)
    out, tail = _overlap_add_block(block, ola_tail, size=size, shift=shift,
                                   frames=B)
    return out, tail, w


def _analyze(lookback, chunk, *, size, shift, window):
    """(D, size-shift) lookback + (D, B*shift) chunk -> (F, B, D) STFT
    block and the new lookback."""
    xs = torch.cat([lookback, chunk], dim=-1)
    # length == size + (B-1)*shift -> exactly B frames, no padding
    Y = stft(xs, size, shift, window=window, fading=False, pad=False)
    return Y.permute(2, 1, 0), xs[..., -(size - shift):]


def _synthesize(Y, affiliation, ola_tail, *, size, shift, window,
                reference_channel):
    """Mask the reference channel and overlap-add one block.

    Args:
        Y: (F, B, D) analysis block.
        affiliation: (F, K, B) streaming posteriors.
        ola_tail: (K, size - shift) synthesis carry.
    Returns:
        (out (K, B*shift), new_tail (K, size - shift)).
    """
    masked = affiliation.to(Y.dtype) * Y[:, None, :, reference_channel]
    block = istft(masked.permute(1, 2, 0), size, shift, window=window,
                  fading=False)
    return _overlap_add_block(block, ola_tail, size=size, shift=shift,
                              frames=Y.shape[1])


def _resolve_device(device):
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'StreamingSeparator runs on the card by default, and CUDA is '
            "not available here; pass device='cpu' to stream on the CPU.")
    return device


class StreamingSeparator:
    """Block-online multichannel separation with fixed latency.

    Usage::

        sep = StreamingSeparator(num_classes=3)   # on the card
        for chunk in microphone_chunks:     # (D, chunk_samples) each
            out = sep.process(chunk)        # (K, n) as blocks complete
        out = sep.flush()                   # final overlap-add tail

    Arbitrary chunk sizes are accepted (samples are buffered on the
    host); every full ``block_frames`` STFT frames trigger one device
    step. Output class order is stable across a stream.

    Args:
        num_classes: K mixture components (speakers + noise).
        stft_size / stft_shift / window: transform parameters.
        block_frames: STFT frames per EM block; must satisfy
            ``block_frames * stft_shift >= stft_size - stft_shift``.
        forgetting / inner_iterations / init_iterations: the
            :class:`StreamingCACGMM` tracking knobs (``forgetting`` also
            discounts the beamformer PSDs).
        init_frames: STFT frames buffered before the first EM fit (the
            warm-up; default 256). The warm-up segment is separated and
            emitted in one burst when the model initializes, after which
            latency is the steady-state contract.
        reference_channel: channel whose STFT the masks scale (mask
            mode, ``beamformer=None``).
        beamformer: optional ``get_bf_vector`` name (e.g.
            ``'gev+ban'``, ``'mvdr_souden'``): each block is extracted
            by per-class beamformers on exponentially decayed class
            PSDs instead of masks, with block-to-block phase continuity
            of the weights.
        align: run the DHTV frequency permutation aligner on the warm-up
            segment and realign the stream state with it. ``True``
            (default) uses the stft_size presets (512/1024); pass an
            aligner instance for other sizes, or ``False`` for raw
            per-frequency classes.
        realign_interval: rerun the aligner every N blocks on the
            rolling affiliation window (drift correction anchored
            against global label flips by a majority vote), ``None`` to
            disable. Each realignment writes its residual per-frequency
            errors into the state, so do not go below a few blocks.
        generator: ``torch.Generator`` of the warm-up EM's random
            initialization (the JAX package's ``key``; default: one
            seeded 0 on ``device``).
        device: where the stream's tensors live and its kernels run:
            ``'cuda'`` (default) or ``'cpu'``. Without CUDA the default
            raises rather than running on the CPU.
    """

    def __init__(self, num_classes, *, stft_size=512, stft_shift=128,
                 window='blackman', block_frames=16, forgetting=0.999,
                 inner_iterations=1, init_iterations=10, init_frames=256,
                 reference_channel=0, beamformer=None, align=True,
                 realign_interval=8, generator=None, device='cuda'):
        assert block_frames * stft_shift >= stft_size - stft_shift, (
            block_frames, stft_size, stft_shift)
        self.device = _resolve_device(device)
        if align is True:
            align = (DHTVPermutationAlignment.from_stft_size(stft_size)
                     if stft_size in (512, 1024) else None)
        self._aligner = align or None
        # DHTV needs a few hundred frames of activity profile: keep at
        # least the warm-up's worth of (past-only) history in the window
        self.init_frames = max(init_frames, block_frames)
        self._align_window = max(self.init_frames, 2 * block_frames)
        self._aff_hist = None          # (F, K, W) rolling window
        self._warmup_blocks = []
        self.realign_interval = realign_interval
        self._blocks_since_align = 0
        self.num_classes = num_classes
        self.size = stft_size
        self.shift = stft_shift
        self.window = window
        self.block_frames = block_frames
        self.reference_channel = reference_channel
        self.beamformer = beamformer
        self.forgetting = float(forgetting)
        self.generator = generator
        self.stream = StreamingCACGMM(
            num_classes, forgetting=forgetting,
            inner_iterations=inner_iterations,
            init_iterations=init_iterations)
        self._em_state = None
        self._lookback = None          # (D, size - shift)
        self._ola_tail = None          # (K, size - shift)
        self._buffer = None            # host sample buffer (D, n)
        self._psd_acc = None           # (F, K, D, D) decayed PSDs
        self._psd_count = None         # (F, K)
        self._w_prev = None            # (K, F, D) last block's weights
        self._finished = False         # set by flush()

    @property
    def latency_samples(self):
        """Steady-state algorithmic latency in samples. The very first
        output additionally waits for the EM warm-up
        (``init_frames * shift`` samples, emitted in one burst)."""
        return self.block_frames * self.shift + (self.size - self.shift)

    def _empty(self):
        return np.zeros((self.num_classes, 0), np.float32)

    def _step(self, chunk):
        """One device step for (D, block_frames*shift) samples."""
        Y, self._lookback = _analyze(
            self._lookback, chunk, size=self.size, shift=self.shift,
            window=self.window)
        if self._em_state is None:
            # warm-up: the EM and the aligner need a few hundred frames
            # to lock on; buffer the analysis blocks, then initialize on
            # the whole segment and emit its output at once
            self._warmup_blocks.append(Y)
            warm = sum(b.shape[1] for b in self._warmup_blocks)
            if warm < self.init_frames:
                return self._empty()
            return self._initialize_and_catch_up()
        self._em_state, affiliation = self.stream.update(self._em_state, Y)
        if self._aligner is not None:
            self._aff_hist = torch.cat(
                [self._aff_hist[..., affiliation.shape[-1]:], affiliation],
                dim=-1)
            # periodic realignment corrects the drift of a moving scene
            # and is a no-op on a static one (majority-anchored)
            self._blocks_since_align += 1
            if (self.realign_interval is not None
                    and self._blocks_since_align >= self.realign_interval):
                self._blocks_since_align = 0
                self._em_state, affiliation, self._aff_hist = _align_stream(
                    self._em_state, affiliation, self._aff_hist,
                    self._aligner)
        return self._synth_block(Y, affiliation)

    def _initialize_and_catch_up(self):
        Yw = torch.cat(self._warmup_blocks, dim=1)  # (F, Tw, D)
        self._warmup_blocks = None
        generator = self.generator
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        state, aff = self.stream.update(None, Yw, generator=generator)
        if self._aligner is not None:
            W = self._align_window
            pad = max(0, W - aff.shape[-1])
            self._aff_hist = torch.nn.functional.pad(
                aff, (pad, 0))[..., -W:]
            state, aff, self._aff_hist = _align_stream(
                state, aff, self._aff_hist, self._aligner)
        self._em_state = state
        B = self.block_frames
        if self.beamformer is not None:
            # accumulate the WHOLE warm-up segment's PSDs before
            # beamforming any of it: a cold one-block PSD gives
            # ill-conditioned weights (NaN GEV output at block_frames=16)
            self._ensure_psd_state(Yw)
            self._psd_acc, self._psd_count = _accumulate_psd(
                self._psd_acc, self._psd_count, Yw, aff,
                forgetting=self.forgetting)
        outs = [self._synth_block(Yw[:, i * B:(i + 1) * B],
                                  aff[..., i * B:(i + 1) * B],
                                  accumulate_psd=False)
                for i in range(Yw.shape[1] // B)]
        return np.concatenate(outs, axis=-1)

    def _ensure_psd_state(self, Y):
        if self._psd_acc is None:
            F, _, D = Y.shape
            K = self.num_classes
            self._psd_acc = torch.zeros((F, K, D, D), dtype=Y.dtype,
                                        device=self.device)
            self._psd_count = torch.zeros((F, K), dtype=torch.float32,
                                          device=self.device)
            self._w_prev = torch.zeros((K, F, D), dtype=Y.dtype,
                                       device=self.device)

    def _synth_block(self, Y, affiliation, accumulate_psd=True):
        if self.beamformer is None:
            out, self._ola_tail = _synthesize(
                Y, affiliation, self._ola_tail, size=self.size,
                shift=self.shift, window=self.window,
                reference_channel=self.reference_channel)
            return to_numpy(out)
        self._ensure_psd_state(Y)
        if accumulate_psd:
            self._psd_acc, self._psd_count = _accumulate_psd(
                self._psd_acc, self._psd_count, Y, affiliation,
                forgetting=self.forgetting)
        out, self._ola_tail, self._w_prev = _beamform_block(
            Y, self._ola_tail, self._psd_acc, self._psd_count,
            self._w_prev, size=self.size, shift=self.shift,
            window=self.window, beamformer=self.beamformer)
        return to_numpy(out)

    # ------------------------------------------------------------------
    # Serving failover: snapshot / resume a live stream
    # ------------------------------------------------------------------

    _CONFIG_KEYS = ('num_classes', 'size', 'shift', 'window',
                    'block_frames', 'forgetting', 'reference_channel',
                    'beamformer', 'init_frames', 'realign_interval')

    def _config(self):
        config = {k: getattr(self, k) for k in self._CONFIG_KEYS}
        config['inner_iterations'] = self.stream.inner_iterations
        config['init_iterations'] = self.stream.init_iterations
        config['aligner'] = (None if self._aligner is None
                             else type(self._aligner).__name__)
        return config

    def state_dict(self):
        """Snapshot the live stream as host numpy, in the JAX package's
        layout and with its config keys (complex leaves as complex
        arrays): the EM model and decayed statistics, the analysis
        lookback, the overlap-add tail, the beamformer PSDs and weights,
        the alignment history, the host sample buffer and the counters.
        A snapshot of either package loads into the other
        (:meth:`load_state_dict`, on a separator with the same
        constructor arguments).

        The only state NOT captured is the ``generator`` of a stream
        snapshotted BEFORE its warm-up EM ran: such a snapshot holds the
        buffered warm-up blocks but not the random start (pass the same
        ``generator`` to the resuming separator); after warm-up the
        snapshot is complete.
        """
        def fetch(x):
            return None if x is None else to_numpy(x)

        def fetch_tree(d):
            return {k: fetch_tree(v) if isinstance(v, dict) else fetch(v)
                    for k, v in d.items()}

        return {
            'config': self._config(),
            'buffer': (None if self._buffer is None
                       else self._buffer.copy()),
            'finished': self._finished,
            'blocks_since_align': self._blocks_since_align,
            'lookback': fetch(self._lookback),
            'ola_tail': fetch(self._ola_tail),
            'aff_hist': fetch(self._aff_hist),
            'psd_acc': fetch(self._psd_acc),
            'psd_count': fetch(self._psd_count),
            'w_prev': fetch(self._w_prev),
            'warmup_blocks': (
                None if self._warmup_blocks is None
                else [fetch(b) for b in self._warmup_blocks]),
            'em_state': (None if self._em_state is None
                         else fetch_tree(self._em_state.to_dict())),
        }

    def load_state_dict(self, state):
        """Resume a stream from a :meth:`state_dict` snapshot (of either
        package). The separator must be constructed with the same
        arguments (checked against the snapshot's config); the following
        ``process`` calls continue the stream where the snapshot left
        off."""
        config = dict(state['config'])
        mine = self._config()
        assert config == mine, (
            'snapshot/config mismatch — construct the separator with '
            'the same arguments', config, mine)

        def put(x):
            if x is None:
                return None
            return torch.as_tensor(np.array(x), device=self.device)

        def put_tree(d):
            return {k: put_tree(v) if isinstance(v, dict) else put(v)
                    for k, v in d.items()}

        self._buffer = (None if state['buffer'] is None
                        else np.asarray(state['buffer']))
        self._finished = bool(state['finished'])
        self._blocks_since_align = int(state['blocks_since_align'])
        self._lookback = put(state['lookback'])
        self._ola_tail = put(state['ola_tail'])
        self._aff_hist = put(state['aff_hist'])
        self._psd_acc = put(state['psd_acc'])
        self._psd_count = put(state['psd_count'])
        self._w_prev = put(state['w_prev'])
        self._warmup_blocks = (
            None if state['warmup_blocks'] is None
            else [put(b) for b in state['warmup_blocks']])
        self._em_state = (
            None if state['em_state'] is None
            else StreamingCACGMMState.from_dict(put_tree(state['em_state'])))
        return self

    def process(self, samples):
        """Feed (D, n) host samples; returns (K, m) separated samples as
        a host float32 array (m = however many full blocks completed,
        possibly 0)."""
        if self._finished:
            raise RuntimeError(
                'This stream was already flushed (its overlap-add tail '
                'has been emitted); create a new StreamingSeparator for '
                'the next stream.')
        samples = np.asarray(samples)
        assert samples.ndim == 2, samples.shape
        if self._buffer is None:
            D = samples.shape[0]
            self._buffer = np.zeros((D, 0), samples.dtype)
            self._lookback = torch.zeros((D, self.size - self.shift),
                                         device=self.device)
            self._ola_tail = torch.zeros(
                (self.num_classes, self.size - self.shift),
                device=self.device)
        self._buffer = np.concatenate([self._buffer, samples], axis=-1)

        block_samples = self.block_frames * self.shift
        outs = []
        while self._buffer.shape[-1] >= block_samples:
            chunk = torch.as_tensor(
                np.ascontiguousarray(self._buffer[:, :block_samples],
                                     dtype=np.float32), device=self.device)
            self._buffer = self._buffer[:, block_samples:]
            outs.append(self._step(chunk))
        if outs:
            return np.concatenate(outs, axis=-1)
        return self._empty()

    def flush(self):
        """Zero-pad the buffered samples to a whole block, process it,
        and emit everything including the overlap-add tail. A stream
        shorter than the warm-up is initialized with the frames it has.

        Flushing ends the stream: further ``process`` calls raise and
        repeated ``flush`` calls return an empty block."""
        if self._buffer is None or self._finished:
            self._finished = True
            return self._empty()
        n_rest = self._buffer.shape[-1]
        block_samples = self.block_frames * self.shift
        outs = []
        if n_rest:
            pad = np.zeros((self._buffer.shape[0], block_samples - n_rest),
                           self._buffer.dtype)
            out = self.process(pad)
            if self._em_state is None and self._warmup_blocks:
                out = np.concatenate(
                    [out, self._initialize_and_catch_up()], axis=-1)
            # drop the zero-padding's worth of trailing samples
            outs.append(out[:, :max(0, out.shape[-1]
                                    - (block_samples - n_rest))])
        elif self._em_state is None and self._warmup_blocks:
            outs.append(self._initialize_and_catch_up())
        outs.append(to_numpy(self._ola_tail))
        self._buffer = self._buffer[:, :0]
        self._finished = True
        return np.concatenate(outs, axis=-1)
