"""Separation quality of the streaming separator on a 60 s recording.

    python -m pb_bss_tpu_torch.testing.streaming_quality --device cpu \
        [--seconds 60]

The recording is ``chip_smoke.py``'s first long recording: 13
concatenated ``low_reverberation_data`` scenarios (seeds 1000-1012),
6 channels at 8 kHz, cut to 480,000 samples. ``StreamingSeparator`` at
its defaults (K=3, 512/128, 16-frame blocks, 256-frame warm-up) takes it
in chunks of 4,096 samples, in mask mode and with ``beamformer=
'gev+ban'``. Prints, per mode and for the mixture's channel 0, the SI-SDR
of the best output per speaker against the speakers' reverberant images
at channel 0, in the time domain (``evaluation.si_sdr``) and per
frequency (``evaluation.si_sdr_stft``), and the seconds the stream took.
``chip_smoke.py`` holds the card's scores to floors set below these CPU
numbers and above the mixture's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

__all__ = ['SAMPLES', 'CHUNK', 'recording', 'run_stream', 'scores']

SAMPLES = 480_000
_PIECES = 13
_FIRST_SEED = 1000
CHUNK = 4096


def recording(samples=SAMPLES):
    """(observation (D, N) float32 numpy, reference-channel speech
    images (S, N) float64 numpy) of the 60 s recording, cut to
    ``samples``."""
    from .dummy_data import low_reverberation_data
    data = [low_reverberation_data(seed=_FIRST_SEED + i)
            for i in range(_PIECES)]
    obs = np.concatenate([d['observation'] for d in data], -1)[:, :samples]
    images = np.concatenate([d['speech_image'][:, 0] for d in data],
                            -1)[:, :samples]
    return obs.astype(np.float32), images.astype(np.float64)


def run_stream(separator, observation, chunk=CHUNK):
    """Feed ``observation`` (D, N) in chunks, flush, and return the
    (K, N) output aligned with the input (the ``size - shift`` samples
    of synthesis delay removed)."""
    outs = [separator.process(observation[:, i:i + chunk])
            for i in range(0, observation.shape[-1], chunk)]
    outs.append(separator.flush())
    out = np.concatenate(outs, axis=-1)
    delay = separator.size - separator.shift
    return out[:, delay:delay + observation.shape[-1]]


def scores(images, estimates):
    """{'si_sdr': (S,), 'si_sdr_stft': (S,)}: the score in dB of the
    best estimate per speaker."""
    from ..evaluation import si_sdr, si_sdr_stft
    ref = torch.as_tensor(images)[:, None]
    est = torch.as_tensor(np.float64(estimates))[None]
    return {metric.__name__: metric(ref, est).max(-1).values.numpy()
            for metric in (si_sdr, si_sdr_stft)}


def main():
    from ..streaming import StreamingSeparator
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--seconds', type=float, default=SAMPLES / 8000)
    args = parser.parse_args()
    observation, images = recording(int(args.seconds * 8000))
    mixture = scores(images, np.broadcast_to(observation[0], images.shape))
    print('mixture channel 0:', {k: [round(float(s), 2) for s in v]
                                 for k, v in mixture.items()})
    for beamformer in (None, 'gev+ban'):
        t0 = time.perf_counter()
        out = run_stream(StreamingSeparator(
            num_classes=3, beamformer=beamformer, device=args.device),
            observation)
        seconds = time.perf_counter() - t0
        result = scores(images, out)
        print(f'{beamformer or "mask"}: finite {bool(np.isfinite(out).all())}'
              f', {seconds:.1f} s,',
              {k: [round(float(s), 2) for s in v] for k, v in result.items()})


if __name__ == '__main__':
    main()
