"""Streaming separation example on the PyTorch port
(``pb_bss_tpu_torch``; the counterpart of streaming_example.py).

A synthetic 2-speaker 6-channel mixture is fed to
:class:`pb_bss_tpu_torch.StreamingSeparator` in microphone-sized chunks;
each full STFT block triggers one device step (analysis -> block-online
cACGMM update -> masking -> overlap-add), so the separated waveforms
arrive with a fixed latency of ``block_frames * shift + (size - shift)``
samples. On the card the warm-up fit runs the whole-fit EM kernel once
and each streamed block's M-step the Jacobi kernel; ``--device cpu``
streams on their plain twins.

Run: python examples/streaming_example_torch.py [--chunk 4096]
     [--device cpu]
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import numpy as np
import torch

from pb_bss_tpu_torch import StreamingSeparator
from pb_bss_tpu_torch.testing.dummy_data import low_reverberation_data


def main(chunk=4096, block_frames=32, device='cuda'):
    device = torch.device(device)
    example = low_reverberation_data(seed=0)
    observation = example['observation'].astype(np.float32)  # (D, N)
    sample_rate = example['sample_rate']

    sep = StreamingSeparator(
        num_classes=3,                 # 2 speakers + noise
        block_frames=block_frames,
        forgetting=1.0,                # stationary scene
        inner_iterations=2,
        init_iterations=15,
        generator=torch.Generator(device).manual_seed(0),
        device=device,
    )
    print(f'observation: {observation.shape}, '
          f'latency: {sep.latency_samples} samples '
          f'({sep.latency_samples / sample_rate * 1e3:.0f} ms)')

    outputs = []
    chunk_times = []
    for start in range(0, observation.shape[-1], chunk):
        t0 = time.perf_counter()
        outputs.append(sep.process(observation[:, start:start + chunk]))
        chunk_times.append(time.perf_counter() - t0)
    outputs.append(sep.flush())
    separated = np.concatenate(outputs, axis=-1)  # (K, N + delay)

    audio_ms = chunk / sample_rate * 1e3
    print(f'separated: {separated.shape}; steady-state '
          f'{np.median(chunk_times[2:]) * 1e3:.0f} ms per '
          f'{audio_ms:.0f} ms chunk '
          f'(first chunk {chunk_times[0]:.1f} s)')

    # The masks sum to one, so the summed outputs reconstruct the
    # (delayed) reference channel — a quick end-to-end sanity check.
    delay = sep.size - sep.shift
    n = observation.shape[-1]
    recon = separated.sum(0)[delay:n]
    err = np.max(np.abs(recon - observation[0, :n - delay]))
    print(f'sum-of-outputs reconstruction error: {err:.2e}')

    # Correlation of each clean source with its best stream output.
    sources = example['speech_source']
    out = separated[:, delay:delay + n]

    def ncorr(a, b):
        a = a - a.mean()
        b = b - b.mean()
        return abs(np.dot(a, b)) / max(
            np.linalg.norm(a) * np.linalg.norm(b), 1e-30)

    for k in range(sources.shape[0]):
        c_mix = ncorr(observation[0], sources[k])
        c_best = max(ncorr(out[j], sources[k])
                     for j in range(out.shape[0]))
        print(f'speaker {k}: corr vs mixture {c_mix:.3f} -> '
              f'best stream output {c_best:.3f}')


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--chunk', type=int, default=4096,
                        help='samples fed per process() call')
    parser.add_argument('--block-frames', type=int, default=32,
                        help='STFT frames per EM block')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args()
    main(chunk=args.chunk, block_frames=args.block_frames,
         device=args.device)
