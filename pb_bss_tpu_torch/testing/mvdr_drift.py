"""How far the CPU's numerics move ``separate_batch(beamformer=
'mvdr_souden+ban')`` on the three speech cuts that
``tests/test_torch_parallel_pipeline.py`` holds to the unsharded call.

    python -m pb_bss_tpu_torch.testing.mvdr_drift

``stable_solve``'s residual gate (a fault of the reference, ROADMAP
queue 3) turns a last-bit change of a near-singular noise PSD into a
wholesale change of that bin's beamformer. This prints the largest
change of each utterance's output, as a share of the output's peak,
against the default call in this process: a second call; the
observations at other alignments; other float32 matmul precisions and
thread counts; and, in a child process each, MKL's instruction-set
dispatch (``MKL_CBWR``) and ATen's (``ATEN_CPU_CAPABILITY``).
"""
from __future__ import annotations

import argparse
import io
import os
import subprocess
import sys

import numpy as np
import torch

__all__ = ['speech', 'separate', 'drift']

SAMPLES, NUM_CLASSES, ITERATIONS = 6000, 3, 3
CHILDREN = [('MKL_CBWR', 'AVX2'), ('MKL_CBWR', 'COMPATIBLE'),
            ('ATEN_CPU_CAPABILITY', 'avx2')]


def speech():
    """(3, 6, 6000) float32: the first 6,000 samples of the dummy
    two-speaker scenarios of seeds 0, 1 and 2."""
    from .dummy_data import low_reverberation_data
    return np.stack([low_reverberation_data(seed)['observation'][:, :SAMPLES]
                     for seed in range(3)]).astype(np.float32)


def separate(observations):
    """The test's call on (B, D, N) ``observations``: (B, K, N)."""
    from .. import separate_batch
    return separate_batch(torch.from_numpy(observations),
                          num_classes=NUM_CLASSES, iterations=ITERATIONS,
                          beamformer='mvdr_souden+ban').numpy()


def drift(reference, other):
    """Each utterance's largest change, as a share of the peak."""
    change = np.abs(other - reference).reshape(len(reference), -1).max(1)
    return change / np.abs(reference).max()


def _at_offset(x, offset):
    """A copy of ``x`` that starts ``offset`` bytes past a 64-byte
    boundary."""
    buffer = np.empty(x.nbytes + 128, np.uint8)
    start = (-buffer.ctypes.data) % 64 + offset
    out = buffer[start:start + x.nbytes].view(x.dtype).reshape(x.shape)
    out[...] = x
    return out


def _child(name, value):
    """The call's output in a child process with ``name=value`` set."""
    env = dict(os.environ, **{name: value})
    out = subprocess.run(
        [sys.executable, '-m', 'pb_bss_tpu_torch.testing.mvdr_drift',
         '--child'], env=env, check=True, capture_output=True).stdout
    return np.load(io.BytesIO(out))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--child', action='store_true',
                        help='write the call\'s output to stdout (npy)')
    args = parser.parse_args()
    observations = speech()
    if args.child:
        np.save(sys.stdout.buffer, separate(observations))
        return
    reference = separate(observations)
    rows = [('a second call', separate(observations))]
    for offset in (4, 8, 16, 32, 48):
        rows.append((f'observations {offset} bytes past 64',
                     separate(_at_offset(observations, offset))))
    caller = torch.get_float32_matmul_precision()
    for precision in ('high', 'medium'):
        torch.set_float32_matmul_precision(precision)
        rows.append((f'float32 matmul precision {precision!r}',
                     separate(observations)))
    torch.set_float32_matmul_precision(caller)
    threads = torch.get_num_threads()
    for n in sorted({1, 3, 8} - {threads}):
        torch.set_num_threads(n)
        rows.append((f'{n} threads', separate(observations)))
    torch.set_num_threads(threads)
    for name, value in CHILDREN:
        rows.append((f'{name}={value} (a child process)',
                     _child(name, value)))
    print(f'separate_batch(mvdr_souden+ban) on 3 x {SAMPLES} samples, '
          f'{threads} threads: change of each utterance / peak')
    for label, out in rows:
        print(f'  {label:44s} {np.array2string(drift(reference, out))}')


if __name__ == '__main__':
    main()
