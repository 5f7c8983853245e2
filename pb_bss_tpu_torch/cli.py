"""Command-line separation entry: ``python -m pb_bss_tpu_torch``.

Read a multichannel WAV, run :func:`pb_bss_tpu_torch.pipeline.separate`
on ``--device`` (default ``cuda``; a missing GPU is an error, never a
CPU run), and write one WAV per separated stream.

    python -m pb_bss_tpu_torch mixture.wav -k 3 -b gev+ban -o separated/

Audio IO uses ``soundfile`` when installed and falls back to
``scipy.io.wavfile`` (16-bit PCM output) otherwise.
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np

__all__ = ['main', 'build_parser']


def _read_wav(path):
    try:
        import soundfile
        data, sample_rate = soundfile.read(str(path), always_2d=True)
        return data.T.astype(np.float32), sample_rate   # (D, N)
    except ImportError:
        from scipy.io import wavfile
        sample_rate, data = wavfile.read(str(path))
        if data.ndim == 1:
            data = data[:, None]
        if np.issubdtype(data.dtype, np.integer):
            data = data / float(np.iinfo(data.dtype).max)
        return np.ascontiguousarray(data.T, np.float32), sample_rate


def _write_wav(path, signal, sample_rate):
    signal = np.asarray(signal, np.float32)
    try:
        import soundfile
        soundfile.write(str(path), signal, sample_rate)
    except ImportError:
        from scipy.io import wavfile
        peak = np.max(np.abs(signal))
        if peak > 1.0:
            signal = signal / peak
        wavfile.write(str(path), sample_rate,
                      (signal * 32767).astype(np.int16))


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m pb_bss_tpu_torch',
        description='Blind source separation of a multichannel WAV '
                    '(cACGMM EM + DHTV alignment + mask/beamformer '
                    'extraction) with PyTorch on a GPU.')
    parser.add_argument('input', type=pathlib.Path,
                        help='multichannel WAV file (channels = mics)')
    parser.add_argument('--num-classes', '-k', type=int, default=3,
                        help='mixture components incl. a noise class '
                             '(default 3 = 2 speakers + noise)')
    parser.add_argument('--iterations', '-i', type=int, default=20,
                        help='EM iterations (default 20)')
    parser.add_argument('--beamformer', '-b', default=None,
                        help='extraction beamformer, a get_bf_vector name: '
                             "'pca', 'pca+mvdr', 'scaled_gev_atf+mvdr', "
                             "'mvdr_souden', 'gev' or 'wmwf' (the last "
                             "three also after 'rank1_pca+' or "
                             "'rank1_gev+'), or 'chX', each with an "
                             "optional '+ban' suffix, e.g. 'gev+ban' or "
                             "'rank1_gev+mvdr_souden+ban' (default: mask "
                             'the reference channel)')
    parser.add_argument('--stft-size', type=int, default=512)
    parser.add_argument('--stft-shift', type=int, default=128)
    parser.add_argument('--output-dir', '-o', type=pathlib.Path,
                        default=None,
                        help='output directory (default: alongside '
                             'the input)')
    parser.add_argument('--seed', type=int, default=0,
                        help='seed of the EM initialization generator')
    parser.add_argument('--device', default='cuda',
                        help="torch device to run on (default 'cuda')")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    observation, sample_rate = _read_wav(args.input)
    if observation.shape[0] < 2:
        raise SystemExit(
            f'{args.input}: need a multichannel recording, got '
            f'{observation.shape[0]} channel(s) x '
            f'{observation.shape[-1]} samples — blind SPATIAL '
            f'separation has nothing to work with on mono audio.')

    import torch

    from .pipeline import separate

    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit(
            f'--device {args.device}: no CUDA device is available '
            "(pass --device cpu to run on the CPU)")
    generator = torch.Generator(device).manual_seed(args.seed)
    out = separate(
        torch.as_tensor(observation, device=device),
        num_classes=args.num_classes,
        iterations=args.iterations,
        beamformer=args.beamformer,
        stft_size=args.stft_size,
        stft_shift=args.stft_shift,
        generator=generator,
    ).cpu().numpy()

    out_dir = args.output_dir or args.input.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = args.input.stem
    paths = []
    for k in range(out.shape[0]):
        path = out_dir / f'{stem}_stream{k}.wav'
        _write_wav(path, out[k], sample_rate)
        paths.append(path)
    print('\n'.join(str(p) for p in paths))
    return paths


if __name__ == '__main__':  # pragma: no cover
    main()
