"""GPU smoke test of the PyTorch port (pb_bss_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from pb_bss_tpu_torch/csrc, holds
each against its plain PyTorch version on the card, drives the main
path (``separate_batch`` with the GEV+BAN beamformer, ``separate`` at
its defaults and the ``python -m pb_bss_tpu_torch`` CLI) with launch
counters reset just before, checks finiteness and separation quality,
and times kernels and the pipeline with CUDA events. Prints a JSON line
of per-kernel results, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
CUDA device, outside a checkout of the repository, or when any phase
fails. Imports nothing of JAX.
"""
from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / 'chiprun_out' / 'smoke'

# quality floors for separate_batch(8 utterances, 20 iterations,
# 'gev+ban'), per-frequency SI-SDR of the best estimate per speaker. The
# plain path on the CPU gives per-speaker batch means of 4.7 and 5.9 dB
# and a worst single estimate of -0.5 dB; EM trajectories on the card
# differ (different local optima per utterance), hence the margins.
MEAN_FLOOR_DB = 2.0
SINGLE_FLOOR_DB = -6.0


def log(*args):
    print(*args, flush=True)


def fail(message):
    print(f'chip_smoke: FAILED: {message}', file=sys.stderr, flush=True)
    sys.exit(1)


def sync():
    import torch
    torch.cuda.synchronize()


def cuda_time(fn, inputs, warmup=1):
    """Mean ms per call of fn(*inputs[i]) with CUDA events, a distinct
    input for every timed call."""
    import torch
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for args in inputs:
        fn(*args)
    end.record()
    sync()
    return start.elapsed_time(end) / len(inputs)


# ---------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------

def em_inputs(B, F, D, K, T, seed):
    """Unit-norm (B, F, D, T) two-source mixture plus a random initial
    affiliation and unit quadratic forms, made on the card."""
    import torch
    g = torch.Generator('cuda').manual_seed(seed)

    def cn(*shape):
        return torch.complex(
            torch.randn(shape, generator=g, device='cuda'),
            torch.randn(shape, generator=g, device='cuda'))

    y = torch.einsum('bfdk,bfkt->bfdt', cn(B, F, D, 2), cn(B, F, 2, T)) \
        + 0.3 * cn(B, F, D, T)
    y = y / torch.linalg.vector_norm(y, dim=-2, keepdim=True)
    aff = torch.rand((B, F, K, T), generator=g, device='cuda')
    aff = aff / aff.sum(-2, keepdim=True)
    qf = torch.ones_like(aff)
    return y, aff, qf


def pencils(B, D, seed, plant_non_pd=None):
    import torch
    g = torch.Generator('cuda').manual_seed(seed)

    def herm_pd(scale):
        a = torch.complex(
            torch.randn((B, D, D), generator=g, device='cuda'),
            torch.randn((B, D, D), generator=g, device='cuda'))
        eye = torch.eye(D, device='cuda', dtype=torch.complex64)
        return a @ a.conj().transpose(-1, -2) + scale * eye

    phi_xx, phi_nn = herm_pd(0.1), herm_pd(0.5)
    if plant_non_pd is not None:
        # singular noise PSD: a zero pivot makes the Cholesky non-finite,
        # and diagonal loading makes it positive definite
        singular = torch.ones(D, device='cuda')
        singular[-1] = 0
        phi_nn[plant_non_pd] = torch.diag(singular).to(phi_nn.dtype)
    return phi_xx, phi_nn


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke test needs '
             'a CUDA device')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f'nvidia-smi failed: {smi.stderr.strip()}'
    from pb_bss_tpu_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), '--version'],
                          capture_output=True, text=True)
    log('device:', torch.cuda.get_device_name(0), '| count',
        torch.cuda.device_count(), '| nvidia-smi:', card)
    log('python', sys.version.split()[0], '| torch', torch.__version__,
        '| torch.version.cuda', torch.version.cuda)
    log('nvcc:', (nvcc.stdout.strip().splitlines() or ['missing'])[-1])
    log('triton present:', importlib.util.find_spec('triton') is not None)
    return card


def phase_build():
    from pb_bss_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    log(f'build: {time.perf_counter() - t0:.1f} s for '
        f'{sorted(_build.KERNELS)}')
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'  ptxas {name}: {line.strip()}')


def check_em(B, F, D, K, T, seed):
    """K2 against its plain twin: one iteration tightly, 20 iterations
    by structure. Returns the one-iteration max abs affiliation error."""
    import torch
    from pb_bss_tpu_torch.ops.em_loop import (
        cacgmm_em_full, cacgmm_em_full_reference)
    y, aff, qf = em_inputs(B, F, D, K, T, seed)
    sweeps = 6 if D <= 8 else 8
    out_k = cacgmm_em_full(y, aff, qf, iterations=1, sweeps=sweeps,
                           warm_sweeps=2)
    out_p = cacgmm_em_full_reference(y, aff, qf, iterations=1,
                                     sweeps=sweeps)
    sync()
    err_w = (out_k[0] - out_p[0]).abs().max().item()
    err_e = (out_k[1] - out_p[1]).abs().max().item()
    err_a = (out_k[3] - out_p[3]).abs().max().item()
    overlap = torch.einsum('...de,...de->...e', out_k[2].conj(),
                           out_p[2]).abs().min().item()
    log(f'K2 1 iter  B={B} F={F} D={D} K={K} T={T}: weight {err_w:.2e} '
        f'eig {err_e:.2e} aff {err_a:.2e} min|v_k^H v_p| {overlap:.6f}')
    # one cold iteration: weights are means of the same affiliations;
    # eigenvalues and affiliations differ by f32 rounding of two
    # Jacobi/E-step orderings
    if not (err_w < 1e-5 and err_e < 1e-4 and err_a < 2e-3):
        fail(f'K2 one-iteration mismatch at {(B, F, D, K, T)}')

    out_k = cacgmm_em_full(y, aff, qf, iterations=20, sweeps=sweeps,
                           warm_sweeps=2)
    out_p = cacgmm_em_full_reference(y, aff, qf, iterations=20,
                                     sweeps=sweeps)
    sync()
    finite = all(bool(torch.isfinite(x).all()) for x in out_k)
    wsum = (out_k[0].sum(-1) - 1).abs().max().item()
    agree = (out_k[3].argmax(-2) == out_p[3].argmax(-2)).float().mean()
    log(f'K2 20 iter B={B} F={F} D={D} K={K} T={T}: finite {finite} '
        f'|sum w - 1| {wsum:.2e} argmax agreement {agree.item():.4f}')
    # trajectories diverge after many iterations (f32 rounding in
    # ambiguous bins), so the masks are held by agreement, not equality
    if not (finite and wsum < 1e-4 and agree.item() > 0.9):
        fail(f'K2 20-iteration check failed at {(B, F, D, K, T)}')
    return err_a


def aligned_error(beam, ref):
    """Max abs difference after removing each vector's arbitrary phase
    (finite vectors only)."""
    import torch
    ok = torch.isfinite(beam.abs()).all(-1) & torch.isfinite(ref.abs()).all(-1)
    inner = torch.einsum('bd,bd->b', ref[ok].conj(), beam[ok])
    phase = inner / inner.abs()
    return (beam[ok] / phase[:, None] - ref[ok]).abs().max().item()


def check_gev(B, D, seed, plant=3):
    import torch
    from pb_bss_tpu_torch.extraction.beamformer import get_gev_vector
    from pb_bss_tpu_torch.ops.gev import gev, gev_reference
    phi_xx, phi_nn = pencils(B, D, seed, plant_non_pd=plant)
    beam = gev(phi_xx, phi_nn)
    ref = gev_reference(phi_xx, phi_nn)
    sync()
    ok_k = torch.isfinite(beam.abs()).all(-1)
    ok_p = torch.isfinite(ref.abs()).all(-1)
    err = aligned_error(beam, ref)
    bnb = torch.einsum('bd,bde,be->b', beam[ok_k].conj(), phi_nn[ok_k],
                       beam[ok_k])
    bnorm = (bnb - 1).abs().max().item()
    retry = get_gev_vector(phi_xx, phi_nn)
    sync()
    log(f'K3 B={B} D={D}: planted non-PD finite (kernel, plain) '
        f'({bool(ok_k[plant])}, {bool(ok_p[plant])}); others finite '
        f'{int(ok_k.sum())}/{B - 1}; max|err| after phase {err:.2e}; '
        f'|w^H N w - 1| {bnorm:.2e}; retry finite '
        f'{bool(torch.isfinite(retry.abs()).all())}')
    if ok_k[plant] or ok_p[plant] or int(ok_k.sum()) != B - 1:
        fail('K3 non-PD handling differs from the plain version')
    if not (err < 1e-3 and bnorm < 1e-3):
        fail(f'K3 mismatch: err {err}, B-normalization {bnorm}')
    if not torch.isfinite(retry.abs()).all():
        fail('K3 diagonal-loading retry left non-finite vectors')
    return err


def phase_kernels():
    results = {}
    results['em_bench'] = check_em(8, 513, 6, 3, 300, seed=1)
    results['em_slice'] = check_em(8, 257, 6, 3, 304, seed=2)
    check_em(1, 257, 6, 3, 304, seed=3)
    check_em(1, 65, 4, 2, 123, seed=4)
    check_em(1, 65, 8, 4, 150, seed=5)
    results['gev_513'] = check_gev(513, 6, seed=6)
    check_gev(8 * 257, 6, seed=9)
    results['gev_slice'] = check_gev(8 * 257 * 3, 6, seed=7)
    check_gev(100, 3, seed=8)
    return results


def phase_guards():
    """Routes the port has not ported raise on CUDA instead of running
    plain code on the card."""
    import torch
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer
    from pb_bss_tpu_torch.ops.linalg import eigh
    a = torch.eye(6, dtype=torch.complex64, device='cuda').repeat(64, 1, 1)
    g = torch.Generator('cuda').manual_seed(0)
    y_long = torch.randn((3, 4000, 6), dtype=torch.complex64,
                         device='cuda', generator=g)
    for name, call in (
            ('eigh auto (K1)', lambda: eigh(a)),
            ('fit past the T gate (K4)',
             lambda: CACGMMTrainer().fit(y_long, num_classes=3,
                                         iterations=1)),
            ('frequency-constant weights (K5)',
             lambda: CACGMMTrainer().fit(
                 y_long[:, :300], num_classes=3, iterations=1,
                 weight_constant_axis=(-3, -1)))):
        try:
            call()
        except NotImplementedError as e:
            log(f'guard {name}: NotImplementedError ({str(e)[:60]}...)')
        else:
            fail(f'{name} did not raise NotImplementedError on CUDA')


def load_utterances(seeds):
    import numpy as np
    import torch
    from pb_bss_tpu_torch.testing import low_reverberation_data
    data = [low_reverberation_data(seed=s) for s in seeds]
    obs = torch.as_tensor(
        np.stack([d['observation'] for d in data]), dtype=torch.float32)
    images = torch.as_tensor(
        np.stack([d['speech_image'][:, 0] for d in data]))
    return obs, images


def phase_main_path():
    import torch
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.evaluation import si_sdr, si_sdr_stft
    from pb_bss_tpu_torch.ops.em_loop import cacgmm_em_full
    from pb_bss_tpu_torch.ops.gev import gev

    obs, images = load_utterances(range(8))
    obs = obs.cuda()
    sync()
    cacgmm_em_full.launches = 0
    gev.launches = 0
    out = P.separate_batch(obs, num_classes=3, iterations=20,
                           beamformer='gev+ban')
    sync()
    launches = {'cacgmm_em_full': cacgmm_em_full.launches,
                'gev': gev.launches}
    log(f'main path separate_batch(8 x {tuple(obs.shape[1:])}, '
        f"'gev+ban', 20 it) -> {tuple(out.shape)}; launches {launches}")
    if any(n == 0 for n in launches.values()):
        fail(f'a kernel of the main path was not launched: {launches}')
    if not bool(torch.isfinite(out).all()):
        fail('separate_batch output is not finite')
    scores = si_sdr_stft(images[:, :, None],
                         out.cpu().double()[:, None]).max(-1).values
    log('per-frequency SI-SDR (dB), best estimate per speaker:',
        [[round(v, 2) for v in row] for row in scores.tolist()])
    means = scores.mean(0)
    log('batch mean per speaker:', [round(v, 2) for v in means.tolist()])
    if not (bool((means >= MEAN_FLOOR_DB).all())
            and bool((scores >= SINGLE_FLOOR_DB).all())):
        fail(f'separation quality below the floor ({MEAN_FLOOR_DB} dB '
             f'mean, {SINGLE_FLOOR_DB} dB single)')

    single = P.separate(obs[0])
    sync()
    if single.shape != (3, obs.shape[-1]) or \
            not bool(torch.isfinite(single).all()):
        fail(f'separate() at its defaults gave {tuple(single.shape)} or '
             'non-finite output')
    mask_scores = si_sdr(images[0][:, None],
                         single.cpu().double()[None]).max(-1).values
    log('separate() defaults (mask, 80 it): SI-SDR per speaker',
        [round(v, 2) for v in mask_scores.tolist()])

    phase_cli(obs[0].cpu().numpy())
    return launches


def phase_cli(observation):
    import numpy as np
    from scipy.io import wavfile
    OUT.mkdir(parents=True, exist_ok=True)
    wav = OUT / 'mixture.wav'
    peak = np.abs(observation).max()
    wavfile.write(wav, 8000, (observation.T / peak * 0.9 * 32767)
                  .astype(np.int16))
    out_dir = OUT / 'separated'
    for old in out_dir.glob('*.wav'):
        old.unlink()
    result = subprocess.run(
        [sys.executable, '-m', 'pb_bss_tpu_torch', str(wav), '-k', '3',
         '-b', 'gev+ban', '-o', str(out_dir)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    files = sorted(out_dir.glob('*.wav'))
    log(f'CLI rc {result.returncode}, wrote {[f.name for f in files]}')
    if result.returncode != 0:
        fail(f'CLI failed:\n{result.stderr[-2000:]}')
    if len(files) != 3:
        fail(f'CLI wrote {len(files)} files, expected 3')
    for f in files:
        _, data = wavfile.read(f)
        if not (np.isfinite(data).all() and np.abs(data).max() > 0):
            fail(f'{f.name} is not a finite, non-silent signal')


def phase_timing(errors, launches):
    import torch
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.ops.em_loop import (
        cacgmm_em_full, cacgmm_em_full_reference)
    from pb_bss_tpu_torch.ops.gev import gev, gev_reference

    def em_times(B, F, T, reps_kernel, reps_plain, seed):
        inputs = [em_inputs(B, F, 6, 3, T, seed + i)
                  for i in range(reps_kernel + 1)]
        ms = cuda_time(lambda y, a, q: cacgmm_em_full(
            y, a, q, iterations=20, sweeps=6, warm_sweeps=2), inputs)
        plain = cuda_time(lambda y, a, q: cacgmm_em_full_reference(
            y, a, q, iterations=20, sweeps=6), inputs[:reps_plain + 1],
            warmup=1)
        return ms, plain

    def gev_times(B, seed):
        inputs = [pencils(B, 6, seed + i) for i in range(6)]
        return (cuda_time(gev, inputs),
                cuda_time(gev_reference, inputs[:3]))

    bench_ms, bench_plain = em_times(8, 513, 300, 5, 2, 100)
    log(f'timing K2 bench cell B=8 F=513 D=6 K=3 T=300, 20 it: kernel '
        f'{bench_ms:.3f} ms ({20e3 / bench_ms:.1f} iters/s), plain '
        f'{bench_plain:.3f} ms ({20e3 / bench_plain:.1f} iters/s)')
    slice_ms, slice_plain = em_times(8, 257, 304, 5, 2, 200)
    log(f'timing K2 slice B=8 F=257 T=304, 20 it: kernel {slice_ms:.3f} '
        f'ms, plain {slice_plain:.3f} ms')
    g513_ms, g513_plain = gev_times(513, 300)
    log(f'timing K3 513 pencils: kernel {g513_ms:.4f} ms, plain '
        f'{g513_plain:.4f} ms')
    gslice_ms, gslice_plain = gev_times(8 * 257 * 3, 400)
    log(f'timing K3 6168 pencils (separate_batch shape): kernel '
        f'{gslice_ms:.4f} ms, plain {gslice_plain:.4f} ms')

    # end to end: host clock around synchronized separate_batch calls,
    # distinct utterances per repetition
    batches = [load_utterances(range(8 * r, 8 * r + 8))[0].cuda()
               for r in range(1, 4)]
    P.separate_batch(batches[0], iterations=20, beamformer='gev+ban')
    sync()
    times = []
    for obs in batches:
        t0 = time.perf_counter()
        P.separate_batch(obs, iterations=20, beamformer='gev+ban')
        sync()
        times.append(time.perf_counter() - t0)
    per_utt = [1e3 * t / 8 for t in times]
    log('timing e2e separate_batch(8, gev+ban, 20 it): ms per utterance '
        f'{[round(t, 2) for t in per_utt]}')

    return [
        {'name': 'cacgmm_em_full', 'route': 'cuda',
         'source': 'pb_bss_tpu_torch/csrc/em_loop.cu',
         'replaces': 'pb_bss_tpu/ops/pallas_em_loop.py:386',
         'launches': launches['cacgmm_em_full'],
         'max_abs_err': errors['em_slice'], 'ms': slice_ms,
         'plain_ms': slice_plain},
        {'name': 'gev', 'route': 'cuda',
         'source': 'pb_bss_tpu_torch/csrc/gev.cu',
         'replaces': 'pb_bss_tpu/ops/pallas_gev.py:176',
         'launches': launches['gev'],
         'max_abs_err': errors['gev_slice'], 'ms': gslice_ms,
         'plain_ms': gslice_plain},
    ]


def main():
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke test needs '
             'a CUDA device')
    if importlib.util.find_spec('pb_bss_tpu_torch') is None:
        sys.path.insert(0, str(ROOT))
        if importlib.util.find_spec('pb_bss_tpu_torch') is None:
            fail('pb_bss_tpu_torch not found: run from a checkout of the '
                 'repository')
    try:
        card = phase_device()
        phase_build()
        errors = phase_kernels()
        sync()
        phase_guards()
        launches = phase_main_path()
        kernels = phase_timing(errors, launches)
        sync()
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        fail('a phase raised')
    if 'jax' in sys.modules:
        fail('jax was imported')
    if any(not math.isfinite(k[f]) for k in kernels
           for f in ('max_abs_err', 'ms', 'plain_ms')):
        fail(f'non-finite kernel result: {kernels}')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
