"""GPU smoke test of the PyTorch port (pb_bss_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from pb_bss_tpu_torch/csrc (one
nvcc per source, all at once), holds each against its plain PyTorch
version on the card (the four cACGMM kernels also with an eigenvalue at
the floor, pb_bss_tpu_torch.testing.em_floor), and drives ten paths,
each with the launch counters reset just before and read just after:

* the short-recording path: ``separate_batch`` of 4.8 s utterances
  with the GEV+BAN beamformer (whole-fit EM kernel, GEV kernel once,
  the loading retry inside it),
  ``separate`` at its defaults and the ``python -m pb_bss_tpu_torch``
  CLI;
* the evaluation stage after it: ``separate_batch`` of the same
  utterances (K2, K3 once), then ``OutputMetricsBatch`` of its CUDA
  output (BSS-Eval with the K+1 routing, the STOI of its selection,
  SI-SDR, SRMR) and ``InputMetricsBatch`` of the observations on the
  card, each held against the port's host float64 oracles; the metric
  stages timed beside the JAX package's bench configs 5b and 5c; the
  gammatone filterbank and Griffin-Lim / MISI against the CPU;
* the extraction layer: ``separate_batch`` of the same utterances with
  the MVDR (Souden, ATF with a PCA or GEV ATF), wMWF, rank-1, PCA and
  channel beamformers (the Jacobi kernel for each PCA and each stable
  solve's pseudo-inverse, the GEV kernel for each GEV estimate),
  ``get_bf_vector`` of each against the CPU, ``stable_solve`` at 6,168
  systems with no host sync and ``quantile_mask`` above 2^24 elements;
  and the FCA refinement, ``separate_batch(refine='fca')`` (the Jacobi
  kernel once per IP row and iteration);
* the streaming separator: ``StreamingSeparator`` at its defaults on
  a 60 s recording in chunks of 4,096 samples, in mask mode and with
  the GEV+BAN beamformer (the whole-fit EM kernel once for the warm-up,
  the Jacobi kernel in each streamed block's M-step, the GEV kernel once
  a beamformed block), with its reconstruction, snapshot and resume,
  chunking, card-against-CPU and quality checks, and the rest of the
  model surface (GMM, k-means, vMF mixture, complex Gaussian, the cACG
  trainer, the cACGMM sampler and log-likelihood) against the CPU;
* the last modules: ``parallel`` on a world of size 1 over NCCL,
  ``separate_batch(mesh=)`` on the 4.8 s utterances (whole-fit EM
  kernel, GEV kernel once) against the meshless call with the host and
  device ms of both, ``fit_cacgmm_sharded`` with frequency-constant
  weights (the per-iteration EM kernels) and ``fit_integration_sharded``
  (the integration statistics kernel, the Jacobi kernel) against the
  same fits without a mesh; the trainers' DTensor entry
  (``CACGMMTrainer`` / ``CWMMTrainer`` / ``CBMMTrainer().fit`` of the
  4.8 s utterances as a DTensor: the whole-fit EM, Watson and Bingham
  kernels; ``VMFCACGMMTrainer().fit`` at config 3: the integration
  statistics and Jacobi kernels) and ``fit_integration_sharded(
  use_fused_em='loop')`` (the whole-fit integration kernel on every
  bin), each bit for bit against its meshless fit; ``deflationSeed``
  (the Jacobi kernel) and ``flag`` against the CPU,
  ``utils.profiling.trace`` around one ``separate``, ``stft`` /
  ``istft`` with each ``method=`` against the default call, and the four
  examples of the port (``examples/*_torch.py``) through their
  ``main``;
* the long-recording path: ``separate_batch`` of 60 s recordings
  (streamed EM statistics kernel and batched Jacobi kernel, GEV
  kernel), ``separate`` at its defaults and the CLI on one of them, and
  the plain EM loop (``use_fused_em=False``) on the card, whose M-step
  runs the Jacobi kernel;
* the rest of the cACGMM trainer: ``CACGMMTrainer.fit`` with
  frequency-constant weights (the per-iteration EM kernels) on a batch
  of 8 at the JAX package's benchmark shape, resumed from its model,
  ``fit_predict`` with the inline Greedy and DHTV aligners on one 4.8 s
  utterance, ``fit(use_pallas_em=True)`` (the E-step scatter kernel and
  the Jacobi kernel) and the public E-step kernel ``cacgmm_e_step``;
* the complex Watson mixture: ``separate_batch(model='cwmm')`` of the
  4.8 s utterances and of the 60 s recordings (whole-fit Watson EM
  kernel, GEV kernel), ``CWMMTrainer.fit`` at T=4000 and with
  frequency-constant weights (streamed Watson statistics kernel, Jacobi
  kernel);
* the complex Bingham mixture: ``separate_batch(model='cbmm')`` of the
  4.8 s utterances (whole-fit Bingham EM kernel, GEV kernel), the
  warm-start recipe from cACGMM posteriors and its control,
  ``CBMMTrainer.fit`` at T=4000 and with frequency-constant weights
  (streamed Bingham statistics, Jacobi and chord-solve kernels) and its
  scan path with an inline aligner (Jacobi and chord-solve kernels);
* the integration models: ``VMFCACGMMTrainer.fit`` (unbatched and at
  B=8) and ``GCACGMMTrainer.fit`` at the JAX package's bench config 3,
  by default (the per-iteration statistics kernel and the Jacobi kernel)
  and with ``use_fused_em='loop'`` (the whole-fit integration kernel),
  and ``VMFCACGMMTrainer.fit_predict`` on the 4.8 s utterances with
  oracle embeddings against its control.

It checks finiteness and separation quality, and times kernels and
pipeline with CUDA events. Prints a JSON line of per-kernel results
(with each kernel's least possible time on the card, computed from the
bytes and operations of this run's inputs), the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``. Exits
non-zero without a CUDA device, outside a checkout of the repository,
or when any phase fails. Imports nothing of JAX.

    python3 chip_smoke.py --only floor,cacgmm,cbmm,cwmm,integration,splits,e2e,eigh,integration_stats,eigh_stats_splits,gev_estep_splits,extraction_checks,extraction,streaming,surface,parallel,evaluation \
        [--package DIR]

runs only the named phases after the build (the floor checks, the cACGMM
kernels' checks, the whole-fit Bingham, Watson and integration kernels'
checks, the split of the time of the whole-fit and streamed cACGMM EM
kernels, the whole-fit Bingham EM, the frequency-constant EM, the
streamed Watson and Bingham statistics, the Bingham chord solve, the
whole-fit Watson EM, the whole-fit integration EM, the batched Jacobi
and the integration statistics pass, the cACGMM separate_batch end to
end, the batched Jacobi's checks, the integration statistics pass's
checks, the split of the last two alone, the split of the GEV and the
E-step kernels alone, the extraction and FCA checks, the timing of
``separate_batch`` per extraction route, of ``stable_solve`` and of the
FCA fit, the streaming checks with the stream's block timings, the model
surface, the parallel module on a world of size 1 with the DTensor fits,
the initializers, the profiler's trace, the STFT's ``method=`` values
and the four examples, the evaluation stage), with ``pb_bss_tpu_torch`` imported from DIR
if given (another checkout, to time two versions in one call); it prints
no kernels line.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time
import traceback

from sepbench.harness.counts import bound, em_flops, jacobi_flops, nbytes

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / 'chiprun_out' / 'smoke'

# quality floors for separate_batch(8 utterances, 20 iterations,
# 'gev+ban'), per-frequency SI-SDR of the best estimate per speaker. The
# plain path on the CPU gives per-speaker batch means of 4.7 and 5.9 dB
# and a worst single estimate of -0.5 dB; EM trajectories on the card
# differ (different local optima per utterance), hence the margins.
MEAN_FLOOR_DB = 2.0
SINGLE_FLOOR_DB = -6.0

# a 60 s, 6-channel recording at 8 kHz: 13 concatenated dummy scenarios
# of 38,520 samples, cut to length (T = 3753 STFT frames at 512/128)
LONG_SAMPLES = 480_000
LONG_PIECES = 13
# quality floors for separate_batch(4 x 60 s, 20 iterations,
# 'gev+ban'), the same metric as above. The plain path on the CPU gives
# per-speaker batch means of -8.1 and -7.2 dB and a worst single
# estimate of -10.0 dB on these recordings (the JAX package gives -6.1
# and -3.4 dB on the first; the mixture's reference channel itself
# scores -2.2 and 2.1 dB): the EM separates this synthetic minute
# poorly in both packages, so the floors only catch a broken path.
LONG_MEAN_FLOOR_DB = -11.0
LONG_SINGLE_FLOOR_DB = -15.5

# quality floors for separate_batch(8 utterances, 20 iterations,
# 'gev+ban', model='cwmm'), the same metric as the cACGMM floors. The
# port's plain path on the CPU gives per-speaker batch means of 7.75 and
# 8.63 dB and a worst single estimate of 3.34 dB (JAX's separate(model=
# 'cwmm'): 7.86, 9.15 and 3.23 dB; tests/test_torch_pipeline.py::
# test_cwmm_quality_on_the_smoke_utterances, slow tier, prints both); EM
# trajectories on the card differ, hence the margins.
CWMM_MEAN_FLOOR_DB = 4.5
CWMM_SINGLE_FLOOR_DB = -3.0

# quality floors for the frequency-constant fit with an inline aligner
# on one 4.8 s utterance (20 iterations, masks at the reference channel,
# no alignment afterwards), SI-SDR of the best estimate per speaker. The
# port's plain path on the CPU (python -m
# pb_bss_tpu_torch.testing.inline_quality --device cpu) gives 1.10 and
# 12.94 dB with Greedy, 6.81 and 14.76 dB with DHTV, and -4.73 and 9.04
# dB (mean 2.16) for the control, the same fit with no aligner: a
# mapping that is not applied scores like the control. The floors sit
# between the control and the aligned fits, and the control is run on
# the card too, to show that they part the two there.
INLINE_MEAN_FLOOR_DB = 4.5
INLINE_SINGLE_FLOOR_DB = -2.0

# quality floors (mean per speaker, single estimate) for separate_batch(8
# utterances, 20 iterations) with each extraction route, per-frequency
# SI-SDR of the best estimate per speaker. The port's plain path on the
# CPU gives (batch means per speaker; worst single), beside JAX's
# separate on each utterance (tests/test_torch_pipeline.py::
# test_extraction_quality_on_the_smoke_utterances, slow tier):
#   mvdr_souden                5.76  6.16; -5.29   (JAX 4.72 4.50; -2.69)
#   mvdr_souden+ban            3.88  6.15; -2.75   (JAX 4.83 4.89; -1.40)
#   wmwf                       5.74  6.16; -5.29   (JAX 4.78 4.15; -3.00)
#   rank1_gev+mvdr_souden+ban  4.77  5.92; -0.47   (JAX 4.58 5.00; -1.47)
#   scaled_gev_atf+mvdr        0.84  2.32; -5.82   (JAX 1.17 2.30; -4.14)
#   rank1_pca+mvdr_souden      5.94  4.92; -6.09   (JAX 4.74 4.16; -3.07)
#   pca+mvdr                   4.49  5.70; -3.87   (JAX 4.80 4.90; -2.97)
#   pca                        3.68  4.28; -3.06   (JAX 3.94 4.13; -2.84)
#   ch0                       -6.51  6.00; -17.06  (JAX the same: the
#                                                   mixture's channel 0)
# EM trajectories on the card differ (different local optima per
# utterance), hence margins as wide as the 'gev+ban' floors'.
EXTRACTION_FLOORS_DB = {
    'mvdr_souden': (2.0, -10.0), 'mvdr_souden+ban': (1.5, -8.0),
    'wmwf': (2.0, -10.0), 'rank1_gev+mvdr_souden+ban': (2.0, -6.0),
    'scaled_gev_atf+mvdr': (-1.5, -11.0),
    'rank1_pca+mvdr_souden': (2.0, -11.0), 'pca+mvdr': (2.0, -9.0),
    'pca': (1.0, -8.0), 'ch0': (-7.0, -17.5)}
# quality floors for separate_batch(8 utterances, 20 iterations,
# refine='fca', 20 refinement iterations), the plain (time-domain)
# SI-SDR of the best estimate per speaker, as the mask path's: the
# port's CPU run gives batch means of 2.34 and 9.48 dB and a worst
# single estimate of -6.87 dB (JAX: 1.24, 9.56 and -10.33; the same
# slow test). As the JAX package, the smoke also holds the refinement
# by bss_eval's SDR: refined >= masked - FCA_BSS_MARGIN_DB.
FCA_MEAN_FLOOR_DB = -0.5
FCA_SINGLE_FLOOR_DB = -13.0
FCA_BSS_MARGIN_DB = 0.5


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
    phase_device.card = card
    return card


def phase_build():
    from pb_bss_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    log(f'build: {time.perf_counter() - t0:.1f} s for '
        f'{sorted(_build.KERNELS)}')
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if any(key in line for key in ('registers', 'spill', 'took',
                                           'entry function')):
                log(f'  ptxas {name}: {line.strip()}')


def check_em(B, F, D, K, T, seed, extras=False):
    """K2 against its plain twin: one iteration tightly, 20 iterations
    by structure. With ``extras``: saliency and a source-activity mask
    that silences a class in 16 bins, affiliation_eps=0 (its sum is then
    exactly 0 there: the 0 * inf hazard at D >= 5). Returns the
    one-iteration max abs affiliation error."""
    import torch
    from pb_bss_tpu_torch.ops.em_loop import (
        cacgmm_em_full, cacgmm_em_full_reference)
    if extras:
        y, aff, qf, sal, sam = fold_inputs(B, F, D, K, T, seed,
                                           saliency=True, mask=True)
        kw = dict(saliency=sal, source_activity_mask=sam,
                  affiliation_eps=0.)
    else:
        y, aff, qf = em_inputs(B, F, D, K, T, seed)
        kw = {}
    sweeps = 6 if D <= 8 else 8
    out_k = cacgmm_em_full(y, aff, qf, iterations=1, sweeps=sweeps,
                           warm_sweeps=2, **kw)
    out_p = cacgmm_em_full_reference(y, aff, qf, iterations=1,
                                     sweeps=sweeps, **kw)
    sync()
    err_w = (out_k[0] - out_p[0]).abs().max().item()
    err_e = (out_k[1] - out_p[1]).abs().max().item()
    err_a = (out_k[3] - out_p[3]).abs().max().item()
    overlap = torch.einsum('...de,...de->...e', out_k[2].conj(),
                           out_p[2]).abs().min().item()
    label = (f'B={B} F={F} D={D} K={K} T={T}'
             f'{" +saliency +mask (class silenced, eps 0)" if extras else ""}')
    log(f'K2 1 iter  {label}: weight {err_w:.2e} '
        f'eig {err_e:.2e} aff {err_a:.2e} min|v_k^H v_p| {overlap:.6f}')
    # one cold iteration: weights are means of the same affiliations;
    # eigenvalues and affiliations differ by f32 rounding of two
    # Jacobi/E-step orderings
    if not (err_w < 1e-5 and err_e < 1e-4 and err_a < 2e-3):
        fail(f'K2 one-iteration mismatch at {label}')
    if extras and not bool((out_k[3][sam == 0] == 0).all()):
        fail(f'K2 posterior not gated by the mask at {label}')

    out_k = cacgmm_em_full(y, aff, qf, iterations=20, sweeps=sweeps,
                           warm_sweeps=2, **kw)
    out_p = cacgmm_em_full_reference(y, aff, qf, iterations=20,
                                     sweeps=sweeps, **kw)
    sync()
    finite = all(bool(torch.isfinite(x).all()) for x in out_k)
    wsum = (out_k[0].sum(-1) - 1).abs().max().item()
    agree = (out_k[3].argmax(-2) == out_p[3].argmax(-2)).float().mean()
    log(f'K2 20 iter {label}: finite {finite} '
        f'|sum w - 1| {wsum:.2e} argmax agreement {agree.item():.4f}')
    # trajectories diverge after many iterations (f32 rounding in
    # ambiguous bins), so the masks are held by agreement, not equality
    if not (finite and wsum < 1e-4 and agree.item() > 0.9):
        fail(f'K2 20-iteration check failed at {label}')
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
    """K3 against its twin with a planted non-PD pencil, and
    get_gev_vector on the card: one K3 launch, whose finite pencils keep
    the unloaded vector and whose planted pencil takes the loaded vector
    of the twin's two-call composition (gev_with_retry_reference). At
    D=1 the planted noise PSD is 0, which loading cannot lift: non-finite
    in both."""
    import torch
    from pb_bss_tpu_torch.extraction.beamformer import (
        RETRY_LOADING, get_gev_vector)
    from pb_bss_tpu_torch.ops.gev import (
        gev, gev_reference, gev_with_retry_reference)
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
    before = gev.launches
    retry = get_gev_vector(phi_xx, phi_nn)
    sync()
    retry_launches = gev.launches - before
    composed = gev_with_retry_reference(phi_xx, phi_nn, RETRY_LOADING)
    fin_r = torch.isfinite(retry.abs()).all(-1)
    fin_c = torch.isfinite(composed.abs()).all(-1)
    kept = torch.equal(retry[ok_k], beam[ok_k])
    err_r = aligned_error(retry, composed)
    log(f'K3 B={B} D={D}: planted non-PD finite (kernel, plain) '
        f'({bool(ok_k[plant])}, {bool(ok_p[plant])}); others finite '
        f'{int(ok_k.sum())}/{B - 1}; max|err| after phase {err:.2e}; '
        f'|w^H N w - 1| {bnorm:.2e}; get_gev_vector: {retry_launches} '
        f'launch, finite {int(fin_r.sum())}/{B} (composition '
        f'{int(fin_c.sum())}), unloaded vectors kept {kept}, max|err| '
        f'after phase against the composition {err_r:.2e}')
    if ok_k[plant] or ok_p[plant] or int(ok_k.sum()) != B - 1:
        fail('K3 non-PD handling differs from the plain version')
    if not (err < 1e-3 and bnorm < 1e-3):
        fail(f'K3 mismatch: err {err}, B-normalization {bnorm}')
    if retry_launches != 1:
        fail(f'get_gev_vector launched K3 {retry_launches} times')
    if not (torch.equal(fin_r, fin_c) and bool(fin_r.all()) == (D > 1)
            and kept and err_r < 1e-3):
        fail(f'K3 diagonal-loading retry at B={B} D={D} differs from the '
             'two-call composition')
    return err


def hermitian_batch(B, D, seed, dtype=None):
    """B random Hermitian positive semi-definite D x D matrices
    (complex64, or float32 symmetric)."""
    import torch
    g = torch.Generator('cuda').manual_seed(seed)
    x = torch.randn((B, D, D), generator=g, device='cuda')
    if dtype in (None, torch.complex64):
        x = torch.complex(x, torch.randn((B, D, D), generator=g,
                                         device='cuda'))
    return x @ x.conj().transpose(-1, -2) / D


def same_bits(a, b):
    """Equal entry for entry, NaN where the other is NaN."""
    import torch
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_eigh(B, D, seed, dtype=None, plant=False, sort=True,
               kind='random'):
    """K1 against its plain twin, with ``sort`` on or off. With
    ``plant``, the first matrices are identities and diagonal matrices
    with repeated eigenvalues, which must come out exactly diagonal (and
    stably sorted). ``kind`` 'tiny' scales the batch by 1e-20 (the
    eigenvalues and the factorization are held relative to each matrix's
    scale); 'nan' puts a NaN matrix and a matrix with one NaN entry in
    the batch, whose NaN eigenvalues must come last while the other
    matrices match the twin. Without ``sort``, the kernel's sorted call
    must be its unsorted one stably sorted, bit for bit. Returns the max
    abs eigenvalue error."""
    import torch
    from pb_bss_tpu_torch.ops.eigh import eigh_jacobi, eigh_jacobi_reference
    a = hermitian_batch(B, D, seed, dtype)
    eye = torch.eye(D, device='cuda', dtype=a.dtype)
    if plant:
        a[:8] = eye
        # diag(2, 1, 2, 1, ...): ascending, ties keep the lower index
        diag = torch.tensor([2., 1.] * (D // 2) + [2.] * (D % 2),
                            device='cuda')
        a[8:16] = torch.diag(diag).to(a.dtype)
    if kind == 'tiny':
        a = a * 1e-20
    nan_rows = torch.zeros(B, dtype=torch.bool, device='cuda')
    if kind == 'nan':
        a[20] = float('nan')
        a[21, 0, 0] = float('nan')
        nan_rows[20:22] = True
    w_k, v_k = eigh_jacobi(a)
    w_p, v_p = eigh_jacobi_reference(a)
    if not sort:
        # the Jacobi's order: the kernel's sorted call is its stable sort,
        # bit for bit (the twin's unsorted order can part where a sweep
        # meets a near tie, so the twin is held sorted)
        w_u, v_u = eigh_jacobi(a, sort=False)
        order = torch.sort(w_u, dim=-1, stable=True).indices
        sorted_u = (same_bits(torch.gather(w_u, -1, order), w_k)
                    and same_bits(torch.gather(
                        v_u, -1, order[:, None].expand_as(v_u)), v_k))
    sync()
    ok = ~nan_rows
    # held at the unscaled size: squares of 1e-20 would be subnormal
    scale = 1e-20 if kind == 'tiny' else 1.
    wk, wp, vk, ak = w_k[ok] / scale, w_p[ok] / scale, v_k[ok], a[ok] / scale
    lam_max = wp.abs().max(-1).values.clamp(min=1e-30)
    err_w = (wk - wp).abs().max().item()
    rel_w = ((wk - wp).abs().max(-1).values / lam_max).max().item()
    recon = vk @ torch.diag_embed(wk).to(a.dtype) @ vk.conj() \
        .transpose(-1, -2) - ak
    rel_r = (torch.linalg.matrix_norm(recon)
             / torch.linalg.matrix_norm(ak).clamp(min=1e-30)).max().item()
    orth = (vk.conj().transpose(-1, -2) @ vk - eye).abs().max().item()
    label = (f'B={B} D={D} {a.dtype} sort={sort}'
             f'{"" if kind == "random" else " " + kind}')
    log(f'K1 {label}: max|w_k - w_p| / lam_max {rel_w:.2e} '
        f'({err_w:.2e} abs); |V diag(w) V^H - A| / |A| {rel_r:.2e}; '
        f'|V^H V - I| {orth:.2e}; dtypes {w_k.dtype} {v_k.dtype}')
    if v_k.dtype != a.dtype or w_k.dtype != torch.float32:
        fail(f'K1 output dtypes {w_k.dtype}, {v_k.dtype} for {a.dtype}')
    if not sort:
        log(f'K1 {label}: the sorted call is the unsorted one stably sorted, '
            f'bit for bit: {sorted_u}')
        if not sorted_u:
            fail(f'K1 sort=False and sort=True part at {label}')
    # two f32 Jacobi runs of the same rotations in another order of
    # rounding: eigenvalues within 2e-5 of the largest, factorization
    # and orthonormality within 1e-4
    if not (rel_w <= 2e-5 and rel_r <= 1e-4 and orth <= 1e-4):
        fail(f'K1 mismatch at {label}')
    if kind == 'nan':
        # NaN after every number, in both; the NaN matrix keeps V = I
        nan_k = torch.isnan(w_k[20:22])
        last = bool((nan_k.int().diff(dim=-1) >= 0).all())
        same = torch.equal(nan_k, torch.isnan(w_p[20:22]))
        ident = torch.equal(v_k[20], eye)
        log(f'K1 {label}: NaN eigenvalues {nan_k.int().tolist()}, last '
            f'{last}, as the twin {same}; the NaN matrix keeps V = I '
            f'{ident}')
        if not (last and same and ident):
            fail(f'K1 NaN rows at {label}')
    if plant:
        diagonal = torch.diagonal(a[:16], dim1=-2, dim2=-1).real
        order = torch.sort(diagonal, dim=-1, stable=True).indices
        w_o, v_o = (w_k, v_k) if sort else (w_u, v_u)
        if not sort:
            order = torch.arange(D, device='cuda').expand(16, D)
        exact = (torch.equal(w_o[:16], torch.gather(diagonal, -1, order))
                 and torch.equal(v_o[:16], eye[:, order].permute(1, 0, 2)
                                 .to(a.dtype)))
        log(f'K1 {label} planted identity and repeated-eigenvalue blocks '
            f'exact: {exact}')
        if not exact:
            fail('K1 planted diagonal matrices did not come out exactly '
                 f'diagonal (and stably sorted) at {label}')
    return err_w


def phase_kernels_eigh():
    """K1 against its twin: the long path's M-step shape (4 x 257 bins x
    3 classes) with planted diagonal matrices, every D in {1, 2, 3, 6, 8,
    16} in complex64 and float32 with the sort on and off, and at D=6 a
    batch scaled by 1e-20 and one holding NaN matrices. Returns the max
    abs eigenvalue error at the long path's shape."""
    import torch
    err = check_eigh(4 * 257 * 3, 6, seed=10, plant=True)
    seed = 200
    for D in (1, 2, 3, 6, 8, 16):
        for dtype in (torch.complex64, torch.float32):
            for sort in (True, False):
                seed += 1
                check_eigh(300, D, seed, dtype, plant=True, sort=sort)
    for dtype in (torch.complex64, torch.float32):
        for sort in (True, False):
            for kind in ('tiny', 'nan'):
                seed += 1
                check_eigh(1539, 6, seed, dtype, plant=True, sort=sort,
                           kind=kind)
    check_eigh(4 * 257 * 3, 6, seed=13, dtype=torch.float32, plant=True)
    return err


def stream_inputs(B, F, D, K, T, seed, saliency=False, mask=False):
    """em_inputs plus optional saliency (B, F, T) and 0/1 source-activity
    mask (B, F, K, T) (no frame with every class gated)."""
    import torch
    y, aff, qf = em_inputs(B, F, D, K, T, seed)
    g = torch.Generator('cuda').manual_seed(seed + 1)
    sal = sam = None
    if saliency:
        sal = 0.2 + 0.8 * torch.rand((B, F, T), generator=g, device='cuda')
    if mask:
        sam = torch.rand((B, F, K, T), generator=g, device='cuda') > 0.2
        sam[:, :, 0] |= ~sam.any(2)
        sam = sam.float()
    return y, aff, qf, sal, sam


def check_stream(B, F, D, K, T, seed, weight_mode='per_bin',
                 saliency=False, mask=False):
    """One K4 statistics pass in each mode (from_init, then model mode
    from the plain path's first M-step) against its plain twin. Returns
    the max abs error of the covariances D scatter / asum."""
    import torch
    from pb_bss_tpu_torch.ops.em_stream import (
        cacgmm_em_long_reference, e_stats, e_stats_reference)
    y, aff, qf, sal, sam = stream_inputs(B, F, D, K, T, seed, saliency,
                                         mask)
    N = B * F

    def fold(x, *trailing):
        return None if x is None else x.reshape(N, *trailing)

    extra = dict(saliency=fold(sal, T), source_activity_mask=fold(sam, K, T))
    weight, ev, vec = cacgmm_em_long_reference(
        y, aff, qf, iterations=1, weight_mode=weight_mode, saliency=sal,
        source_activity_mask=sam)
    if weight_mode == 'fc':
        weight = weight[:, None, :].expand(B, F, K)
    modes = {
        'from_init': dict(affiliation=fold(aff, K, T),
                          quadratic_form=fold(qf, K, T)),
        'model': dict(eigenvalues=fold(ev, K, D),
                      eigenvectors=fold(vec, K, D, D),
                      weight=fold(weight, K), affiliation_eps=1e-10)}
    worst = 0.
    for mode, kwargs in modes.items():
        s_k, a_k = e_stats(fold(y, D, T), **kwargs, **extra)
        s_p, a_p = e_stats_reference(fold(y, D, T), **kwargs, **extra)
        sync()
        cov_k = D * s_k / a_k.clamp(min=1e-30)[..., None, None]
        cov_p = D * s_p / a_p.clamp(min=1e-30)[..., None, None]
        err = (cov_k - cov_p).abs().max().item()
        scale = cov_p.abs().max().item()
        rel_a = ((a_k - a_p).abs() / a_p.abs().clamp(min=1e-30)).max().item()
        herm = (s_k - s_k.conj().transpose(-1, -2)).abs().max().item()
        log(f'K4 {mode} B={B} F={F} D={D} K={K} T={T} {weight_mode}'
            f'{" +saliency" if saliency else ""}{" +mask" if mask else ""}: '
            f'max|cov_k - cov_p| {err:.2e} (max|cov| {scale:.2f}); '
            f'asum rel {rel_a:.2e}; |S - S^H| {herm:.1e}')
        # f32 sums over thousands of frames in two orders, and (model
        # mode) the projection on V diag(l^-1/2) against V^H y then / l:
        # 1e-4 of the largest entry
        if not (err <= 1e-4 * scale and rel_a <= 1e-4 and herm == 0.
                and bool(torch.isfinite(s_k).all())):
            fail(f'K4 {mode} mismatch at {(B, F, D, K, T, weight_mode)}')
        worst = max(worst, err)
    return worst


def check_stream_fit(B, F, D, K, T, seed, iterations=20):
    """The whole streamed EM (K4 + K1 + finish) against its plain twin
    over ``iterations`` iterations, held like K2's 20-iteration check:
    trajectories part in ambiguous bins, so the final masks are held by
    argmax agreement. Returns the agreement."""
    import torch
    from pb_bss_tpu_torch.models.cacgmm import (
        CACGMM, _predict_time_last_blocked)
    from pb_bss_tpu_torch.models.complex_angular_central_gaussian import (
        ComplexAngularCentralGaussian)
    from pb_bss_tpu_torch.ops.em_stream import (
        cacgmm_em_long, cacgmm_em_long_reference)
    y, aff, qf = em_inputs(B, F, D, K, T, seed)
    masks = []
    for fit in (cacgmm_em_long, cacgmm_em_long_reference):
        weight, ev, vec = fit(y, aff, qf, iterations=iterations)
        model = CACGMM(weight=weight[..., None],
                       cacg=ComplexAngularCentralGaussian(
                           covariance_eigenvectors=vec,
                           covariance_eigenvalues=ev))
        masks.append(_predict_time_last_blocked(model, y, t_block=2048)
                     .argmax(-2))
        if fit is cacgmm_em_long:
            finite = all(bool(torch.isfinite(x).all())
                         for x in (weight, ev, vec))
            wsum = (weight.sum(-1) - 1).abs().max().item()
    sync()
    agree = (masks[0] == masks[1]).float().mean().item()
    log(f'K4 {iterations} iter B={B} F={F} D={D} K={K} T={T}: finite '
        f'{finite} |sum w - 1| {wsum:.2e} argmax agreement {agree:.4f}')
    if not (finite and wsum < 1e-4 and agree > 0.9):
        fail(f'K4 {iterations}-iteration check failed at {(B, F, D, K, T)}')
    return agree


def fold_inputs(B, F, D, K, T, seed, saliency=False, mask=False):
    """stream_inputs folded to N = B F bins: y (N, D, T), aff and qf
    (N, K, T), saliency (N, T), mask (N, K, T). With ``mask`` a class is
    silenced in every frame of 16 bins (with affiliation_eps=0 its sum
    there is exactly 0: the 0 * inf hazard at D >= 5)."""
    y, aff, qf, sal, sam = stream_inputs(B, F, D, K, T, seed, saliency, mask)
    N = B * F
    if sam is not None:
        sam = sam.reshape(N, K, T).clone()
        sam[5:21, 1] = 0
    return (y.reshape(N, D, T), aff.reshape(N, K, T), qf.reshape(N, K, T),
            None if sal is None else sal.reshape(N, T), sam)


def state_errors(vec_k, ev_k, vec_p, ev_p):
    """(max |lambda_k - lambda_p| / lambda_max, max |C_k - C_p|,
    max |C_p|) of two eigendecompositions, C = V diag(lambda) V^H."""
    import torch
    lam_k, lam_p = ev_k.sort(-1).values, ev_p.sort(-1).values
    rel = ((lam_k - lam_p).abs().max(-1).values
           / lam_p.abs().max(-1).values.clamp(min=1e-30)).max().item()

    def cov(v, e):
        return v @ torch.diag_embed(e).to(v.dtype) @ v.conj().transpose(-1, -2)
    c_k, c_p = cov(vec_k, ev_k), cov(vec_p, ev_p)
    return rel, (c_k - c_p).abs().max().item(), c_p.abs().max().item()


def check_fc(B, F, D, K, T, seed, saliency=False, mask=False, emit=False):
    """K5's init kernel and one step kernel against their twins (the
    step from the twin's state, so that both see the same input).
    Returns {'init': max abs covariance error, 'step': the same}."""
    import torch
    from pb_bss_tpu_torch.ops import em_step
    y, aff, qf, sal, sam = fold_inputs(B, F, D, K, T, seed, saliency, mask)
    init = dict(sweeps=6 if D <= 8 else 8, eigenvalue_floor=1e-10,
                saliency=sal)
    vec_k, ev_k, asum_k = em_step.m_init(y, aff, qf, **init)
    vec_p, ev_p, asum_p = em_step.m_init_reference(y, aff, qf, **init)
    weight = asum_p.reshape(B, F, K).sum(1)
    weight = weight / weight.sum(-1, keepdim=True)
    step = dict(warm_sweeps=2, eigenvalue_floor=1e-10,
                affiliation_eps=0. if mask else 1e-10, saliency=sal,
                source_activity_mask=sam, emit_affiliation=emit)
    out_k = em_step.em_step(y, ev_p, vec_p, weight, **step)
    out_p = em_step.em_step_reference(y, ev_p, vec_p, weight, **step)
    sync()
    label = (f'B={B} F={F} D={D} K={K} T={T}{" +saliency" if saliency else ""}'
             f'{" +mask (class silenced, eps 0)" if mask else ""}'
             f'{" +posterior" if emit else ""}')
    errors = {}
    for name, (vk, ek, ak), (vp, ep, ap) in (
            ('init', (vec_k, ev_k, asum_k), (vec_p, ev_p, asum_p)),
            ('step', out_k[:3], out_p[:3])):
        rel, err, scale = state_errors(vk, ek, vp, ep)
        rel_a = ((ak - ap).abs() / ap.abs().clamp(min=1e-30)).max().item()
        finite = bool(torch.isfinite(ek).all() and torch.isfinite(vk).all())
        log(f'K5 {name} {label}: max|lam_k - lam_p| / lam_max {rel:.2e}; '
            f'max|C_k - C_p| {err:.2e} (max|C| {scale:.2f}); asum rel '
            f'{rel_a:.2e}; finite {finite}')
        # two f32 Jacobi runs, two E-step formulas and sums over T in two
        # orders: 1e-4 of the largest eigenvalue and covariance entry
        if not (finite and rel <= 1e-4 and err <= 1e-4 * scale
                and rel_a <= 1e-4):
            fail(f'K5 {name} mismatch at {label}')
        errors[name] = err
    if emit:
        err_a = (out_k[3] - out_p[3]).abs().max().item()
        log(f'K5 step {label}: max|posterior_k - posterior_p| {err_a:.2e}')
        if not err_a <= 2e-3:
            fail(f'K5 emitted posterior mismatch at {label}')
    return errors


def check_fc_fit(B, F, D, K, T, seed, iterations=20):
    """The whole frequency-constant EM (K5 init + steps) against its
    plain twin over ``iterations`` iterations, held by argmax agreement
    of the final masks; then a 3-iteration resume from the kernel fit's
    model. Returns the agreement."""
    import torch
    from pb_bss_tpu_torch.models.cacgmm import CACGMM
    from pb_bss_tpu_torch.models.complex_angular_central_gaussian import (
        ComplexAngularCentralGaussian)
    from pb_bss_tpu_torch.ops.em_step import (
        cacgmm_em_fc, cacgmm_em_fc_reference)
    y, aff, qf = em_inputs(B, F, D, K, T, seed)

    def masks(w, ev, vec):
        model = CACGMM(weight=w[..., None, :, None],
                       cacg=ComplexAngularCentralGaussian(
                           covariance_eigenvectors=vec,
                           covariance_eigenvalues=ev))
        return model._predict(y)[0].argmax(-2)

    fits = [fit(y, aff, qf, iterations=iterations)
            for fit in (cacgmm_em_fc, cacgmm_em_fc_reference)]
    w, ev, vec = fits[0]
    resume = dict(first_e_step=True, init_weight=w, init_eigenvalues=ev,
                  init_eigenvectors=vec, iterations=3)
    resumed = [fit(y, None, None, **resume)
               for fit in (cacgmm_em_fc, cacgmm_em_fc_reference)]
    sync()
    finite = all(bool(torch.isfinite(x).all()) for x in fits[0] + resumed[0])
    wsum = (w.sum(-1) - 1).abs().max().item()
    agree = (masks(*fits[0]) == masks(*fits[1])).float().mean().item()
    agree_r = (masks(*resumed[0]) == masks(*resumed[1])).float().mean().item()
    log(f'K5 {iterations} iter B={B} F={F} D={D} K={K} T={T}: finite '
        f'{finite} weight {tuple(w.shape)} |sum w - 1| {wsum:.2e} argmax '
        f'agreement {agree:.4f}; resumed 3 iter: {agree_r:.4f}')
    if not (finite and wsum < 1e-4 and agree > 0.9 and agree_r > 0.9):
        fail(f'K5 {iterations}-iteration check failed at {(B, F, D, K, T)}')
    return agree


def estep_inputs(F, D, K, T, seed):
    """The K11 operands: y planes (F, D, T), unitary eigenvector planes,
    reciprocal eigenvalues in (1, 10], log-determinants, weights."""
    import torch
    g = torch.Generator('cuda').manual_seed(seed)

    def cn(*shape):
        return torch.complex(torch.randn(shape, generator=g, device='cuda'),
                             torch.randn(shape, generator=g, device='cuda'))
    y = cn(F, D, T)
    vec = torch.linalg.qr(cn(F, K, D, D))[0]
    ev = 0.1 + 0.9 * torch.rand((F, K, D), generator=g, device='cuda')
    w = torch.rand((F, K), generator=g, device='cuda') + 0.2
    return (y.real.contiguous(), y.imag.contiguous(), vec.real.contiguous(),
            vec.imag.contiguous(), 1. / ev, torch.log(ev).sum(-1),
            w / w.sum(-1, keepdim=True))


def check_estep(F, D, K, T, seed):
    """Both K11 kernels against their twins; the scatter run twice, bit
    for bit (its split bins are summed in the launch in slot order), and
    through the trainer's route (em_scatter_model on the complex y and
    eigenvectors), bit for bit. Returns (max abs posterior error of the
    E-step, max abs error of the scatter)."""
    import torch
    from pb_bss_tpu_torch.ops import _plan, em_estep
    from pb_bss_tpu_torch.ops.em_estep import (
        cacgmm_e_step, cacgmm_e_step_reference, cacgmm_em_scatter,
        cacgmm_em_scatter_reference, em_scatter_model)
    args = estep_inputs(F, D, K, T, seed)
    aff_k, qf_k = cacgmm_e_step(*args)
    aff_p, qf_p = cacgmm_e_step_reference(*args)
    s_k = cacgmm_em_scatter(*args)
    s_again = cacgmm_em_scatter(*args)
    s_model = em_scatter_model(torch.complex(args[0], args[1]),
                               torch.complex(args[2], args[3]), *args[4:])
    s_p = cacgmm_em_scatter_reference(*args)
    sync()
    repeat = all(same_bits(a, b) for a, b in zip(s_k, s_again))
    route = all(same_bits(a, b) for a, b in zip(s_k, s_model))
    ctas, span, slots = em_estep.plan(F, T, _plan.capacity(
        'em_estep', 0, 1, D, K))
    log(f'K11 F={F} D={D} K={K} T={T}: scatter plan {ctas} CTAs of '
        f'{em_estep.THREADS} threads, span {span}, up to {slots} slots a '
        f'bin; repeats bit for bit {repeat}; the trainer\'s route bit for '
        f'bit {route}')
    if not (repeat and route):
        fail(f'K11 scatter does not repeat bit for bit at {(F, D, K, T)}')
    err_a = (aff_k - aff_p).abs().max().item()
    rel_q = ((qf_k - qf_p).abs() / qf_p).max().item()
    scale = max(s_p[0].abs().max().item(), s_p[1].abs().max().item())
    err_s = max((s_k[i] - s_p[i]).abs().max().item() for i in (0, 1))
    rel_a = ((s_k[2] - s_p[2]).abs() / s_p[2].abs()).max().item()
    log(f'K11 F={F} D={D} K={K} T={T}: e_step max|aff| {err_a:.2e}, qf rel '
        f'{rel_q:.2e}; scatter max|S_k - S_p| {err_s:.2e} (max|S| '
        f'{scale:.2f}), asum rel {rel_a:.2e}')
    # the projection on V diag(sqrt(1/l)) against V^H y then times 1/l,
    # and f32 sums over T in two orders: 1e-4 (relative, or of the
    # largest scatter entry)
    if not (err_a <= 1e-4 and rel_q <= 1e-4 and err_s <= 1e-4 * scale
            and rel_a <= 1e-4):
        fail(f'K11 mismatch at {(F, D, K, T)}')
    return err_a, err_s


# ---------------------------------------------------------------------
# the eigenvalue floor (pb_bss_tpu_torch.testing.em_floor): each cACGMM
# kernel against its twin with an eigenvalue at the floor, at the
# tolerances of its check above. Each returns (passed, message).
# ---------------------------------------------------------------------

def floor_tensors(x):
    import torch
    return {k: torch.as_tensor(v, device='cuda') for k, v in x.items()}


def check_em_floor(N, D, K, T, seed):
    """K2, one iteration from affiliations under which class 0's first
    M-step is rank-deficient (affiliation_eps=0), held in its two halves:
    the M-step against the twin's (weights, eigenvalues and covariances),
    and the E-step against the twin's E-step on the kernel's own model.
    (Against the twin's whole iteration the posterior moves with the
    rounding noise of the eigenvalue at zero, whatever computes it: that
    comparison and the twin's own on y (1 + 2^-22) are logged.)"""
    from pb_bss_tpu_torch.models.cacgmm import CACGMM
    from pb_bss_tpu_torch.models.complex_angular_central_gaussian import (
        ComplexAngularCentralGaussian)
    from pb_bss_tpu_torch.ops.em_loop import (
        cacgmm_em_full, cacgmm_em_full_reference)
    from pb_bss_tpu_torch.testing.em_floor import affiliations_at_floor
    x = floor_tensors(affiliations_at_floor(N, D, K, T, seed))
    args = (x['y'], x['affiliation'], x['quadratic_form'])
    kw = dict(iterations=1, sweeps=6 if D <= 8 else 8, affiliation_eps=0.)
    out_k = cacgmm_em_full(*args, warm_sweeps=2, **kw)
    out_p = cacgmm_em_full_reference(*args, **kw)
    model = CACGMM(weight=out_k[0][..., None], cacg=(
        ComplexAngularCentralGaussian(covariance_eigenvectors=out_k[2],
                                      covariance_eigenvalues=out_k[1])))
    e_step = model._predict(x['y'], affiliation_eps=0.)[0]
    own = cacgmm_em_full_reference(args[0] * (1 + 2 ** -22), *args[1:],
                                   **kw)[3]
    sync()
    err_w = (out_k[0] - out_p[0]).abs().max().item()
    err_e = (out_k[1] - out_p[1]).abs().max().item()
    _, err_c, scale = state_errors(out_k[2], out_k[1], out_p[2], out_p[1])
    err_a = (out_k[3] - e_step).abs().max().item()
    whole = (out_k[3] - out_p[3]).abs()
    low = out_p[1][:, 0, 0].max().item()
    message = (
        f'K2 floor N={N} D={D} K={K} T={T}, 1 iter: weight {err_w:.2e} eig '
        f'{err_e:.2e} covariance {err_c:.2e} (max {scale:.2f}); aff against '
        f'the twin\'s E-step on the kernel\'s model {err_a:.2e}; against '
        f'the twin\'s iteration {whole.max().item():.2e} '
        f'({int((whole.amax((1, 2)) >= 2e-3).sum())} bins >= 2e-3), the twin '
        f'on y (1 + 2^-22) {(own - out_p[3]).abs().max().item():.2e}; the '
        f'twin\'s smallest class-0 eigenvalue <= {low:.2e} in every bin')
    return (err_w < 1e-5 and err_e < 1e-4 and err_c <= 1e-4 * scale
            and err_a < 2e-3), message


def check_stream_floor(N, D, K, T, seed):
    """K4 in model mode from a model at the floor."""
    import torch
    from pb_bss_tpu_torch.ops.em_stream import e_stats, e_stats_reference
    from pb_bss_tpu_torch.testing.em_floor import model_at_floor
    x = floor_tensors(model_at_floor(N, D, K, T, seed))
    kw = dict(eigenvalues=x['eigenvalues'], eigenvectors=x['eigenvectors'],
              weight=x['weight'], affiliation_eps=1e-10)
    s_k, a_k = e_stats(x['y'], **kw)
    s_p, a_p = e_stats_reference(x['y'], **kw)
    sync()
    cov_k = D * s_k / a_k.clamp(min=1e-30)[..., None, None]
    cov_p = D * s_p / a_p.clamp(min=1e-30)[..., None, None]
    err = (cov_k - cov_p).abs().max().item()
    scale = cov_p.abs().max().item()
    rel_a = ((a_k - a_p).abs() / a_p.abs().clamp(min=1e-30)).max().item()
    herm = (s_k - s_k.conj().transpose(-1, -2)).abs().max().item()
    finite = bool(torch.isfinite(s_k).all())
    message = (f'K4 floor N={N} D={D} K={K} T={T} (model mode): max|cov_k - '
               f'cov_p| {err:.2e} (max|cov| {scale:.2f}); asum rel '
               f'{rel_a:.2e}; |S - S^H| {herm:.1e}; finite {finite}')
    return (err <= 1e-4 * scale and rel_a <= 1e-4 and herm == 0.
            and finite), message


def check_fc_floor(B, F, D, K, T, seed):
    """K5's init from affiliations under which class 0 is rank-deficient,
    and its step from a model at the floor."""
    import torch
    from pb_bss_tpu_torch.ops import em_step
    from pb_bss_tpu_torch.testing.em_floor import (
        affiliations_at_floor, model_at_floor)
    N = B * F
    x = floor_tensors(affiliations_at_floor(N, D, K, T, seed))
    init = dict(sweeps=6 if D <= 8 else 8, eigenvalue_floor=1e-10)
    args = (x['y'], x['affiliation'], x['quadratic_form'])
    init_k = em_step.m_init(*args, **init)
    init_p = em_step.m_init_reference(*args, **init)
    x = floor_tensors(model_at_floor(N, D, K, T, seed + 1))
    weight = x['weight'].reshape(B, F, K).mean(1)
    step = dict(warm_sweeps=2, eigenvalue_floor=1e-10, affiliation_eps=1e-10)
    args = (x['y'], x['eigenvalues'], x['eigenvectors'], weight)
    step_k = em_step.em_step(*args, **step)
    step_p = em_step.em_step_reference(*args, **step)
    sync()
    passed, messages = True, []
    for name, (vk, ek, ak), (vp, ep, ap) in (
            ('init', init_k, init_p), ('step', step_k[:3], step_p[:3])):
        rel, err, scale = state_errors(vk, ek, vp, ep)
        rel_a = ((ak - ap).abs() / ap.abs().clamp(min=1e-30)).max().item()
        finite = bool(torch.isfinite(ek).all() and torch.isfinite(vk).all())
        passed &= (finite and rel <= 1e-4 and err <= 1e-4 * scale
                   and rel_a <= 1e-4)
        messages.append(
            f'K5 {name} floor B={B} F={F} D={D} K={K} T={T}: max|lam_k - '
            f'lam_p| / lam_max {rel:.2e}; max|C_k - C_p| {err:.2e} (max|C| '
            f'{scale:.2f}); asum rel {rel_a:.2e}; finite {finite}')
    return passed, '\n'.join(messages)


def check_estep_floor(F, D, K, T, seed):
    """Both K11 kernels from a model at the floor (1 / lambda = 1e10)."""
    import torch
    from pb_bss_tpu_torch.ops.em_estep import (
        cacgmm_e_step, cacgmm_e_step_reference, cacgmm_em_scatter,
        cacgmm_em_scatter_reference)
    from pb_bss_tpu_torch.testing.em_floor import model_at_floor
    x = floor_tensors(model_at_floor(F, D, K, T, seed))
    y, vec, ev = x['y'], x['eigenvectors'], x['eigenvalues']
    args = (y.real.contiguous(), y.imag.contiguous(), vec.real.contiguous(),
            vec.imag.contiguous(), 1. / ev, torch.log(ev).sum(-1),
            x['weight'])
    aff_k, qf_k = cacgmm_e_step(*args)
    aff_p, qf_p = cacgmm_e_step_reference(*args)
    s_k = cacgmm_em_scatter(*args)
    s_p = cacgmm_em_scatter_reference(*args)
    sync()
    err_a = (aff_k - aff_p).abs().max().item()
    rel_q = ((qf_k - qf_p).abs() / qf_p).max().item()
    scale = max(s_p[0].abs().max().item(), s_p[1].abs().max().item())
    err_s = max((s_k[i] - s_p[i]).abs().max().item() for i in (0, 1))
    rel_a = ((s_k[2] - s_p[2]).abs() / s_p[2].abs()).max().item()
    message = (f'K11 floor F={F} D={D} K={K} T={T}: e_step max|aff| '
               f'{err_a:.2e}, qf rel {rel_q:.2e}; scatter max|S_k - S_p| '
               f'{err_s:.2e} (max|S| {scale:.2f}), asum rel {rel_a:.2e}')
    return (err_a <= 1e-4 and rel_q <= 1e-4 and err_s <= 1e-4 * scale
            and rel_a <= 1e-4), message


def phase_floor():
    """The four cACGMM kernels at the eigenvalue floor; every check runs
    and logs before the phase fails on any of them."""
    results = [('K2', *check_em_floor(2 * 257, 6, 3, 304, seed=110)),
               ('K4', *check_stream_floor(257, 6, 3, 3753, seed=111)),
               ('K5', *check_fc_floor(2, 129, 6, 3, 304, seed=112)),
               ('K11', *check_estep_floor(257, 6, 3, 304, seed=114))]
    for _, passed, message in results:
        log(f'{message} -> {"agrees" if passed else "PARTS from its twin"}')
    parted = [name for name, passed, _ in results if not passed]
    if parted:
        fail(f'kernels part from their twins at the floor: {parted}')


def watson_inputs(B, F, D, K, T, seed, saliency=False, silence=False):
    """em_inputs' y and affiliations folded to N = B F bins, (N, D, T)
    and (N, K, T), with optional saliency (N, T). With ``silence`` a
    class's initial affiliations are 0 in 16 bins, so its sums there
    are exactly 0 (the 0 * inf hazard at D >= 5)."""
    import torch
    y, aff, _ = em_inputs(B, F, D, K, T, seed)
    N = B * F
    y, aff = y.reshape(N, D, T), aff.reshape(N, K, T).clone()
    sal = None
    if saliency:
        g = torch.Generator('cuda').manual_seed(seed + 1)
        sal = 0.2 + 0.8 * torch.rand((N, T), generator=g, device='cuda')
    if silence:
        aff[5:21, 1] = 0
        aff = aff / aff.sum(-2, keepdim=True)
    return y, aff, sal


def watson_errors(out, ref):
    """(max |weight_k - weight_p|, min |<m_k, m_p>|, max |kappa_k -
    kappa_p| / max(kappa_p, 1)) of two Watson states (weight, mode,
    kappa, ...): modes carry an arbitrary phase per (bin, class)."""
    import torch
    err_w = (out[0] - ref[0]).abs().max().item()
    align = torch.einsum('...d,...d->...', out[1].conj(),
                         ref[1]).abs().min().item()
    rel_k = ((out[2] - ref[2]).abs()
             / ref[2].abs().clamp(min=1.)).max().item()
    return err_w, align, rel_k


def check_cwmm(B, F, D, K, T, seed, saliency=False, silence=False,
               iterations=20, control=False):
    """K6 against its plain twin, as K9 and K12 are held.

    1. One (cold) iteration tightly.
    2. The warm iterations, one at a time: the kernel's fit of n
       iterations (its posterior and its eigenvectors in its own column
       order) is the state its iteration n + 1 starts from; the twin's
       warm step from that state (:func:`cwmm_em_step_reference`) is held
       against the kernel's fit of n + 1 iterations at n = 1 and n =
       iterations - 1, at the one-iteration tolerances. With ``control``,
       the step with no sweep after the rotation (frozen eigenvectors)
       must exceed them at n = 1.
    3. ``iterations`` by the argmax of the posteriors against the twin's
       cold fit.

    Returns the one-iteration max abs affiliation error."""
    import torch
    from pb_bss_tpu_torch.ops.cwmm_loop import (
        cwmm_em_full, cwmm_em_full_reference, cwmm_em_step_reference)
    y, aff, sal = watson_inputs(B, F, D, K, T, seed, saliency, silence)
    label = (f'B={B} F={F} D={D} K={K} T={T}'
             f'{" +saliency" if saliency else ""}'
             f'{" +class silenced in 16 bins" if silence else ""}')

    def agrees(errors):
        # the same statistics in two summation orders and two f32 Jacobi
        # runs; kappa through the table's slope
        err_w, align, rel_k, err_a = errors
        return (err_w < 1e-5 and align > 1 - 1e-3 and rel_k < 1e-3
                and err_a < 2e-3)

    def errors(out, ref):
        return (*watson_errors(out, ref),
                (out[3] - ref[3]).abs().max().item())

    def fmt(e):
        return (f'aff {e[3]:.2e} weight {e[0]:.2e} min|m_k^H m_p| '
                f'{e[1]:.6f} kappa rel {e[2]:.2e}')

    fits = {n: cwmm_em_full(y, aff, iterations=n, warm_sweeps=2,
                            saliency=sal, return_eigenvectors=True)
            for n in (1, 2, iterations - 1, iterations)}
    out_p = cwmm_em_full_reference(y, aff, iterations=1, saliency=sal)
    sync()
    one = errors(fits[1], out_p)
    log(f'K6 1 iter  {label}: {fmt(one)}')
    if not agrees(one):
        fail(f'K6 one-iteration mismatch at {label}')
    for n in (1, iterations - 1):
        start = fits[n]
        got = errors(fits[n + 1], cwmm_em_step_reference(
            y, start[3], start[4], warm_sweeps=2, saliency=sal))
        frozen = errors(fits[n + 1], cwmm_em_step_reference(
            y, start[3], start[4], warm_sweeps=0, saliency=sal))
        sync()
        log(f'K6 warm step {n} -> {n + 1} {label}: {fmt(got)}; control (no '
            f'sweep) {fmt(frozen)}')
        if not agrees(got):
            fail(f'K6 warm step {n} -> {n + 1} mismatch at {label}')
        if control and n == 1 and agrees(frozen):
            fail(f'K6 warm step {n} -> {n + 1} at {label}: the control '
                 'agrees, which would not catch a wrong warm M-step')
    out_k = fits[iterations]
    out_p = cwmm_em_full_reference(y, aff, iterations=iterations,
                                   saliency=sal)
    sync()
    finite = all(bool(torch.isfinite(x).all()) for x in out_k)
    wsum = (out_k[0].sum(-1) - 1).abs().max().item()
    agree = (out_k[3].argmax(-2) == out_p[3].argmax(-2)).float().mean().item()
    silenced = (out_k[0][5:21, 1].abs().max().item() if silence else 0.)
    log(f'K6 {iterations} iter {label}: finite {finite} |sum w - 1| '
        f'{wsum:.2e} argmax agreement {agree:.4f}'
        f'{f"; silenced weight {silenced:.1e}" if silence else ""}')
    if not (finite and wsum < 1e-4 and agree > 0.9 and silenced == 0.):
        fail(f'K6 {iterations}-iteration check failed at {label}')
    return one[3]


def watson_states(F, T, seed, count, D=6, K=3):
    """``count`` inputs of a Watson step-mode K7 pass over one recording
    of F bins and T frames, from the twin's first M-step: (y, initial
    affiliations, mode, concentration, log Z, weight)."""
    from pb_bss_tpu_torch.models.complex_watson import ComplexWatson
    from pb_bss_tpu_torch.ops.mm_stream import cwmm_em_long_reference
    states = []
    for i in range(count):
        y, aff, _ = watson_inputs(1, F, D, K, T, seed + i)
        N = y.shape[0]
        weight, mode, kappa = cwmm_em_long_reference(y, aff, iterations=1)
        kappa = kappa.reshape(N, K)
        states.append((y, aff, mode.reshape(N, K, D), kappa,
                       ComplexWatson.log_norm_tran_vu(kappa, D),
                       weight.reshape(N, K)))
    return states


def watson_step(stats):
    """A Watson step-mode pass of ``stats`` on one of watson_states'."""
    return lambda y, a, m, k, z, w: stats(y, mode=m, concentration=k,
                                          log_norm=z, weight=w)


def bingham_states(F, T, seed, count, D=6, K=3):
    """``count`` inputs of a Bingham step-mode K7 pass over one recording
    of F bins and T frames, from the twin's first M-step: (y, initial
    affiliations, eigenvectors, eigenvalues, log c, weight)."""
    from pb_bss_tpu_torch.models.complex_bingham import ComplexBingham
    from pb_bss_tpu_torch.ops.mm_stream import cbmm_em_long_reference
    states = []
    for i in range(count):
        y, aff, _ = watson_inputs(1, F, D, K, T, seed + i)
        weight, lam, vec = cbmm_em_long_reference(y, aff, iterations=1)
        log_c = ComplexBingham(covariance_eigenvectors=vec,
                               covariance_eigenvalues=lam).log_norm()
        states.append((y, aff, vec, lam, log_c, weight))
    return states


def bingham_step(stats):
    """A Bingham step-mode pass of ``stats`` (the posterior clip at 1e-3)
    on one of bingham_states'."""
    return lambda y, a, v, l, c, w: stats(
        y, eigenvectors=v, eigenvalues=l, log_norm=c, weight=w,
        affiliation_eps=1e-3)


def check_watson_stream(B, F, D, K, T, seed, weight_mode='per_bin',
                        saliency=False):
    """One K7 statistics pass in each mode (from-init, then step from the
    plain path's first M-step) against its plain twin. Returns the max
    abs error of the scatter sums."""
    import torch
    from pb_bss_tpu_torch.models.complex_watson import ComplexWatson
    from pb_bss_tpu_torch.ops.mm_stream import (
        cwmm_em_long_reference, mm_stats, mm_stats_reference)
    y, aff, sal = watson_inputs(B, F, D, K, T, seed, saliency)
    N = B * F
    weight, mode, kappa = cwmm_em_long_reference(
        y.reshape(B, F, D, T), aff.reshape(B, F, K, T), iterations=1,
        weight_mode=weight_mode,
        saliency=None if sal is None else sal.reshape(B, F, T))
    kappa = kappa.reshape(N, K)
    modes = {
        'from_init': dict(affiliation=aff),
        'step': dict(mode=mode.reshape(N, K, D), concentration=kappa,
                     log_norm=ComplexWatson.log_norm_tran_vu(kappa, D),
                     weight=weight.reshape(-1, K),
                     bins_per_weight=1 if weight_mode == 'per_bin' else F)}
    worst = 0.
    for name, kwargs in modes.items():
        s_k, a_k = mm_stats(y, saliency=sal, **kwargs)
        s_p, a_p = mm_stats_reference(y, saliency=sal, **kwargs)
        sync()
        err = (s_k - s_p).abs().max().item()
        scale = s_p.abs().max().item()
        rel_a = ((a_k - a_p).abs() / a_p.abs().clamp(min=1e-30)).max().item()
        herm = (s_k - s_k.conj().transpose(-1, -2)).abs().max().item()
        log(f'K7 {name} B={B} F={F} D={D} K={K} T={T} {weight_mode}'
            f'{" +saliency" if saliency else ""}: max|S_k - S_p| {err:.2e} '
            f'(max|S| {scale:.1f}); asum rel {rel_a:.2e}; |S - S^H| '
            f'{herm:.1e}')
        # f32 sums over thousands of frames in two orders, and (step
        # mode) the E-step's rank-1 form in two orders: 1e-4 of the
        # largest entry
        if not (err <= 1e-4 * scale and rel_a <= 1e-4 and herm == 0.
                and bool(torch.isfinite(s_k).all())):
            fail(f'K7 {name} mismatch at {(B, F, D, K, T, weight_mode)}')
        worst = max(worst, err)
    return worst


def check_watson_stream_fit(B, F, D, K, T, seed, iterations=10,
                            weight_mode='per_bin'):
    """The whole streamed Watson EM (K7 + K1 + finish) against its plain
    twin over ``iterations`` iterations, held by the argmax agreement of
    the final posteriors (trajectories part in ambiguous bins). Returns
    (max |weight_k - weight_p|, min |<m_k, m_p>|, kappa rel) after one
    iteration."""
    import torch
    from pb_bss_tpu_torch.models.complex_watson import ComplexWatson
    from pb_bss_tpu_torch.models.cwmm import CWMM
    from pb_bss_tpu_torch.ops.mm_stream import (
        cwmm_em_long, cwmm_em_long_reference)
    y, aff, _ = em_inputs(B, F, D, K, T, seed)
    one = [fit(y, aff, iterations=1, weight_mode=weight_mode)
           for fit in (cwmm_em_long, cwmm_em_long_reference)]
    errors = watson_errors(*one)
    masks = []
    for fit in (cwmm_em_long, cwmm_em_long_reference):
        weight, mode, kappa = fit(y, aff, iterations=iterations,
                                  weight_mode=weight_mode)
        w = weight[..., None] if weight_mode == 'per_bin' \
            else weight[..., None, :, None]
        model = CWMM(weight=w, complex_watson=ComplexWatson(
            mode=mode, concentration=kappa))
        masks.append(model._predict(y.transpose(-1, -2)).argmax(-2))
        if fit is cwmm_em_long:
            finite = all(bool(torch.isfinite(x).all())
                         for x in (weight, mode, kappa))
            wsum = (weight.sum(-1) - 1).abs().max().item()
    sync()
    agree = (masks[0] == masks[1]).float().mean().item()
    log(f'K7 fit B={B} F={F} D={D} K={K} T={T} {weight_mode}: 1 iter weight '
        f'{errors[0]:.2e} min|m_k^H m_p| {errors[1]:.6f} kappa rel '
        f'{errors[2]:.2e}; {iterations} iter finite {finite} |sum w - 1| '
        f'{wsum:.2e} argmax agreement {agree:.4f}')
    if not (errors[0] < 1e-5 and errors[1] > 1 - 1e-3 and errors[2] < 1e-3
            and finite and wsum < 1e-4 and agree > 0.9):
        fail(f'K7 fit check failed at {(B, F, D, K, T, weight_mode)}')
    return errors


def bingham_moments(B, D, seed):
    """(B, D) sorted, spaced float32 moments (unit trace) on the card."""
    import numpy as np
    import torch
    from pb_bss_tpu_torch.models.complex_bingham import (
        _remove_duplicate_eigenvalues)
    rng = np.random.default_rng(seed)
    s = np.sort(rng.dirichlet(np.full(D, 0.7), size=B), -1)
    return _remove_duplicate_eigenvalues(
        torch.as_tensor(s, dtype=torch.float32, device='cuda'))[1]


def bingham_residual(lam, s):
    """max_d |grad log Z(lam) - s| per problem (the twin's cascade)."""
    from pb_bss_tpu_torch.ops.bingham import grad_cascade
    return (grad_cascade(lam)[0] - s).abs().max(-1).values


def check_bingham(B, D, seed, max_concentration=math.inf):
    """K8 against its twin: a cold solve (three launches from -1/s) and a
    warm one (one 16-step launch from the twin's cold solution perturbed
    by 5%), held by the residual |grad log Z - s| (the chord fixed point
    whatever the finite-difference Jacobian's ulps) and the solutions
    outside the saturated tail. Returns the warm solve's max abs
    eigenvalue error where |lambda| < 300."""
    import torch
    from pb_bss_tpu_torch.models.complex_bingham import find_eigenvalues
    from pb_bss_tpu_torch.ops.bingham import (
        bingham_chord_solve, bingham_chord_solve_reference)
    s = bingham_moments(B, D, seed)
    g = torch.Generator('cuda').manual_seed(seed)
    kw = dict(max_concentration=max_concentration)
    cold_k = find_eigenvalues(s, use_pallas=True, **kw)
    cold_p = find_eigenvalues(s, _chord=bingham_chord_solve_reference, **kw)
    x0 = cold_p * (1 + 0.05 * torch.randn((B, 1), device='cuda',
                                          generator=g))
    x0 = torch.sort(torch.cat([x0[:, :-1], torch.zeros_like(x0[:, :1])],
                              -1), -1).values
    warm_k = find_eigenvalues(s, warm_start=x0, iterations=16,
                              use_pallas=True, **kw)
    warm_p = find_eigenvalues(s, warm_start=x0, iterations=16,
                              _chord=bingham_chord_solve_reference, **kw)
    sync()
    label = (f'B={B} D={D}'
             f'{f" max_concentration={max_concentration:g}" if math.isfinite(max_concentration) else ""}')
    worst = 0.
    for name, k, p in (('cold', cold_k, cold_p), ('warm', warm_k, warm_p)):
        r_k, r_p = bingham_residual(k, s), bingham_residual(p, s)
        well = p.abs().max(-1).values < 300
        err = (k - p)[well].abs().max().item() if bool(well.any()) else 0.
        rel = ((k - p).abs() / (1 + p.abs())).max(-1).values
        ordered = bool((torch.diff(k, dim=-1) >= 0).all())
        log(f'K8 {name} {label}: residual median/max kernel '
            f'{r_k.median().item():.2e}/{r_k.max().item():.2e} twin '
            f'{r_p.median().item():.2e}/{r_p.max().item():.2e}; '
            f'rel err median {rel.median().item():.2e}; max|lam_k - lam_p| '
            f'(|lam| < 300) {err:.2e}; ascending {ordered}')
        if not bool(torch.isfinite(k).all()) or not ordered:
            fail(f'K8 {name} at {label}: non-finite or unordered output')
        if math.isfinite(max_concentration):
            # clipped solutions: the floor binds, the residual does not
            # vanish; the kernel and the twin clip alike
            if not (k.min().item() >= -max_concentration - 1e-2
                    and rel.median().item() < 1e-3):
                fail(f'K8 {name} bounded mismatch at {label}')
        elif not (r_k.median() < 2 * max(r_p.median().item(), 1e-5)
                  and r_k.max() < 3 * max(r_p.max().item(), 1e-3)
                  and rel.median().item() < 1e-3):
            fail(f'K8 {name} residual or solution mismatch at {label}')
        if name == 'warm':
            worst = err
    return worst


def chord_problems(B, D, seed, count):
    """``count`` warm K8 problems of B (bin, class) pairs: (s, x0), the
    sorted moments and the twin's cold solution perturbed by 5%."""
    import torch
    from pb_bss_tpu_torch.models.complex_bingham import find_eigenvalues
    from pb_bss_tpu_torch.ops.bingham import bingham_chord_solve_reference
    solves = []
    for i in range(count):
        s = bingham_moments(B, D, seed + i)
        lam = find_eigenvalues(s, _chord=bingham_chord_solve_reference)
        g = torch.Generator('cuda').manual_seed(seed + i)
        x0 = lam * (1 + 0.05 * torch.randn((B, 1), device='cuda',
                                           generator=g))
        x0 = torch.sort(torch.cat([x0[:, :-1], torch.zeros_like(x0[:, :1])],
                                  -1), -1).values
        solves.append((s, x0))
    return solves


def bingham_state_errors(out, ref):
    """(max |weight_k - weight_p|, max |lam_k - lam_p| / (1 + |lam_p|)
    where |lam_p| < 300, the median of that ratio over all, min |v_k^H
    v_p| over eigenvector columns) of two Bingham states (weight,
    eigenvalues, eigenvectors, ...) over the classes with weight. A moment
    <~ 1e-3 leaves its eigenvalue exponentially flat (saturated, |lambda|
    in the hundreds or thousands), where two f32 solves part by rounding;
    a silenced class has zero moments and no solution at all. Eigenvector
    columns carry an arbitrary phase."""
    import torch
    err_w = (out[0] - ref[0]).abs().max().item()
    live = ref[0] > 0
    rel = ((out[1] - ref[1]).abs() / (1 + ref[1].abs()))[live]
    well = (ref[1].abs() < 300)[live]
    align = torch.einsum('...dk,...dk->...k', out[2].conj(),
                         ref[2]).abs().min().item()
    return (err_w, rel[well].max().item(), rel.median().item(), align)


def cbmm_step_errors(out, ref):
    """The errors of one K9 iteration against the twin's: (weight, lam rel
    where |lam| < 300, lam rel median, min |v_k^H v_p|, max / mean |aff
    diff|, share of frames whose posterior parts by more than 0.1)."""
    err_w, rel, rel_median, align = bingham_state_errors(out, ref)
    d = (out[4] - ref[4]).abs()
    return (err_w, rel, rel_median, align, d.max().item(), d.mean().item(),
            (d > 0.1).float().mean().item())


def cbmm_step_agrees(errors):
    """The cold first iteration of the kernel and of the twin from the same
    affiliations: the same statistics in two summation orders, two f32 Jacobi runs, the
    same chord rounds whose finite-difference Jacobians differ by ulps
    (FMA contraction). The posteriors follow the eigenvalues
    exponentially, so they are held tightly on average and loosely frame
    by frame."""
    err_w, rel, rel_median, align, _, mean_a, far = errors
    return (err_w < 1e-5 and rel < 5e-2 and rel_median < 1e-3
            and align > 1 - 1e-3 and mean_a < 5e-3 and far < 1e-3)


def fmt_step(errors):
    return ('weight {:.2e} lam rel (|lam| < 300) {:.2e}, median {:.2e}; '
            'min|v_k^H v_p| {:.6f} aff max {:.2e} mean {:.2e}, share > 0.1 '
            '{:.1e}').format(*errors)


def fit_disagreement(a, b):
    """Share of frames whose posterior argmax differs between two fits."""
    return (a[4].argmax(-2) != b[4].argmax(-2)).float().mean().item()


def step_parts(a, b):
    """(mean |aff_a - aff_b|, share of frames whose argmax differs)."""
    return (a[4] - b[4]).abs().mean().item(), fit_disagreement(a, b)


def check_cbmm(B, F, D, K, T, seed, saliency=False, silence=False,
               max_concentration=math.inf, iterations=20, control=False):
    """K9 against its twin (:func:`cbmm_em_step_reference` per iteration).

    1. The cold first iteration: the weights, the eigenvalues, the
       phase-aligned eigenvectors (a missed swap in the sort network shows
       here) and the posteriors.
    2. The warm iterations, one at a time: the kernel is deterministic, so
       its fit of n iterations is the state (posterior, eigenvalues,
       eigenvectors) its iteration n + 1 starts from. The twin's warm step
       from that state (the rotation into the previous eigenbasis,
       ``warm_sweeps`` sweeps, one chord round from the previous
       eigenvalues) is held against the kernel's fit of n + 1 iterations,
       at n = 1 and n = iterations - 1: the weights to 1e-5, the
       eigenvalues to 1e-3 relative at the median, and the posteriors by
       their mean |diff| and the share of frames whose argmax differs:
       at most 2.5e-3 and 4e-3 (five times the cold iteration's parity at
       the slice shape) plus four times what the same twin step gives on
       y (1 + 2^-22), an ulp-level change of the input (the sensitivity
       of the step itself, large at D=8, K=4, T=150). A few (bin, class)
       problems with saturated eigenvalues (|lambda| in the thousands,
       set by moments <~ 1e-3) or nearly equal moments part by rounding
       alone, so no maximum is held. The control, the same step with no
       sweep after the rotation (the eigenvectors frozen: a wrong warm
       M-step), must exceed those limits at n = 1, where the basis moves
       most.
    3. The whole fit of ``iterations``: the same saturation makes the EM
       itself sensitive to rounding, so two fits part with the
       iterations. The twin on y (1 + 2^-22) measures that: the kernel may
       part from the twin by at most twice as many frames (argmax of the
       posteriors) plus 1%. With ``control``, the twin whose warm steps
       freeze the eigenvectors must part by more.
    4. The kernel's last, unclipped E-step is CBMM.predict of the model it
       returns, and a silenced class keeps weight 0.

    Returns the first iteration's max abs affiliation error."""
    import torch
    from pb_bss_tpu_torch.models.cbmm import CBMM
    from pb_bss_tpu_torch.models.complex_bingham import ComplexBingham
    from pb_bss_tpu_torch.ops.cbmm_loop import (
        cbmm_em_full, cbmm_em_full_reference, cbmm_em_step_reference)
    y, aff, sal = watson_inputs(B, F, D, K, T, seed, saliency, silence)
    kw = dict(saliency=sal, max_concentration=max_concentration)
    label = (f'B={B} F={F} D={D} K={K} T={T}'
             f'{" +saliency" if saliency else ""}'
             f'{" +class silenced in 16 bins" if silence else ""}'
             f'{f" mc={max_concentration:g}" if math.isfinite(max_concentration) else ""}')
    fits = {n: cbmm_em_full(y, aff, iterations=n, **kw)
            for n in (1, 2, iterations - 1, iterations)}
    errors = cbmm_step_errors(
        fits[1], cbmm_em_step_reference(y, aff, None, **kw))
    sync()
    log(f'K9 1 iter  {label}: {fmt_step(errors)}')
    if not (cbmm_step_agrees(errors)
            and all(bool(torch.isfinite(x).all()) for x in fits[1])):
        fail(f'K9 one-iteration mismatch at {label}')
    err_a = errors[4]
    for n in (1, iterations - 1):
        start = fits[n]

        def step(y_, warm_sweeps=2):
            return cbmm_em_step_reference(y_, start[4], start[1:3],
                                          warm_sweeps=warm_sweeps, **kw)
        twin = step(y)
        errors = cbmm_step_errors(fits[n + 1], twin)
        parts = step_parts(fits[n + 1], twin)
        rounding = step_parts(step(y * (1 + 2 ** -22)), twin)
        frozen = step_parts(step(y, 0), twin)
        limit = (4 * rounding[0] + 2.5e-3, 4 * rounding[1] + 4e-3)
        sync()
        log(f'K9 warm step {n} -> {n + 1} {label}: {fmt_step(errors)}; '
            f'posteriors mean |diff| / argmax parted: kernel {parts[0]:.2e}'
            f' / {parts[1]:.2e}, twin on y (1 + 2^-22) {rounding[0]:.2e} / '
            f'{rounding[1]:.2e} (limits {limit[0]:.2e} / {limit[1]:.2e}), '
            f'control (no sweep) {frozen[0]:.2e} / {frozen[1]:.2e}')
        if not (errors[0] < 1e-5 and errors[2] < 1e-3
                and parts[0] <= limit[0] and parts[1] <= limit[1]):
            fail(f'K9 warm step {n} -> {n + 1} mismatch at {label}')
        if n == 1 and frozen[0] <= limit[0] and frozen[1] <= limit[1]:
            fail(f'K9 warm step {n} -> {n + 1} at {label}: the control '
                 'stays within the limits, which would not catch a wrong '
                 'warm M-step')
    out_k = fits[iterations]
    out_p = cbmm_em_full_reference(y, aff, iterations=iterations, **kw)
    nudged = cbmm_em_full_reference(y * (1 + 2 ** -22), aff,
                                    iterations=iterations, **kw)
    parted = fit_disagreement(out_k, out_p)
    rounding = fit_disagreement(nudged, out_p)
    limit = 2 * rounding + 0.01
    finite = all(bool(torch.isfinite(x).all()) for x in out_k)
    wsum = (out_k[0].sum(-1) - 1).abs().max().item()
    silenced = (out_k[0][5:21, 1].abs().max().item() if silence else 0.)
    model = CBMM(weight=out_k[0][..., None], complex_bingham=ComplexBingham(
        covariance_eigenvectors=out_k[2], covariance_eigenvalues=out_k[1]))
    predicted = model._predict(y.transpose(-1, -2))
    own = (predicted.argmax(-2) == out_k[4].argmax(-2)).float().mean().item()
    own_err = (predicted - out_k[4]).abs().mean().item()
    frozen = None
    if control:
        frozen = fit_disagreement(cbmm_em_full_reference(
            y, aff, iterations=iterations, warm_sweeps=0, **kw), out_p)
    sync()
    log(f'K9 {iterations} iter {label}: finite {finite} |sum w - 1| '
        f'{wsum:.2e}; frames whose argmax parts from the twin: kernel '
        f'{parted:.4f}, twin on y (1 + 2^-22) {rounding:.4f} (limit '
        f'{limit:.4f})'
        f'{f", control (frozen eigenvectors) {frozen:.4f}" if control else ""}'
        f'; argmax agreement with predict {own:.4f} (mean |diff| '
        f'{own_err:.1e})'
        f'{f"; silenced weight {silenced:.1e}" if silence else ""}')
    # predict in PyTorch against the kernel's E-step: the same model, the
    # quadratic forms and log norms in two f32 orders (the log norm of the
    # model re-spaces and max-shifts the eigenvalues)
    if not (finite and wsum < 1e-4 and own > 0.99 and own_err < 2e-3
            and silenced == 0. and parted <= limit):
        fail(f'K9 {iterations}-iteration check failed at {label}')
    if control and frozen <= limit:
        fail(f'K9 {iterations}-iteration check at {label}: the control '
             'stays within the limit, which would not catch a wrong warm '
             'M-step')
    return err_a


def check_cbmm_conditioned(N, D, K, T, seed, iterations=20):
    """K9 against its twin over ``iterations`` on isotropic observations,
    whose moments stay near 1/D and whose eigenvalues stay well inside the
    domain (|lambda| < ~50), so the fit is not sensitive to rounding and
    the kernel must follow the twin over all the iterations (argmax
    agreement 0.999 over 20 iterations; measured on one H100)."""
    import torch
    from pb_bss_tpu_torch.ops.cbmm_loop import (
        cbmm_em_full, cbmm_em_full_reference)
    g = torch.Generator('cuda').manual_seed(seed)
    y = torch.randn((N, D, T), dtype=torch.complex64, device='cuda',
                    generator=g)
    y = y / torch.linalg.vector_norm(y, dim=-2, keepdim=True)
    aff = torch.rand((N, K, T), device='cuda', generator=g)
    aff = aff / aff.sum(-2, keepdim=True)
    out_k = cbmm_em_full(y, aff, iterations=iterations)
    out_p = cbmm_em_full_reference(y, aff, iterations=iterations)
    sync()
    agree = (out_k[4].argmax(-2) == out_p[4].argmax(-2)).float().mean().item()
    err_w = (out_k[0] - out_p[0]).abs().max().item()
    mean_a = (out_k[4] - out_p[4]).abs().mean().item()
    log(f'K9 {iterations} iter isotropic N={N} D={D} K={K} T={T}: argmax '
        f'agreement {agree:.4f}; max|w_k - w_p| {err_w:.2e}; mean|aff_k - '
        f'aff_p| {mean_a:.2e}')
    if not (agree > 0.99 and err_w < 1e-2 and mean_a < 2e-3):
        fail(f'K9 warm iterations part from the twin at {(N, D, K, T)}')


def check_bingham_stream(B, F, D, K, T, seed, weight_mode='per_bin',
                         saliency=False):
    """One Bingham K7 statistics pass in each mode (from-init, then step
    with the posterior clip from the twin's first M-step) against its
    plain twin. Returns the max abs error of the scatter sums."""
    import torch
    from pb_bss_tpu_torch.models.complex_bingham import ComplexBingham
    from pb_bss_tpu_torch.ops.mm_stream import (
        cbmm_em_long_reference, mm_stats, mm_stats_reference)
    y, aff, sal = watson_inputs(B, F, D, K, T, seed, saliency)
    N = B * F
    weight, lam, vec = cbmm_em_long_reference(
        y.reshape(B, F, D, T), aff.reshape(B, F, K, T), iterations=1,
        weight_mode=weight_mode,
        saliency=None if sal is None else sal.reshape(B, F, T))
    lam, vec = lam.reshape(N, K, D), vec.reshape(N, K, D, D)
    log_c = ComplexBingham(covariance_eigenvectors=vec,
                           covariance_eigenvalues=lam).log_norm()
    modes = {
        'from_init': dict(affiliation=aff),
        'step': dict(eigenvectors=vec, eigenvalues=lam, log_norm=log_c,
                     weight=weight.reshape(-1, K), affiliation_eps=1e-3,
                     bins_per_weight=1 if weight_mode == 'per_bin' else F)}
    worst = 0.
    for name, kwargs in modes.items():
        s_k, a_k = mm_stats(y, saliency=sal, **kwargs)
        s_p, a_p = mm_stats_reference(y, saliency=sal, **kwargs)
        sync()
        err = (s_k - s_p).abs().max().item()
        scale = s_p.abs().max().item()
        rel_a = ((a_k - a_p).abs() / a_p.abs().clamp(min=1e-30)).max().item()
        herm = (s_k - s_k.conj().transpose(-1, -2)).abs().max().item()
        log(f'K7 bingham {name} B={B} F={F} D={D} K={K} T={T} {weight_mode}'
            f'{" +saliency" if saliency else ""}: max|S_k - S_p| {err:.2e} '
            f'(max|S| {scale:.1f}); asum rel {rel_a:.2e}; |S - S^H| '
            f'{herm:.1e}')
        # f32 sums over thousands of frames in two orders, and (step
        # mode) the full quadratic form against the twin's V^H-free
        # product: 1e-4 of the largest entry
        if not (err <= 1e-4 * scale and rel_a <= 1e-4 and herm == 0.
                and bool(torch.isfinite(s_k).all())):
            fail(f'K7 bingham {name} mismatch at {(B, F, D, K, T, weight_mode)}')
        worst = max(worst, err)
    return worst


def check_bingham_stream_fit(B, F, D, K, T, seed, iterations=5,
                             weight_mode='per_bin'):
    """The whole streamed Bingham EM (K7 + K1 + K8 and the finish)
    against its plain twin (the statistics twin, the plain Jacobi, the
    chord solve's twin), held by the argmax agreement of the final
    posteriors. Returns the agreement."""
    import torch
    from pb_bss_tpu_torch.models.cbmm import CBMM
    from pb_bss_tpu_torch.models.complex_bingham import ComplexBingham
    from pb_bss_tpu_torch.ops.mm_stream import (
        cbmm_em_long, cbmm_em_long_reference)
    y, aff, _ = em_inputs(B, F, D, K, T, seed)
    masks = []
    for fit in (cbmm_em_long, cbmm_em_long_reference):
        weight, lam, vec = fit(y, aff, iterations=iterations,
                               weight_mode=weight_mode)
        w = weight[..., None] if weight_mode == 'per_bin' \
            else weight[..., None, :, None]
        model = CBMM(weight=w, complex_bingham=ComplexBingham(
            covariance_eigenvectors=vec, covariance_eigenvalues=lam))
        masks.append(model._predict(y.transpose(-1, -2)).argmax(-2))
        if fit is cbmm_em_long:
            finite = all(bool(torch.isfinite(x).all())
                         for x in (weight, lam, vec))
            wsum = (weight.sum(-1) - 1).abs().max().item()
    sync()
    agree = (masks[0] == masks[1]).float().mean().item()
    log(f'K7 bingham fit B={B} F={F} D={D} K={K} T={T} {weight_mode}, '
        f'{iterations} iter: finite {finite} |sum w - 1| {wsum:.2e} argmax '
        f'agreement {agree:.4f}')
    if not (finite and wsum < 1e-4 and agree > 0.9):
        fail(f'K7 bingham fit check failed at {(B, F, D, K, T, weight_mode)}')
    return agree


def integration_inputs(N, D, K, T, E, U, mode, seed, saliency=False,
                       separable=False, floor=False):
    """The integration kernels' inputs, made on the card: N bins of U
    utterances, (N, D, T) unit-norm observations, an (N, E, T) unit-norm
    embedding, a cACG model and weight per bin, the spectral state of each
    utterance ('vmf': mean, concentration, log normalizer; 'gaussian':
    P m, P, const) and optional (N, T) saliency. By default the
    observations are two-source mixtures and the embedding is random (the
    JAX package's bench config 3); with ``separable`` each frame belongs to
    one of K classes, with a steering vector per bin and an embedding centre
    per utterance, so that the EM is well-conditioned. With ``floor``, the
    regime of a converged fit: class 0's smallest eigenvalue sits at the
    eigenvalue floor (1e-10) and the first third of the frames lie in the
    span of its other eigenvectors, where a quadratic form through the
    assembled inverse covariance cancels (entries ~1e10)."""
    import torch
    from pb_bss_tpu_torch.models.von_mises_fisher import VonMisesFisher
    g = torch.Generator('cuda').manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device='cuda')

    def cn(*shape):
        return torch.complex(rn(*shape), rn(*shape))

    if separable:
        label = torch.randint(K, (N, T), generator=g, device='cuda')
        steer = torch.gather(cn(N, K, D), 1, label[..., None].expand(N, T, D))
        y = steer.transpose(1, 2) * cn(N, 1, T) + 0.1 * cn(N, D, T)
        centres = rn(U, K, E)
        utterance = torch.arange(N, device='cuda')[:, None] // (N // U)
        emb = (centres[utterance, label] + 0.3 * rn(N, T, E)).transpose(1, 2)
    else:
        y = torch.einsum('ndk,nkt->ndt', cn(N, D, 2), cn(N, 2, T)) \
            + 0.3 * cn(N, D, T)
        emb = rn(N, E, T)
    y = y / torch.linalg.vector_norm(y, dim=1, keepdim=True)
    emb = (emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True)
           ).contiguous()
    a = cn(N, K, D, D)
    ev, vec = torch.linalg.eigh(a @ a.conj().transpose(-1, -2) / D
                                + 2 * torch.eye(D, device='cuda'))
    # row-major, as the trainers hand the kernels their eigenvectors
    vec = vec.contiguous()
    ev = ev / ev.max(-1, keepdim=True).values
    if floor:
        ev[:, 0, 0] = 1e-10
        inside = torch.einsum('nde,net->ndt', vec[:, 0, :, 1:],
                              cn(N, D - 1, T // 3))
        y[..., :T // 3] = inside / torch.linalg.vector_norm(
            inside, dim=1, keepdim=True)
    w = torch.rand((N, K), generator=g, device='cuda') + 0.5
    w = w / w.sum(-1, keepdim=True)
    if mode == 'vmf':
        mu = rn(U, K, E)
        mu = mu / mu.norm(dim=-1, keepdim=True)
        kappa = 1 + 19 * torch.rand((U, K), generator=g, device='cuda')
        spec = (mu, kappa, VonMisesFisher(mean=mu,
                                          concentration=kappa).log_norm())
    else:
        mean = 0.3 * rn(U, K, E)
        prec = 0.5 + torch.rand((U, K, E), generator=g, device='cuda')
        const = 0.5 * E * math.log(2 * math.pi) - 0.5 * torch.log(prec).sum(
            -1) + 0.5 * (mean ** 2 * prec).sum(-1)
        spec = (prec * mean, prec, const)
    sal = (0.2 + 0.8 * torch.rand((N, T), generator=g, device='cuda')
           if saliency else None)
    return y, emb, ev, vec, w, spec, sal


def check_integration_stats(N, D, K, T, E, U, mode, seed, saliency=False,
                            floor=False):
    """One K10 pass from a random model (with ``floor``, one with an
    eigenvalue at the floor and frames orthogonal to its eigenvector)
    against its plain twin, with saliency also under spatial / spectral
    weights of 0.7 / 1.3; then the pass again, which must repeat the
    first bit for bit and run one kernel (the profiler). Returns the max
    abs error of the covariances D scatter / asum."""
    import torch
    from pb_bss_tpu_torch.ops.integration_em import e_stats, e_stats_reference
    y, emb, ev, vec, w, spec, sal = integration_inputs(
        N, D, K, T, E, U, mode, seed, saliency, floor=floor)
    kw = dict(eigenvalues=ev, eigenvectors=vec, weight=w, mu=spec[0],
              kappa=spec[1], log_c=spec[2], bins_per_utt=N // U,
              spectral_mode=mode, saliency=sal,
              spatial_weight=0.7 if saliency else 1.,
              spectral_weight=1.3 if saliency else 1.)
    before = e_stats.launches
    out = e_stats(y, emb, **kw)
    ref = e_stats_reference(y, emb, **kw)
    sync()
    launched = e_stats.launches - before
    repeated = []
    prof, _ = profile_device(lambda: repeated.append(e_stats(y, emb, **kw)),
                             activities=('CUDA',))
    again = repeated[-1]
    names = [] if prof is None else [
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = len(names)
    repeats = all(torch.equal(a, b) for a, b in zip(out, again)
                  if b is not None)
    cov_k = D * out[0] / out[1].clamp(min=1e-30)[..., None, None]
    cov_p = D * ref[0] / ref[1].clamp(min=1e-30)[..., None, None]
    err = (cov_k - cov_p).abs().max().item()
    scale = cov_p.abs().max().item()
    # the sums over T frames in two orders: relative to the largest entry
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(out[1:], ref[1:]) if b is not None]
    herm = torch.equal(out[0], out[0].conj().transpose(-1, -2))
    finite = all(bool(torch.isfinite(x).all()) for x in out if x is not None)
    label = (f'N={N} D={D} K={K} T={T} E={E} U={U} {mode}'
             f'{" +saliency, weights 0.7 / 1.3" if saliency else ""}'
             f'{" +eigenvalue at the floor" if floor else ""}')
    log(f'K10 {label}: max|cov_k - cov_p| {err:.2e} (max|cov| {scale:.2f}); '
        f'asum / resultants{" / second moments" if mode == "gaussian" else ""}'
        f' rel {", ".join(f"{r:.2e}" for r in rel)}; exactly Hermitian '
        f'{herm}; launches {launched}; repeats bit for bit {repeats}; '
        f'kernels a call {kernels}{"" if kernels == 1 else names}')
    if not (launched == 1 and err <= 1e-4 * scale and max(rel) <= 1e-5
            and herm and finite and repeats and kernels == 1):
        fail(f'K10 mismatch at {label}')
    return err


def phase_kernels_integration_stats():
    """K10 against its twin at bench config 3 (F=513, T=300, D=6, K=3,
    E=20) in both spectral modes, with and without saliency, at T=1, at
    T just above a tile (257) and at an odd T, at B=8 in both modes, at
    D=8, K=4, and with an eigenvalue at the floor; every pass also
    repeated bit for bit, one kernel a call. Returns the max abs
    covariance error at config 3 (vMF)."""
    err = check_integration_stats(513, 6, 3, 300, 20, 1, 'vmf', seed=90)
    check_integration_stats(513, 6, 3, 300, 20, 1, 'gaussian', seed=91)
    check_integration_stats(513, 6, 3, 301, 20, 1, 'vmf', seed=92,
                            saliency=True)
    check_integration_stats(2 * 513, 6, 3, 301, 20, 2, 'gaussian', seed=93,
                            saliency=True)
    check_integration_stats(8 * 513, 6, 3, 300, 20, 8, 'vmf', seed=94)
    check_integration_stats(8 * 513, 6, 3, 300, 20, 8, 'gaussian', seed=105,
                            saliency=True)
    for mode in ('vmf', 'gaussian'):
        for saliency in (False, True):
            check_integration_stats(513, 6, 3, 1, 20, 1, mode,
                                    seed=106 + saliency, saliency=saliency)
            check_integration_stats(513, 6, 3, 257, 20, 1, mode,
                                    seed=108 + saliency, saliency=saliency)
    check_integration_stats(130, 8, 4, 301, 7, 2, 'vmf', seed=95,
                            saliency=True)
    check_integration_stats(65, 8, 4, 37, 7, 1, 'gaussian', seed=96)
    check_integration_stats(513, 6, 3, 300, 20, 1, 'vmf', seed=102,
                            floor=True)
    check_integration_stats(130, 8, 4, 301, 7, 2, 'gaussian', seed=103,
                            saliency=True, floor=True)
    return err


def vmf_table(E):
    """The whole-fit kernel's log normalizer table as the twin takes it."""
    import torch
    from pb_bss_tpu_torch.ops.integration_em_loop import vmf_log_norm_table
    s0, ds, values = vmf_log_norm_table(E, 1e-10, 500.)
    return s0, ds, torch.as_tensor(values, device='cuda')


def integration_posterior(y, emb, out, mode, bins_per_utt, table):
    """The posterior (N, K, T) of the next E-step after a whole fit (its
    predict): the fit's cACG state and weights, and the spectral model
    finished from its last accumulators as the kernel finishes it."""
    from pb_bss_tpu_torch.ops.integration_em import e_step_reference
    from pb_bss_tpu_torch.ops.integration_em_loop import (
        spectral_m_step_reference)
    lam, vec, weight, acc = out
    K, E = weight.shape[-1], emb.shape[-2]
    spec = [x.repeat_interleave(bins_per_utt, 0)
            for x in spectral_m_step_reference(acc, E=E, K=K,
                                               spectral_mode=mode,
                                               table=table)]
    return e_step_reference(y, emb, eigenvalues=lam, eigenvectors=vec,
                            weight=weight, mu=spec[0], kappa=spec[1],
                            log_c=spec[2], spectral_mode=mode)[0]


def loop_errors(out, ref):
    """(max |weight diff|, max |covariance diff| of V diag(lam) V^H, acc
    rel to its largest entry) of two whole-fit results."""
    def cov(lam, vec):
        return (vec * lam[..., None, :].to(vec.dtype)) \
            @ vec.conj().transpose(-1, -2)
    return ((out[2] - ref[2]).abs().max().item(),
            (cov(*out[:2]) - cov(*ref[:2])).abs().max().item(),
            ((out[3] - ref[3]).abs().max() / ref[3].abs().max()).item())


def check_integration_loop(N, D, K, T, E, U, mode, seed, iterations=20,
                           separable=False, control=False):
    """K12 against its twin (:func:`integration_em_step_reference` per
    iteration), as K9 is held.

    1. One iteration: the weights and the covariances V diag(lam) V^H to
       1e-5, the accumulators to 1e-5 of their largest entry.
    2. The warm iterations, one at a time: the kernel's fit of n
       iterations is the state its iteration n + 1 starts from (the
       spectral state finished in-kernel from the returned accumulators).
       The twin's warm step from that state is held against the kernel's
       fit of n + 1 iterations at n = 1 and n = iterations - 1, by the
       posteriors of the next E-step: their mean |diff| and the share of
       frames whose argmax parts, at most 2.5e-3 / 4e-3 plus four times
       what the same twin step gives on y (1 + 2^-22). The control, the
       step with no sweep after the rotation (frozen eigenvectors), must
       exceed those limits at n = 1.
    3. The whole fit: the kernel may part from the twin by at most twice
       as many frames (argmax of the next E-step's posteriors) as the twin
       parts from itself on y (1 + 2^-22), plus 1%. With ``control``, the
       twin with frozen eigenvectors must part by more.

    Returns the max abs error of the one-iteration weights and
    covariances."""
    import torch
    from pb_bss_tpu_torch.ops import integration_em_loop as il
    y, emb, ev, vec, w, spec, _ = integration_inputs(
        N, D, K, T, E, U, mode, seed, separable=separable)
    F = N // U
    # the kernel's own column order: a warm step from it continues the fit
    # exactly (sorted columns change the order of the Jacobi's rotations)
    kw = dict(bins_per_utt=F, spectral_mode=mode, sort=False)
    table = vmf_table(E) if mode == 'vmf' else None
    label = (f'N={N} D={D} K={K} T={T} E={E} U={U} {mode}'
             f'{" separable" if separable else " random"}')
    fits = {n: il.integration_em_full(y, emb, vec, ev, w, *spec,
                                      iterations=n, **kw)
            for n in (1, 2, iterations - 1, iterations)}
    grid = il.integration_em_full.last_grid
    errors = loop_errors(fits[1], il.integration_em_full_reference(
        y, emb, vec, ev, w, *spec, iterations=1, **kw))
    sync()
    log(f'K12 1 iter {label}: weight {errors[0]:.2e} covariance '
        f'{errors[1]:.2e} accumulators rel {errors[2]:.2e}; grid {grid}')
    if not (max(errors) < 1e-5
            and all(bool(torch.isfinite(x).all()) for x in fits[1])):
        fail(f'K12 one-iteration mismatch at {label}')

    def posterior(out, y_=y):
        return integration_posterior(y_, emb, out, mode, F, table)

    def parts(a, b):
        d = (a - b).abs()
        return (d.mean().item(),
                (a.argmax(-2) != b.argmax(-2)).float().mean().item())

    for n in (1, iterations - 1):
        lam, vectors, weight, acc = fits[n]
        start_spec = il.spectral_m_step_reference(
            acc, E=E, K=K, spectral_mode=mode, table=table)

        def step(y_, warm_sweeps=2):
            v, lam_, w_, acc_ = il.integration_em_step_reference(
                y_, emb, (vectors, lam, weight, start_spec), bins_per_utt=F,
                sweeps=warm_sweeps, spectral_mode=mode)
            return lam_, v, w_, acc_
        twin = posterior(step(y))
        kernel = posterior(fits[n + 1])
        got = parts(kernel, twin)
        rounding = parts(posterior(step(y * (1 + 2 ** -22))), twin)
        frozen = parts(posterior(step(y, 0)), twin)
        limit = (4 * rounding[0] + 2.5e-3, 4 * rounding[1] + 4e-3)
        sync()
        log(f'K12 warm step {n} -> {n + 1} {label}: posteriors mean |diff| '
            f'/ argmax parted: kernel {got[0]:.2e} / {got[1]:.2e}, twin on '
            f'y (1 + 2^-22) {rounding[0]:.2e} / {rounding[1]:.2e} (limits '
            f'{limit[0]:.2e} / {limit[1]:.2e}), control (no sweep) '
            f'{frozen[0]:.2e} / {frozen[1]:.2e}')
        if not (got[0] <= limit[0] and got[1] <= limit[1]):
            fail(f'K12 warm step {n} -> {n + 1} mismatch at {label}')
        if n == 1 and frozen[0] <= limit[0] and frozen[1] <= limit[1]:
            fail(f'K12 warm step {n} -> {n + 1} at {label}: the control '
                 'stays within the limits, which would not catch a wrong '
                 'warm M-step')
    out_k = fits[iterations]
    p_ref = posterior(il.integration_em_full_reference(
        y, emb, vec, ev, w, *spec, iterations=iterations, **kw))

    def parted(p):
        return (p.argmax(-2) != p_ref.argmax(-2)).float().mean().item()
    kernel = parted(posterior(out_k))
    rounding = parted(posterior(il.integration_em_full_reference(
        y * (1 + 2 ** -22), emb, vec, ev, w, *spec, iterations=iterations,
        **kw), y * (1 + 2 ** -22)))
    limit = 2 * rounding + 0.01
    frozen = None
    if control:
        frozen = parted(posterior(il.integration_em_full_reference(
            y, emb, vec, ev, w, *spec, iterations=iterations, warm_sweeps=0,
            **kw)))
    finite = all(bool(torch.isfinite(x).all()) for x in out_k)
    wsum = (out_k[2].sum(-1) - 1).abs().max().item()
    sync()
    log(f'K12 {iterations} iter {label}: finite {finite} |sum w - 1| '
        f'{wsum:.2e}; frames whose argmax parts from the twin: kernel '
        f'{kernel:.4f}, twin on y (1 + 2^-22) {rounding:.4f} (limit '
        f'{limit:.4f})'
        f'{f", control (frozen eigenvectors) {frozen:.4f}" if control else ""}')
    if not (finite and wsum < 1e-4 and kernel <= limit):
        fail(f'K12 {iterations}-iteration check failed at {label}')
    if control and frozen <= limit:
        fail(f'K12 {iterations}-iteration check at {label}: the control '
             'stays within the limit, which would not catch a wrong warm '
             'M-step')
    return max(errors[:2])


def phase_kernels():
    results = phase_kernels_cacgmm()
    results.update(phase_kernels_mixtures())
    return results


def phase_kernels_cacgmm():
    """The cACGMM path's kernels against their twins: K2, K3, K1, K4,
    K5, K11."""
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
    for D in (1, 2, 8, 16):
        check_gev(300, D, seed=40 + D)
    # K1 at the long path's M-step shape: 4 recordings x 257 bins x 3,
    # every D, both dtypes, sort on and off, 1e-20 and NaN batches
    results['eigh'] = phase_kernels_eigh()
    # K4: batched 60 s recordings (T = 3753, not a multiple of the tile)
    results['stream'] = check_stream(4, 257, 6, 3, 3753, seed=14)
    check_stream(1, 257, 6, 3, 3753, seed=15, weight_mode='fc')
    check_stream(2, 65, 6, 3, 1000, seed=16, saliency=True, mask=True)
    check_stream(1, 33, 3, 2, 777, seed=17, weight_mode='fc',
                 saliency=True)
    check_stream_fit(4, 257, 6, 3, 3753, seed=18)
    # K5: the bench shape, D=6 with saliency and a mask that silences a
    # class, B=1 with the posterior the aligner reads, odd shapes
    results['fc'] = check_fc(8, 513, 6, 3, 300, seed=19)
    check_fc(2, 129, 6, 3, 304, seed=20, saliency=True, mask=True)
    check_fc(1, 257, 6, 3, 304, seed=21, emit=True)
    check_fc(1, 65, 8, 4, 150, seed=22)
    check_fc(2, 33, 3, 2, 777, seed=23, saliency=True)
    check_fc_fit(8, 513, 6, 3, 300, seed=24)
    # K11: the E-step at F=513, T=300, the scatter at the slice shape and
    # past one shared-memory tile
    results['e_step'], _ = check_estep(513, 6, 3, 300, seed=25)
    _, results['scatter'] = check_estep(257, 6, 3, 304, seed=26)
    check_estep(65, 6, 3, 1100, seed=27)
    check_estep(33, 4, 2, 37, seed=28)
    # a minute (T = 3753, bins split over CTAs), and an odd shape whose
    # grid is a partial wave with a short last span
    check_estep(513, 6, 3, 3753, seed=31)
    check_estep(129, 6, 3, 301, seed=32)
    # every D of both kernels, with K = 5 and 8: two groups of classes,
    # so the pass re-reads a segment and the E-step runs again a group
    for D in range(1, 17):
        check_estep(33, D, 5, 304, seed=600 + D)
        check_estep(33, D, 8, 3753, seed=700 + D)
    # K2 with saliency and a mask that silences a class in 16 bins
    results['em_extras'] = check_em(2, 129, 6, 3, 304, seed=29, extras=True)
    return results


def phase_kernels_mixtures():
    """The other mixtures' kernels against their twins: K6, K7, K8, K9,
    K10, K12."""
    results = phase_kernels_cwmm()
    # K7: the long-T config (one recording, F=513, T=4000), fc weights at
    # the bench shape, saliency at an odd T; the whole streamed fit
    results['watson_stream'] = check_watson_stream(1, 513, 6, 3, 4000,
                                                   seed=55)
    check_watson_stream(8, 513, 6, 3, 300, seed=56, weight_mode='fc')
    check_watson_stream(2, 65, 6, 3, 1001, seed=57, saliency=True)
    check_watson_stream_fit(1, 513, 6, 3, 4000, seed=58)
    check_watson_stream_fit(8, 513, 6, 3, 300, seed=59, weight_mode='fc',
                            iterations=20)
    # K8 at the streamed route's M-step shape (4 recordings x 257 bins x
    # 3 classes), cold and warm, D in {3, 6, 8}, and a finite bound
    results['bingham'] = check_bingham(4 * 257 * 3, 6, seed=70)
    check_bingham(4 * 257 * 3, 3, seed=71)
    check_bingham(4 * 257 * 3, 8, seed=72)
    check_bingham(4 * 257 * 3, 6, seed=73, max_concentration=50.)
    results.update(phase_kernels_cbmm())
    # the Bingham K7: the long-T config (F=513, T=4000), fc weights at the
    # bench shape, saliency at an odd T; the whole streamed fit
    results['bingham_stream'] = check_bingham_stream(1, 513, 6, 3, 4000,
                                                     seed=79)
    check_bingham_stream(8, 513, 6, 3, 300, seed=80, weight_mode='fc')
    check_bingham_stream(2, 65, 6, 3, 1001, seed=81, saliency=True)
    check_bingham_stream_fit(1, 513, 6, 3, 4000, seed=82)
    check_bingham_stream_fit(8, 513, 6, 3, 300, seed=83, weight_mode='fc')
    # K10 at bench config 3 (F=513, T=300, D=6, K=3, E=20) in both
    # spectral modes, with and without saliency, at T=1, past a tile and
    # at an odd T, at B=8, at D=8, K=4 and at the floor; bit for bit again
    results['integration_stats'] = phase_kernels_integration_stats()
    results.update(phase_kernels_integration_loop())
    return results


def phase_kernels_cwmm():
    """K6 against its twin: the bench and CWMM config-2 shape, the slice
    shape (with the frozen-eigenvector control of the warm steps),
    saliency with a class silenced in 16 bins, odd shapes."""
    results = {}
    results['cwmm_bench'] = check_cwmm(8, 513, 6, 3, 300, seed=50)
    results['cwmm_slice'] = check_cwmm(8, 257, 6, 3, 304, seed=51,
                                       control=True)
    check_cwmm(2, 129, 6, 3, 304, seed=52, saliency=True, silence=True)
    check_cwmm(1, 65, 3, 2, 777, seed=53)
    check_cwmm(1, 65, 8, 4, 150, seed=54)
    return results


def phase_kernels_integration_loop():
    """K12 against its twin: the trainer's 19 in-kernel iterations at
    config 3 on random and on separable data, both modes, two utterances
    folded, D=8, K=4, and config 3 at B=8 (CTAs striding over the
    bins)."""
    results = {}
    results['integration_loop'] = check_integration_loop(
        513, 6, 3, 300, 20, 1, 'vmf', seed=97, iterations=19)
    check_integration_loop(513, 6, 3, 300, 20, 1, 'gaussian', seed=98,
                           iterations=19)
    check_integration_loop(513, 6, 3, 300, 20, 1, 'vmf', seed=99,
                           iterations=19, separable=True, control=True)
    check_integration_loop(2 * 257, 6, 3, 301, 20, 2, 'gaussian', seed=100,
                           iterations=19, separable=True)
    check_integration_loop(130, 8, 4, 150, 7, 2, 'vmf', seed=101,
                           iterations=10, separable=True)
    check_integration_loop(8 * 513, 6, 3, 300, 20, 8, 'vmf', seed=104,
                           iterations=19)
    return results


def phase_kernels_cbmm():
    """K9 against its twin: the slice and bench shapes, saliency with a
    class silenced in 16 bins, a finite bound, odd shapes, and the
    isotropic fit."""
    results = {}
    results['cbmm_slice'] = check_cbmm(8, 257, 6, 3, 304, seed=74,
                                       control=True)
    check_cbmm(8, 513, 6, 3, 300, seed=75, saliency=True, silence=True)
    check_cbmm(1, 65, 6, 3, 304, seed=76, max_concentration=50.)
    check_cbmm(1, 65, 3, 2, 777, seed=77)
    check_cbmm(1, 65, 8, 4, 150, seed=78)
    check_cbmm_conditioned(8 * 257, 6, 3, 304, seed=86)
    return results


def phase_guards():
    """Checks that fail before any work on CUDA instead of running plain
    code on the card: a mesh that is not a DeviceMesh raises TypeError,
    and get_lcmv_vector_souden raises NotImplementedError as the JAX
    package's does."""
    import torch
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.extraction import get_lcmv_vector_souden
    g = torch.Generator('cuda').manual_seed(0)
    obs = torch.randn((6, 8000), device='cuda', generator=g)
    psd = torch.eye(6, dtype=torch.complex64, device='cuda').expand(
        257, 6, 6)
    for name, call, error in (
            ("separate(mesh='f')", lambda: P.separate(obs, mesh='f'),
             TypeError),
            ('get_lcmv_vector_souden',
             lambda: get_lcmv_vector_souden(psd, psd, psd),
             NotImplementedError)):
        try:
            call()
        except error as e:
            log(f'guard {name}: {error.__name__} ({str(e)[:60]}...)')
        else:
            fail(f'{name} did not raise {error.__name__} on CUDA')


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


def load_sources(seeds):
    """(B, 2, N) float32 clean sources of the utterances, on the card."""
    import numpy as np
    import torch
    from pb_bss_tpu_torch.testing import low_reverberation_data
    return torch.as_tensor(np.stack([
        low_reverberation_data(seed=s)['speech_source'] for s in seeds]),
        dtype=torch.float32).cuda()


def phase_main_path():
    import torch
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.evaluation import si_sdr, si_sdr_stft
    from pb_bss_tpu_torch.ops.em_loop import cacgmm_em_full
    from pb_bss_tpu_torch.ops.gev import gev

    obs, images = load_utterances(range(8))
    obs = obs.cuda()
    sync()
    reset_counters()
    out = P.separate_batch(obs, num_classes=3, iterations=20,
                           beamformer='gev+ban')
    sync()
    launches = {'em_loop.cacgmm_em_full': cacgmm_em_full.launches,
                'gev.gev': gev.launches}
    log(f'main path separate_batch(8 x {tuple(obs.shape[1:])}, '
        f"'gev+ban', 20 it) -> {tuple(out.shape)}; launches {launches}")
    if any(n == 0 for n in launches.values()):
        fail(f'a kernel of the main path was not launched: {launches}')
    if launches['gev.gev'] != 1:
        fail(f'separate_batch launched K3 {launches["gev.gev"]} times, not '
             'once (the loading retry runs in the same launch)')
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


def phase_cli(observation, name='mixture'):
    import numpy as np
    from scipy.io import wavfile
    OUT.mkdir(parents=True, exist_ok=True)
    wav = OUT / f'{name}.wav'
    peak = np.abs(observation).max()
    wavfile.write(wav, 8000, (observation.T / peak * 0.9 * 32767)
                  .astype(np.int16))
    out_dir = OUT / f'{name}_separated'
    for old in out_dir.glob('*.wav'):
        old.unlink()
    result = subprocess.run(
        [sys.executable, '-m', 'pb_bss_tpu_torch', str(wav), '-k', '3',
         '-b', 'gev+ban', '-o', str(out_dir)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    files = sorted(out_dir.glob('*.wav'))
    log(f'CLI ({name}, {observation.shape[-1]} samples) rc '
        f'{result.returncode}, wrote {[f.name for f in files]}')
    if result.returncode != 0:
        fail(f'CLI failed:\n{result.stderr[-2000:]}')
    if len(files) != 3:
        fail(f'CLI wrote {len(files)} files, expected 3')
    for f in files:
        _, data = wavfile.read(f)
        if not (np.isfinite(data).all() and np.abs(data).max() > 0):
            fail(f'{f.name} is not a finite, non-silent signal')


# ---------------------------------------------------------------------
# the evaluation layer and the transforms
# ---------------------------------------------------------------------

# card against the port's host float64 oracles on the same signals: the
# JAX package's own float32 bounds (tests/test_evaluation/
# test_bss_eval_device.py, test_stoi_device.py, test_srmr_device.py)
EVAL_BSS_ATOL_DB = 0.05
EVAL_STOI_ATOL = 2e-3
EVAL_SRMR_RTOL = 2e-3
# the input metrics' host oracles score the first utterances only (each
# is 6 channels x 2 speakers of host BSS-Eval, STOI and SRMR, ~3 s)
EVAL_INPUT_ORACLE_UTTERANCES = 2
# card against CPU, both float32, relative to the output's peak; the
# port's CPU float32 against float64 parts by 2.4e-7 (fft), 1.1e-4
# (scan), 2.9e-7 (Griffin-Lim) and 1.9e-7 (MISI) on these signals
TRANSFORM_RTOL = {'gammatone fft': 1e-5, 'gammatone scan': 1e-3,
                  'griffin_lim': 1e-4, 'misi': 1e-4}


def eval_gap(name, card, host, atol=None, rtol=None):
    """Log and hold the largest gap of a card metric to its host
    oracle (absolute, or relative to the oracle with ``rtol``)."""
    import numpy as np
    card = np.asarray(card, float)
    host = np.asarray(host, float)
    gap = np.abs(card - host)
    if rtol is not None:
        gap = gap / np.abs(host)
    gap = float(gap.max())
    bound = atol if rtol is None else rtol
    log(f'evaluation {name}: card against host oracle {gap:.3e} '
        f'({"rtol" if rtol is not None else "atol"} {bound})')
    if not (np.isfinite(card).all() and gap <= bound):
        fail(f'evaluation {name}: card {card.tolist()} against host '
             f'{host.tolist()}, gap {gap} over {bound}')


def stage_times(label, call, inputs):
    """Host ms per synchronized call (distinct inputs a repetition, after
    a warm-up), CUDA-event ms per call, the profiler's device ms of one
    call and the idle share 1 - device / host."""
    call(*inputs[0])
    sync()
    host = []
    for args in inputs[1:]:
        t0 = time.perf_counter()
        call(*args)
        sync()
        host.append(1e3 * (time.perf_counter() - t0))
    events = cuda_time(call, inputs[1:], warmup=0)
    prof, _ = profile_device(lambda: call(*inputs[0]))
    device_ms, kernels = device_times(prof, '')['all kernels']
    device_ms /= 1e3
    host_ms = sum(host) / len(host)
    log(f'timing {label}: host {host_ms:.3f} ms a call '
        f'({", ".join(f"{h:.3f}" for h in host)}), events {events:.3f}, '
        f'device {device_ms:.4f} ms in {kernels} kernels, idle share '
        f'{1 - device_ms / host_ms:.3f} ({card_note()})')


def phase_evaluation():
    """The evaluation stage after the separation: separate_batch of the
    8 utterances (K2 once or more, K3 once), OutputMetricsBatch of its
    CUDA output against the 2 sources (3 classes against 2 speakers: the
    K+1 routing) and InputMetricsBatch of the observations, on the card,
    each held against the port's host float64 oracles on the same
    signals moved to the CPU; the stages timed, with bench.py's configs
    5b (bss_eval_stoi_fused_batch, B=8, K=2, 2 s at 8 kHz) and 5c
    (srmr_batch, 8 x 2 s); the gammatone filterbank and 10 Griffin-Lim /
    MISI iterations on the card against the CPU."""
    import numpy as np
    import torch
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.evaluation import (
        InputMetrics, InputMetricsBatch, OutputMetrics, OutputMetricsBatch,
        srmr_batch)
    from pb_bss_tpu_torch.evaluation._fused_eval_device import (
        bss_eval_stoi_fused_batch)
    from pb_bss_tpu_torch.evaluation import module_srmr_device
    from pb_bss_tpu_torch.ops.em_loop import cacgmm_em_full
    from pb_bss_tpu_torch.ops.gev import gev
    from pb_bss_tpu_torch.testing import low_reverberation_data

    data = [low_reverberation_data(seed=s) for s in range(8)]
    obs = torch.as_tensor(np.stack([d['observation'] for d in data]),
                          dtype=torch.float32).cuda()
    sources = load_sources(range(8))
    sync()
    reset_counters()
    out = P.separate_batch(obs, num_classes=3, iterations=20,
                           beamformer='gev+ban')
    sync()
    launches = {'em_loop.cacgmm_em_full': cacgmm_em_full.launches,
                'gev.gev': gev.launches}
    log(f'evaluation: separate_batch(8 x {tuple(obs.shape[1:])}, '
        f"'gev+ban', 20 it) -> {tuple(out.shape)} on {out.device}; "
        f'launches {launches}')
    if launches['em_loop.cacgmm_em_full'] < 1 or launches['gev.gev'] != 1:
        fail(f'separate_batch before the metrics launched {launches}: '
             'K2 at least once and K3 exactly once expected')

    # output metrics: the CUDA output straight into the batch facade
    t0 = time.perf_counter()
    card = OutputMetricsBatch(out, sources, sample_rate=8000,
                              enable_si_sdr=True, device='cuda').as_dict()
    sync()
    log(f'evaluation OutputMetricsBatch (first call): '
        f'{time.perf_counter() - t0:.2f} s')
    est_cpu = out.cpu().double().numpy()
    src_cpu = sources.cpu().double().numpy()
    host = [OutputMetrics(est_cpu[b], src_cpu[b], sample_rate=8000,
                          enable_si_sdr=True, device='cpu',
                          device_metrics=False).as_dict()
            for b in range(len(data))]
    host = {key: np.stack([h[key] for h in host]) for key in host[0]}
    for b in range(len(data)):
        log(f'evaluation utterance {b}: selection '
            f"{card['mir_eval_selection'][b].tolist()} "
            + ' '.join(f'{key} {np.round(card[key][b], 3).tolist()}'
                       for key in ('mir_eval_sdr', 'mir_eval_sir',
                                   'mir_eval_sar', 'stoi', 'si_sdr',
                                   'srmr')))
    if not np.array_equal(card['mir_eval_selection'],
                          host['mir_eval_selection']):
        fail(f"evaluation selection: card {card['mir_eval_selection']} "
             f"against host {host['mir_eval_selection']}")
    for key in ('mir_eval_sdr', 'mir_eval_sir', 'mir_eval_sar', 'si_sdr'):
        eval_gap(f'output {key}', card[key], host[key],
                 atol=EVAL_BSS_ATOL_DB)
    eval_gap('output stoi', card['stoi'], host['stoi'], atol=EVAL_STOI_ATOL)
    eval_gap('output srmr', card['srmr'], host['srmr'], rtol=EVAL_SRMR_RTOL)
    log(f"evaluation batch means: SDR {card['mir_eval_sdr'].mean():.3f} "
        f"dB, SIR {card['mir_eval_sir'].mean():.3f}, SAR "
        f"{card['mir_eval_sar'].mean():.3f}, STOI "
        f"{card['stoi'].mean():.4f}, SI-SDR {card['si_sdr'].mean():.3f}, "
        f"SRMR {card['srmr'].mean():.4f}")

    # input metrics: the observations on the card
    card_in = InputMetricsBatch(obs, sources, sample_rate=8000,
                                enable_si_sdr=True,
                                device='cuda').as_dict()
    n = EVAL_INPUT_ORACLE_UTTERANCES
    obs_cpu = obs.cpu().double().numpy()
    host_in = [InputMetrics(obs_cpu[b], src_cpu[b], sample_rate=8000,
                            enable_si_sdr=True, device='cpu',
                            device_metrics=False).as_dict()
               for b in range(n)]
    for key in ('mir_eval_sdr', 'mir_eval_sir', 'mir_eval_sar', 'si_sdr'):
        eval_gap(
            f'input {key} (utterances 0-{n - 1})', card_in[key][:n],
            np.stack([h[key] for h in host_in]), atol=EVAL_BSS_ATOL_DB)
    eval_gap(
        'input stoi', card_in['stoi'][:n],
        np.stack([h['stoi'] for h in host_in]), atol=EVAL_STOI_ATOL)
    eval_gap(
        'input srmr', card_in['srmr'][:n],
        np.stack([h['srmr'] for h in host_in]), rtol=EVAL_SRMR_RTOL)
    log(f"evaluation input means: SDR {card_in['mir_eval_sdr'].mean():.3f}"
        f" dB, STOI {card_in['stoi'].mean():.4f}, SRMR "
        f"{card_in['srmr'].mean():.4f}")

    # timings, distinct inputs a repetition
    g = torch.Generator('cuda').manual_seed(15)
    outs = [out + 1e-4 * r * torch.randn(out.shape, device='cuda',
                                         generator=g) for r in range(4)]
    stage_times(
        'OutputMetricsBatch(8 x 4.8 s, K+1).as_dict()',
        lambda e: OutputMetricsBatch(e, sources, sample_rate=8000,
                                     enable_si_sdr=True,
                                     device='cuda').as_dict(),
        [(e,) for e in outs])
    obs_reps = [obs + 1e-4 * r * torch.randn(obs.shape, device='cuda',
                                             generator=g)
                for r in range(4)]
    stage_times(
        'InputMetricsBatch(8 x 6 ch x 4.8 s).as_dict()',
        lambda o: InputMetricsBatch(o, sources, sample_rate=8000,
                                    enable_si_sdr=True,
                                    device='cuda').as_dict(),
        [(o,) for o in obs_reps])
    refs = torch.randn((2, 16000), device='cuda', generator=g)
    batch_inputs = [
        (refs + 0.001 * torch.randn((8, 2, 16000), device='cuda',
                                    generator=g),
         refs + 0.1 * torch.randn((8, 2, 16000), device='cuda',
                                  generator=g))
        for _ in range(4)]
    stage_times(
        'bss_eval_stoi_fused_batch(B=8, K=2, 2 s at 8 kHz)',
        lambda r, e: bss_eval_stoi_fused_batch(r, e, 8000, device='cuda'),
        batch_inputs)
    top_kernels('evaluation OutputMetricsBatch(8 x 4.8 s)',
                lambda e: OutputMetricsBatch(e, sources, sample_rate=8000,
                                             enable_si_sdr=True,
                                             device='cuda').as_dict(),
                (outs[0],))
    top_kernels('evaluation config 5b',
                lambda r, e: bss_eval_stoi_fused_batch(r, e, 8000,
                                                       device='cuda'),
                batch_inputs[0])
    stage_times(
        'srmr_batch(8 x 2 s at 8 kHz)',
        lambda e: srmr_batch(e[:, 0], 8000, device='cuda'),
        [(e,) for _, e in batch_inputs])
    for label, signals in (('8 x 2 s', batch_inputs[0][1][:, 0]),
                           ('16 separated 4.8 s', out[:, :2])):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        srmr_batch(signals, 8000, device='cuda')
        sync()
        peak = torch.cuda.max_memory_allocated() - base
        count = int(np.prod(signals.shape[:-1]))
        m = module_srmr_device._bucket(np.array([signals.shape[-1]]), 8000)
        per = module_srmr_device._working_set_per_signal(m, 23, 4)
        chunk = max(1, module_srmr_device._WORKING_SET_BYTES // per)
        log(f'srmr_batch {label}: peak {peak / 2**20:.1f} MiB above the '
            f'inputs for {count} signals in chunks of {min(chunk, count)} '
            f'(estimate {per / 2**20:.1f} MiB a signal, bucket {m})')

    # transforms on the card against the CPU
    from pb_bss_tpu_torch.transform import gammatone_filterbank, stft
    from pb_bss_tpu_torch.transform.griffin_lim_module import (
        griffin_lim, misi)
    x = obs[0, :2]
    for method in ('fft', 'scan'):
        card_gt = gammatone_filterbank(x, 8000, method=method).cpu()
        cpu_gt = gammatone_filterbank(x.cpu(), 8000, method=method)
        transform_gap(f'gammatone {method}', card_gt, cpu_gt)
    images = torch.as_tensor(data[0]['speech_image'][:, 0],
                             dtype=torch.float32)
    X = stft(images, fading=False)
    y = obs[0, 0].cpu()
    transform_gap(
        'griffin_lim', griffin_lim(X.cuda(), 10).cpu(), griffin_lim(X, 10))
    transform_gap(
        'misi', misi(X.cuda(), y.cuda(), 10).cpu(), misi(X, y, 10))
    return launches


def transform_gap(name, card, cpu):
    """Largest card-against-CPU gap relative to the CPU output's peak,
    held to TRANSFORM_RTOL."""
    import torch
    gap = float((card - cpu).abs().max() / cpu.abs().max())
    log(f'transform {name} {tuple(card.shape)}: card against CPU '
        f'{gap:.3e} of the peak (rtol {TRANSFORM_RTOL[name]})')
    if not (bool(torch.isfinite(card).all())
            and gap <= TRANSFORM_RTOL[name]):
        fail(f'transform {name}: card against CPU {gap}')


# (K3, K1) launches of one separate_batch of 8 x 4.8 s utterances (B=8,
# F=257, K=3, D=6: 6,168 pencils) per extraction route: a GEV (K3) per
# 'gev' or 'rank1_gev+' / 'scaled_gev_atf' estimate, a Jacobi (K1) per
# PCA or per stable solve (its pseudo-inverse fallback)
EXTRACTION_LAUNCHES = {
    'mvdr_souden': (0, 1), 'mvdr_souden+ban': (0, 1), 'wmwf': (0, 1),
    'rank1_gev+mvdr_souden+ban': (1, 1), 'scaled_gev_atf+mvdr': (1, 1),
    'rank1_pca+mvdr_souden': (0, 2), 'pca+mvdr': (0, 2), 'pca': (0, 1),
    'ch0': (0, 0)}
# refine='fca' at 20 refinement iterations: a stable solve per IP row
# (D=6) per iteration, and one for the inverse diagonalizer
FCA_LAUNCHES = 20 * 6 + 1
# how a route's vectors on the card are aligned to the CPU's before the
# comparison: 'phase', by a unit complex number per pencil, for the names
# whose vector carries an eigenvector's arbitrary phase; 'scale', by a
# complex number per pencil, for MVDR-Souden on a rank-1 target, whose
# columns are all proportional (Phi_nn^-1 a conj(a_R)), so that their
# post-SNRs nearly tie and the reference channel (an argmax over them)
# sets only a complex scale per bin
EXTRACTION_ALIGN = {'scaled_gev_atf+mvdr': 'phase', 'pca+mvdr': 'phase',
                    'pca': 'phase', 'rank1_gev+mvdr_souden+ban': 'scale',
                    'rank1_pca+mvdr_souden': 'scale'}


def pipeline_psds(obs):
    """The (B, K, F, D, D) target and noise PSDs the pipeline hands to
    get_bf_vector for ``obs`` ('mvdr_souden', 20 iterations), captured
    at the call."""
    import pb_bss_tpu_torch.pipeline as pipeline
    captured = {}
    original = pipeline.get_bf_vector

    def spy(name, target, noise, **kwargs):
        captured['psds'] = (target.contiguous(), noise.contiguous())
        return original(name, target, noise, **kwargs)
    pipeline.get_bf_vector = spy
    try:
        pipeline.separate_batch(obs, iterations=20, beamformer='mvdr_souden')
    finally:
        pipeline.get_bf_vector = original
    return captured['psds']


def per_pencil_error(out, ref):
    """Max over D of |out - ref| / max|ref| per pencil."""
    return (out - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)


def check_bf_routes(psds):
    """get_bf_vector of every extraction route on the card (the
    kernels) against the plain route on the CPU for the same PSDs:
    the eigenvector-based names after removing each pencil's phase; the
    reference channels of 'mvdr_souden' and 'wmwf' exactly. Returns
    {route: (max error, pencils above 1e-2)}."""
    import torch
    from pb_bss_tpu_torch.extraction import get_bf_vector
    from pb_bss_tpu_torch.extraction import beamformer as bf
    target, noise = psds
    cpu = target.cpu(), noise.cpu()
    results = {}
    for route in EXTRACTION_LAUNCHES:
        out = get_bf_vector(route, target, noise).cpu()
        ref = get_bf_vector(route, *cpu)
        align = EXTRACTION_ALIGN.get(route)
        if align is not None:
            inner = (out.conj() * ref).sum(-1, keepdim=True)
            factor = inner / inner.abs() if align == 'phase' \
                else inner / (out.abs() ** 2).sum(-1, keepdim=True)
            out = out * factor.where(inner != 0, torch.ones_like(inner))
        err = per_pencil_error(out, ref)
        finite = bool(torch.isfinite(out).all())
        # a pencil whose f32 LU residual sits at the stable solve's gate
        # (sqrt(eps)) can take the LU solution on one device and the
        # pseudo-inverse on the other; at most 1% of them may part
        above = int((err > 1e-2).sum())
        results[route] = (err.max().item(), above)
        log(f'get_bf_vector({route!r}) on {tuple(target.shape)}: card vs '
            f'CPU plain, max error {err.max().item():.3g}, '
            f'{above} of {err.numel()} pencils above 1e-2')
        if not finite or above > err.numel() // 100:
            fail(f'get_bf_vector({route!r}) on the card parts from the '
                 f'plain route: finite {finite}, {above} pencils above 1e-2')
    def wmwf_channel(t, n):
        phi = bf.stable_solve(n, t)
        return bf._reference_channel(
            phi / (1 + bf._trace(phi)[..., None, None]), t, n)

    for name, call in (
            ('mvdr_souden', lambda t, n: bf.get_mvdr_vector_souden(
                t, n, return_ref_channel=True)[1]),
            ('wmwf', wmwf_channel)):
        card, plain = call(target, noise).cpu(), call(*cpu)
        log(f'{name} reference channels per (utterance, class): card '
            f'{card.tolist()}, CPU {plain.tolist()}')
        if not torch.equal(card, plain):
            fail(f'{name}: the reference channels on the card differ from '
                 'the plain route on the CPU')
    return results


def check_stable_solve():
    """stable_solve on 6,168 6 x 6 systems (the extraction stage's batch)
    with zero, rank-deficient and infinite matrices planted, against the
    plain route on the CPU: one K1 launch, no host sync (torch's sync
    debug mode set to error), finite except the infinite system.
    Returns the max error over the finite systems."""
    import torch
    from pb_bss_tpu_torch.ops import eigh
    from pb_bss_tpu_torch.ops.linalg import stable_solve
    g = torch.Generator('cuda').manual_seed(77)
    a = torch.randn((6168, 6, 6), dtype=torch.complex64, device='cuda',
                    generator=g)
    a = a + 3 * torch.eye(6, dtype=a.dtype, device='cuda')
    b = torch.randn((6168, 6, 6), dtype=torch.complex64, device='cuda',
                    generator=g)
    a[10] = 0
    a[20, :, 0] = a[20, :, 1]
    u = torch.randn((6, 2), dtype=a.dtype, device='cuda', generator=g)
    a[30] = u @ u.conj().T
    a[40] *= float('inf')
    stable_solve(a, b)
    sync()
    eigh.eigh_jacobi.launches = 0
    torch.cuda.set_sync_debug_mode('error')
    try:
        x = stable_solve(a, b)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    sync()
    launches = eigh.eigh_jacobi.launches
    ref = stable_solve(a.cpu(), b.cpu())
    x = x.cpu()
    keep = torch.ones(6168, dtype=torch.bool)
    keep[40] = False
    err = ((x[keep] - ref[keep]).abs().amax((-2, -1))
           / ref[keep].abs().amax((-2, -1)).clamp_min(1e-30))
    log(f'stable_solve 6168 x 6x6 (zero, rank-deficient, inf planted): '
        f'K1 launches {launches}, no host sync, max error vs CPU plain '
        f'{err.max().item():.3g}; zero system -> '
        f'{x[10].abs().max().item()}, inf system finite '
        f'{bool(torch.isfinite(x[40]).all())}')
    if launches != 1:
        fail(f'stable_solve launched K1 {launches} times, not once')
    if not (bool(torch.isfinite(x[keep]).all())
            and not bool(torch.isfinite(x[40]).all())
            and bool((x[10] == 0).all()) and err.max().item() < 1e-3):
        fail('stable_solve on the card parts from the plain route')
    return err.max().item()


def check_quantile_mask():
    """quantile_mask over 6 x 513 x 7,500 (a minute at 16 kHz, F=513,
    D=6: 23 M elements, above torch.quantile's 2^24 limit) on the card,
    against the same code on the CPU (bit for bit) and np.percentile
    (equal except where a value lies within 1e-6 of the threshold)."""
    import numpy as np
    import torch
    from pb_bss_tpu_torch.extraction import quantile_mask
    g = torch.Generator('cuda').manual_seed(78)
    x = torch.randn((6, 513, 7500), dtype=torch.complex64, device='cuda',
                    generator=g)
    card = quantile_mask(x, quantile=(0.1, -0.9)).cpu()
    plain = quantile_mask(x.cpu(), quantile=(0.1, -0.9))
    rows = np.moveaxis(x.abs().cpu().numpy(), -2, -1).reshape(-1, 513)
    mismatched = 0
    for m, q, above in ((card[0], 0.9, True), (card[1], 0.9, False)):
        threshold = np.percentile(rows.astype(np.float64), 100 * q, axis=-1)
        hard = rows > threshold[:, None] if above \
            else rows < threshold[:, None]
        ours = np.moveaxis(m.numpy(), -2, -1).reshape(-1, 513) > 0.5
        near = np.abs(rows - threshold[:, None]) <= 1e-6 * threshold[:, None]
        mismatched += int(((ours != hard) & ~near).sum())
    log(f'quantile_mask on {x.numel()} elements (> 2^24): card == CPU '
        f'{torch.equal(card, plain)}, {mismatched} decisions apart from '
        'np.percentile')
    if not torch.equal(card, plain) or mismatched:
        fail('quantile_mask on the card parts from the CPU or np.percentile')


def phase_extraction():
    """separate_batch of the 8 smoke utterances (20 iterations) with
    each extraction route of the slice: finite output, the K3 / K1
    launches of EXTRACTION_LAUNCHES, the SI-SDR floors; then
    get_bf_vector of every route on the pipeline's PSDs against the CPU,
    stable_solve at 6,168 systems and quantile_mask above 2^24
    elements. Returns ({route: launches}, {check: max error})."""
    import torch
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.evaluation import si_sdr_stft
    obs, images = load_utterances(range(8))
    obs = obs.cuda()
    routes = {}
    for route, (k3, k1) in EXTRACTION_LAUNCHES.items():
        sync()
        reset_counters()
        out = P.separate_batch(obs, num_classes=3, iterations=20,
                               beamformer=route)
        sync()
        launches = read_counters()
        routes[route] = launches
        want = dict.fromkeys(launches, 0)
        want.update({'em_loop.cacgmm_em_full': 1, 'gev.gev': k3,
                     'eigh.eigh_jacobi': k1})
        expect_launches(f'separate_batch(8 x 4.8 s, {route!r}, 20 it)',
                        launches, want)
        if not bool(torch.isfinite(out).all()):
            fail(f'separate_batch({route!r}) output is not finite')
        scores = si_sdr_stft(images[:, :, None],
                             out.cpu().double()[:, None]).max(-1).values
        means = scores.mean(0)
        mean_floor, single_floor = EXTRACTION_FLOORS_DB[route]
        log(f'  {route}: SI-SDR (stft) batch mean per speaker '
            f'{[round(v, 2) for v in means.tolist()]}, worst '
            f'{scores.min().item():.2f} dB (floors {mean_floor} / '
            f'{single_floor})')
        if not (bool((means >= mean_floor).all())
                and bool((scores >= single_floor).all())):
            fail(f'{route!r}: separation quality below the floor')
    errors = {'bf_routes': check_bf_routes(pipeline_psds(obs)),
              'stable_solve': check_stable_solve()}
    check_quantile_mask()
    return routes, errors


def phase_fca():
    """separate_batch(refine='fca') of the 8 smoke utterances (20 EM and
    20 refinement iterations): finite output, FCA_LAUNCHES K1 launches
    (the batch folded into FCA's bins: one stable solve a row for all
    2,056 bins), and the quality floors beside the mask path's."""
    import torch
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.evaluation import si_sdr, si_sdr_stft
    obs, images = load_utterances(range(8))
    obs = obs.cuda()
    sync()
    reset_counters()
    out = P.separate_batch(obs, num_classes=3, iterations=20, refine='fca')
    sync()
    launches = read_counters()
    want = dict.fromkeys(launches, 0)
    want.update({'em_loop.cacgmm_em_full': 1,
                 'eigh.eigh_jacobi': FCA_LAUNCHES})
    expect_launches("separate_batch(8 x 4.8 s, refine='fca', 20 + 20 it)",
                    launches, want)
    if not bool(torch.isfinite(out).all()):
        fail("separate_batch(refine='fca') output is not finite")
    masked = P.separate_batch(obs, num_classes=3, iterations=20)
    sync()
    for metric in (si_sdr, si_sdr_stft):
        for name, result in (('fca', out), ('mask', masked)):
            scores = metric(images[:, :, None],
                            result.cpu().double()[:, None]).max(-1).values
            log(f'  {name} {metric.__name__}: batch mean per speaker '
                f'{[round(v, 2) for v in scores.mean(0).tolist()]}, worst '
                f'{scores.min().item():.2f} dB')
            if name == 'fca' and metric is si_sdr:
                means = scores.mean(0)
                if not (bool((means >= FCA_MEAN_FLOOR_DB).all()) and bool(
                        (scores >= FCA_SINGLE_FLOOR_DB).all())):
                    fail("refine='fca': separation quality below the floor "
                         f'({FCA_MEAN_FLOOR_DB} / {FCA_SINGLE_FLOOR_DB} dB)')
    # the JAX package's hold on the refinement: BSS-Eval SDR no worse
    # than the mask path's less FCA_BSS_MARGIN_DB (tests/test_example.py::
    # test_separate_fca_refinement), here per speaker over the batch, on
    # the card (3 classes against 2 speakers: the K+1 routing)
    from pb_bss_tpu_torch.evaluation import OutputMetricsBatch
    sources = load_sources(range(8))
    sdr = {name: OutputMetricsBatch(result, sources, device='cuda')
           .mir_eval_sdr for name, result in (('fca', out),
                                              ('mask', masked))}
    for name, values in sdr.items():
        log(f'  {name} bss_eval SDR: batch mean per speaker '
            f'{[round(float(v), 2) for v in values.mean(0)]}, worst '
            f'{float(values.min()):.2f} dB')
    if not bool((sdr['fca'].mean(0)
                 >= sdr['mask'].mean(0) - FCA_BSS_MARGIN_DB).all()):
        fail("refine='fca': bss_eval SDR below the mask path's less "
             f'{FCA_BSS_MARGIN_DB} dB')
    return launches


def phase_extraction_checks():
    """phase_extraction and phase_fca, for ``--only extraction_checks``."""
    return phase_extraction(), phase_fca()


# ---------------------------------------------------------------------
# the streaming separator
# ---------------------------------------------------------------------

# StreamingSeparator at its defaults (K=3, 512/128, 16-frame blocks, a
# 256-frame warm-up, realignment every 8 blocks) on the first 60 s
# recording of long_recordings (testing.streaming_quality.recording), in
# chunks of 4,096 samples. Time-domain SI-SDR of the best output per
# speaker against the reverberant images at channel 0. The port's plain
# path on the CPU (python -m pb_bss_tpu_torch.testing.streaming_quality
# --device cpu) gives mask -3.72 / -0.49 dB and 'gev+ban' -19.78 /
# -14.61 dB, the JAX package's stream -3.14 / -1.00 and -30.64 / -16.94
# dB (tests/test_torch_streaming.py::test_streaming_quality_on_the_smoke_
# recording, slow tier, prints both), and the mixture's channel 0 scores
# -2.17 / 2.04 dB: this synthetic
# minute (a new room every 4.8 s) streams as poorly as it separates
# offline (LONG_*_FLOOR_DB), in both packages, so no floor can sit above
# the mixture there. The floors (mean over the speakers, worst speaker)
# sit below the CPU numbers and catch a broken path; the card's random
# start differs from the CPU's. STREAM_STATIC_* hold the stream above the
# mixture on a static scene.
STREAM_FLOORS_DB = {'mask': (-5.0, -8.0), 'gev+ban': (-22.0, -27.0)}
# the 2-speaker 4.8 s scene (low_reverberation_data(0)) streamed as the
# JAX package's slow tests stream it (32-frame blocks, forgetting 1, two
# inner iterations, 20 warm-up iterations; tests/test_torch_streaming.py's
# slow twins print the CPU numbers): on the CPU the mask stream
# scores 2.84 / 11.90 dB against the mixture's -7.95 / 7.72 (time
# domain), the 'gev+ban' stream 8.64 / 6.41 dB against -7.80 / 7.85 per
# frequency (a beamformer's output is its target up to a filter, which
# the time-domain score counts as distortion: -10.79 / -18.31 dB there);
# tests/test_torch_streaming.py's slow tests hold the same margins: each
# speaker 1 dB above the mixture (mask), the mean 1 dB above (beamformer).
STREAM_STATIC_MARGIN_DB = 1.0
STREAM_CHUNK = 4096
# card against CPU for one block from the same state: the E-step of the
# loaded model in f32 on each side (posteriors), the mask synthesis, and
# for 'gev+ban' the PSD update and K3 against the plain GEV (outputs,
# relative to their peak)
STREAM_POSTERIOR_ATOL = 1e-4
STREAM_OUTPUT_RTOL = {'mask': 1e-4, 'gev+ban': 1e-3}


def stream_separator(beamformer, **kwargs):
    from pb_bss_tpu_torch import StreamingSeparator
    return StreamingSeparator(num_classes=3, beamformer=beamformer, **kwargs)


def stream_launches(got):
    return {k: got[k] for k in ('em_loop.cacgmm_em_full', 'eigh.eigh_jacobi',
                                'gev.gev')}


def stream_expected(sep, samples, beamformer):
    """Launches of a stream of ``samples`` at the separator's config: K2
    once (the warm-up fit), K1 per streamed block and inner iteration
    (each block's M-step; flush pads the rest to one more block), K3 per
    synthesized block in 'gev+ban' mode (one get_bf_vector call on all
    classes a block, the warm-up catch-up's blocks included), and no
    other kernel."""
    block = sep.block_frames * sep.shift
    total = -(-samples // block)
    warm = sep.init_frames // sep.block_frames
    want = dict.fromkeys(read_counters(), 0)
    want.update({'em_loop.cacgmm_em_full': 1,
                 'eigh.eigh_jacobi':
                     (total - warm) * sep.stream.inner_iterations,
                 'gev.gev': total if beamformer else 0})
    return want, total - warm


def feed(sep, observation, start=0, stop=None, chunk=STREAM_CHUNK):
    stop = observation.shape[-1] if stop is None else stop
    return [sep.process(observation[:, i:min(i + chunk, stop)])
            for i in range(start, stop, chunk)]


def stream_main(observation, images, beamformer):
    """One mode's main-path run: launches, finite output, reconstruction
    (mask mode), snapshot and resume on the card, flush, quality.
    Returns the launches of K2, K1 and K3."""
    import numpy as np
    from pb_bss_tpu_torch.testing.streaming_quality import scores
    mode = beamformer or 'mask'
    N = observation.shape[-1]
    middle = (N // 2 // STREAM_CHUNK) * STREAM_CHUNK
    sep = stream_separator(beamformer)
    sync()
    reset_counters()
    t0 = time.perf_counter()
    first = feed(sep, observation, 0, middle)
    snapshot = sep.state_dict()
    second = feed(sep, observation, middle) + [sep.flush()]
    sync()
    seconds = time.perf_counter() - t0
    got = read_counters()
    want, streamed = stream_expected(sep, N, beamformer)
    expect_launches(f'StreamingSeparator({mode}) 60 s, {streamed} streamed '
                    f'blocks', got, want)
    out = np.concatenate(first + second, axis=-1)
    delay = sep.size - sep.shift
    if out.shape != (3, N + delay) or not np.isfinite(out).all():
        fail(f'stream ({mode}) gave {out.shape} or non-finite output')
    if sep.flush().shape != (3, 0):
        fail('a second flush() was not empty')
    try:
        sep.process(observation[:, :100])
    except RuntimeError:
        pass
    else:
        fail('process() after flush() did not raise')
    log(f'stream ({mode}): {seconds:.2f} s for {N / 8000:.0f} s of audio '
        f'(a snapshot inside), real-time factor {seconds / (N / 8000):.4f}'
        f' | {card_note()}')

    peak = float(np.abs(observation).max())
    if beamformer is None:
        # the K posteriors sum to one per bin: the outputs sum to the
        # delayed reference channel (the JAX test's 2e-4 on unit-variance
        # noise, whose peak is ~4: 5e-5 of the peak)
        err = float(np.abs(out.sum(0)[delay:N]
                           - observation[0, :N - delay]).max())
        log(f'stream reconstruction: max error {err:.3e} '
            f'({err / peak:.2e} of the peak)')
        if err > 5e-5 * peak:
            fail(f'stream reconstruction error {err} > 5e-5 x {peak}')

    resumed = stream_separator(beamformer).load_state_dict(snapshot)
    rest = np.concatenate(feed(resumed, observation, middle)
                          + [resumed.flush()], axis=-1)
    tail = np.concatenate(second, axis=-1)
    err = float(np.abs(rest - tail).max()) if rest.shape == tail.shape \
        else math.inf
    log(f'stream ({mode}) snapshot at {middle} samples, resumed on a fresh '
        f'card separator: max difference {err:.3e}')
    if err > 1e-5 * max(float(np.abs(tail).max()), 1e-30):
        fail(f'the resumed stream ({mode}) parts from the original: {err}')

    result = scores(images, out[:, delay:delay + N])
    mean_floor, single_floor = STREAM_FLOORS_DB[mode]
    log(f'stream ({mode}) SI-SDR per speaker '
        f"{[round(float(v), 2) for v in result['si_sdr']]} dB (per "
        f"frequency {[round(float(v), 2) for v in result['si_sdr_stft']]}"
        f'; floors {mean_floor} mean / {single_floor} single)')
    if not (result['si_sdr'].mean() >= mean_floor
            and result['si_sdr'].min() >= single_floor):
        fail(f'stream ({mode}) quality below the floor')
    return stream_launches(got)


def card_note():
    return f'card {getattr(phase_device, "card", "unknown")}'


def stream_chunkings(observation):
    """Two chunkings of the first 20 s (mask mode) give the same samples
    (before flush)."""
    import numpy as np
    n = 20 * 8000
    outs = []
    for chunk in (STREAM_CHUNK, 997):
        sep = stream_separator(None)
        outs.append(np.concatenate(feed(sep, observation, 0, n, chunk), -1))
    m = min(o.shape[-1] for o in outs)
    err = float(np.abs(outs[0][:, :m] - outs[1][:, :m]).max())
    log(f'stream chunkings 4096 / 997 of 20 s: {m} samples each, max '
        f'difference {err:.3e}')
    # the JAX test's 1e-5 on unit-variance noise, relative to the peak
    if m < n - 4096 or err > 2.5e-6 * float(np.abs(outs[0]).max()):
        fail(f'two chunkings part: {err} over {m} samples')


def stream_card_against_cpu(observation, beamformer):
    """After warm-up the card's state_dict() is loaded into a CPU
    separator; both take the same next block: posteriors (the block's
    columns of the alignment window) and outputs agree."""
    import numpy as np
    mode = beamformer or 'mask'
    card = stream_separator(beamformer)
    block = card.block_frames * card.shift
    warm = card.init_frames * card.shift
    feed(card, observation, 0, warm, block)
    cpu = stream_separator(beamformer, device='cpu').load_state_dict(
        card.state_dict())
    chunk = observation[:, warm:warm + block]
    out_card, out_cpu = card.process(chunk), cpu.process(chunk)
    B = card.block_frames
    post = float((card._aff_hist[..., -B:].cpu()
                  - cpu._aff_hist[..., -B:]).abs().max())
    err = float(np.abs(out_card - out_cpu).max())
    rel = err / max(float(np.abs(out_cpu).max()), 1e-30)
    log(f'stream ({mode}) card against CPU, one block from the same state: '
        f'posteriors {post:.2e}, outputs {err:.3e} ({rel:.2e} of the peak)')
    if not (post <= STREAM_POSTERIOR_ATOL
            and rel <= STREAM_OUTPUT_RTOL[mode]):
        fail(f'stream ({mode}): the card parts from the CPU on one block')


def stream_static_scene():
    """The 2-speaker 4.8 s scene streamed as the JAX slow tests stream
    it: the mask stream beats the mixture's channel 0 by the margin per
    speaker (time-domain SI-SDR), the 'gev+ban' stream on the mean (per
    frequency)."""
    import numpy as np
    from pb_bss_tpu_torch.testing import low_reverberation_data
    from pb_bss_tpu_torch.testing.streaming_quality import (
        run_stream, scores)
    data = low_reverberation_data(seed=0)
    obs = data['observation'].astype(np.float32)
    images = data['speech_image'][:, 0].astype(np.float64)
    mixture = scores(images, np.broadcast_to(obs[0], images.shape))
    for beamformer, metric in ((None, 'si_sdr'), ('gev+ban', 'si_sdr_stft')):
        out = run_stream(stream_separator(
            beamformer, block_frames=32, forgetting=1.0, inner_iterations=2,
            init_iterations=20), obs)
        result = scores(images, out)
        mode = beamformer or 'mask'
        log(f'static scene stream ({mode}) {metric} '
            f'{[round(float(v), 2) for v in result[metric]]} dB, mixture '
            f'{[round(float(v), 2) for v in mixture[metric]]} dB (time '
            f"domain {[round(float(v), 2) for v in result['si_sdr']]})")
        ours, mix = result[metric], mixture[metric]
        ok = (bool((ours > mix + STREAM_STATIC_MARGIN_DB).all())
              if beamformer is None else
              ours.mean() > mix.mean() + STREAM_STATIC_MARGIN_DB)
        if not (ok and np.isfinite(out).all()):
            fail(f'static scene stream ({mode}) not above the mixture')


def phase_streaming():
    """StreamingSeparator on the card at its defaults on a 60 s
    recording, mask mode then 'gev+ban': the launches of K2 (1), K1 (per
    streamed block) and K3 (per synthesized block in 'gev+ban' mode),
    reconstruction, snapshot and resume, flush, the quality floors; two
    chunkings; card against CPU on one block; the static scene above the
    mixture. Returns {mode: launches of K2, K1 and K3}."""
    import numpy as np
    from pb_bss_tpu_torch.testing.streaming_quality import recording, scores
    observation, images = recording()
    mixture = scores(images, np.broadcast_to(observation[0], images.shape))
    log('stream mixture channel 0 SI-SDR per speaker '
        f"{[round(float(v), 2) for v in mixture['si_sdr']]} dB")
    launches = {beamformer or 'mask': stream_main(observation, images,
                                                  beamformer)
                for beamformer in (None, 'gev+ban')}
    stream_chunkings(observation)
    for beamformer in (None, 'gev+ban'):
        stream_card_against_cpu(observation, beamformer)
    stream_static_scene()
    return launches


def phase_streaming_checks():
    """phase_streaming and time_streaming, for ``--only streaming``."""
    return phase_streaming(), time_streaming()


def time_streaming():
    """Block timings of the stream on the card, per mode, on the first
    30 s: the real-time factor of a whole stream in chunks of 4,096
    (host clock, synchronized; after a first stream of the same audio);
    then a stream fed one block at a time with CUDA events and the host
    clock (after a synchronize) around each process() call, split into
    the warm-up burst, the realignment blocks and the steady blocks, and
    the profiler's device time and kernel count over the seven steady
    blocks after the warm-up (the idle share against the steady blocks'
    host clock without the profiler)."""
    import statistics
    import torch
    from pb_bss_tpu_torch.testing.streaming_quality import (
        recording, run_stream)
    observation, _ = recording(30 * 8000)
    seconds = observation.shape[-1] / 8000
    out = {}
    for beamformer in (None, 'gev+ban'):
        mode = beamformer or 'mask'
        rtf = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            run_stream(stream_separator(beamformer), observation)
            sync()
            rtf.append((time.perf_counter() - t0) / seconds)
        log(f'stream ({mode}) real-time factor of a 30 s stream: first '
            f'{rtf[0]:.4f}, again {rtf[1]:.4f} | {card_note()}')
        sep = stream_separator(beamformer)
        block = sep.block_frames * sep.shift
        kinds = {'burst': [], 'realign': [], 'steady': []}
        profiled = None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        i = 0
        while i + block <= observation.shape[-1]:
            warm = sep._em_state is None
            realign = (not warm and sep._blocks_since_align + 1
                       >= sep.realign_interval)
            chunk = observation[:, i:i + block]
            if (profiled is None and not warm and not realign
                    and sep._blocks_since_align == 0
                    and i + 8 * block <= observation.shape[-1]):
                profiled = profile_stream_blocks(sep, observation, i, 7)
                i += 7 * block
                continue
            sync()
            t0 = time.perf_counter()
            start.record()
            result = sep.process(chunk)
            end.record()
            sync()
            host = 1e3 * (time.perf_counter() - t0)
            device = start.elapsed_time(end)
            if warm and result.shape[-1]:
                kinds['burst'].append((device, host))
            elif not warm:
                kinds['realign' if realign else 'steady'].append(
                    (device, host))
            i += block
        row = {}
        for kind, times in kinds.items():
            if times:
                row[kind] = (statistics.median(t[0] for t in times),
                             statistics.median(t[1] for t in times),
                             len(times))
        steady_host = row['steady'][1]
        log(f'stream timing ({mode}), medians of CUDA events / host clock '
            f'per block: ' + '; '.join(
                f'{k} {v[0]:.3f} / {v[1]:.3f} ms (x{v[2]})'
                for k, v in row.items())
            + f'; a block is {1e3 * block / 8000:.0f} ms of audio: '
            f'steady real-time factor {steady_host / (1e3 * block / 8000):.4f}'
            f' | {card_note()}')
        device_ms, wall_ms, kernels = profiled
        log(f'stream profile ({mode}), per steady block: device '
            f'{device_ms:.3f} ms, {kernels:.1f} kernels ({wall_ms:.3f} ms '
            f'of wall under the profiler); idle share '
            f'{1 - device_ms / steady_host:.3f} of the {steady_host:.3f} ms '
            'steady block')
        out[mode] = dict(row, profile=profiled, rtf=rtf[1])
    return out


def profile_stream_blocks(sep, observation, start, count):
    """(device ms, wall ms, kernels) per block of ``count`` steady blocks
    fed one at a time under the profiler."""
    block = sep.block_frames * sep.shift

    def run():
        for j in range(count):
            sep.process(observation[:, start + j * block:
                                    start + (j + 1) * block])

    prof, wall = profile_device(run)
    device_us, kernels = device_times(prof, '')['all kernels']
    return device_us / 1e3 / count, 1e3 * wall / count, kernels / count


def phase_surface():
    """The rest of the model surface once each on the card against the
    same call on the CPU: GMM, BinaryGMM (k-means), VMFMM, the complex
    circular-symmetric Gaussian, the cACG trainer's fit (its eigh on K1
    at 257 bins), sample_cacgmm (by its moments: the card's generator
    draws other samples) and CACGMM.log_likelihood."""
    import itertools
    import numpy as np
    import torch
    from pb_bss_tpu_torch import models as M
    rng = np.random.default_rng(0)
    checks = {}

    def compare(name, card, cpu, atol):
        card = card.cpu() if isinstance(card, torch.Tensor) else card
        err = float((torch.as_tensor(card) - torch.as_tensor(cpu)).abs()
                    .max())
        finite = bool(torch.isfinite(torch.as_tensor(card).abs()).all())
        checks[name] = err
        log(f'surface {name}: card against CPU {err:.2e} (atol {atol})')
        if not finite or err > atol:
            fail(f'surface {name}: non-finite or card/CPU error {err}')

    def both(fn, *arrays):
        cpu = fn(*[torch.as_tensor(a) for a in arrays])
        card = fn(*[torch.as_tensor(a).cuda() for a in arrays])
        return card, cpu

    # float64 GMM / VMFMM EM from the same initialization
    x = np.concatenate([rng.standard_normal((400, 3)) + 4,
                        rng.standard_normal((400, 3)) - 4])
    init = rng.random((2, 800))
    init /= init.sum(0)
    card, cpu = both(lambda x, i: M.GMMTrainer().fit(
        x, initialization=i, iterations=10).gaussian.covariance, x, init)
    compare('GMM covariance (f64, 10 it)', card, cpu, 1e-9)
    card, cpu = both(lambda x, i: M.VMFMMTrainer().fit(
        x, initialization=i, iterations=10).vmf.mean, x, init)
    compare('VMFMM mean (f64, 10 it)', card, cpu, 1e-9)
    labels = []
    for device in ('cpu', 'cuda'):
        means = M.BinaryGMMTrainer().fit(
            torch.as_tensor(x, device=device), 2).means
        labels.append(M.BinaryGMM(means=means).predict(
            torch.as_tensor(x, device=device)).argmax(0).cpu().numpy())
    same = any(np.array_equal(np.asarray(p)[labels[0]], labels[1])
               for p in itertools.permutations(range(2)))
    log(f'surface BinaryGMM: card and CPU partitions agree {same}')
    if not same:
        fail('surface BinaryGMM: card and CPU partitions differ')

    y = (rng.standard_normal((257, 200, 6))
         + 1j * rng.standard_normal((257, 200, 6))).astype(np.complex64)
    y *= np.linspace(0.3, 2, 6).astype(np.float32)
    card, cpu = both(lambda y: M.ComplexCircularSymmetricGaussianTrainer()
                     .fit(y).log_pdf(y), y)
    compare('cCSG log_pdf (c64)', card, cpu, 1e-3)
    before = read_counters()['eigh.eigh_jacobi']
    card, cpu = both(lambda y: M.ComplexAngularCentralGaussianTrainer().fit(
        y, iterations=5).covariance, y)
    if read_counters()['eigh.eigh_jacobi'] - before != 5:
        fail('the cACG fit on 257 bins did not launch K1 once per '
             'iteration')
    compare('cACG fit covariance (c64, 5 it)', card, cpu, 1e-4)
    model = M.ComplexAngularCentralGaussianTrainer().fit(
        torch.as_tensor(y), iterations=2)
    mixture = M.CACGMM(weight=torch.full((257, 1, 1), 1.0), cacg=model)
    card = M.CACGMM(weight=mixture.weight.cuda(), cacg=type(model)(
        covariance_eigenvectors=model.covariance_eigenvectors.cuda(),
        covariance_eigenvalues=model.covariance_eigenvalues.cuda()))
    ll_card = float(card.log_likelihood(torch.as_tensor(y).cuda()))
    ll_cpu = float(mixture.log_likelihood(torch.as_tensor(y)))
    compare('CACGMM.log_likelihood (c64, 51,400 frames)',
            torch.tensor(ll_card / abs(ll_cpu)),
            torch.tensor(ll_cpu / abs(ll_cpu)), 1e-5)
    weight = np.array([0.2, 0.3, 0.5])
    covariance = np.stack([np.diag([1.0, 0.5, 0.1]).astype(np.complex64),
                           np.diag([0.1, 1.0, 0.5]).astype(np.complex64),
                           np.diag([0.5, 0.1, 1.0]).astype(np.complex64)])
    moments = []
    for device in ('cpu', 'cuda'):
        xs, lab = M.sample_cacgmm(40000, weight, torch.as_tensor(
            covariance, device=device), return_label=True)
        moments.append(np.stack([
            (xs[lab == k].T @ xs[lab == k].conj()).cpu().numpy()
            / int((lab == k).sum()) for k in range(3)]))
    compare('sample_cacgmm second moments (40,000 draws)',
            torch.as_tensor(moments[1]), torch.as_tensor(moments[0]), 0.02)
    return checks


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def mesh_gap(label, mesh_out, plain_out, rtol=1e-5):
    """Log how far a mesh call's output is from the meshless one's (0
    expected at world size 1) and fail above ``rtol`` of its largest
    magnitude."""
    import torch
    diff = float((mesh_out - plain_out).abs().max())
    scale = float(plain_out.abs().max())
    log(f'parallel {label}: mesh against meshless: bit for bit '
        f'{bool(torch.equal(mesh_out, plain_out))}, max |diff| {diff:.3e} '
        f'of max |out| {scale:.3e}')
    if not (math.isfinite(diff) and diff <= rtol * scale):
        fail(f'parallel {label}: the mesh call parts from the meshless '
             f'one by {diff} (> {rtol} of {scale})')


def model_leaves(model, prefix=''):
    """{path: tensor} of a model's tensors, its components' included."""
    import torch
    out = {}
    for key in model.__dataclass_fields__:
        value = getattr(model, key)
        if hasattr(value, '__dataclass_fields__'):
            out.update(model_leaves(value, f'{prefix}{key}.'))
        elif isinstance(value, torch.Tensor):
            out[prefix + key] = value
    return out


def same_model(label, got, want):
    """Fail unless every tensor of model ``got`` has the shape of
    ``want``'s and its bits."""
    import torch
    got, want = model_leaves(got), model_leaves(want)
    if got.keys() != want.keys():
        fail(f'{label}: fields {sorted(got)} against {sorted(want)}')
    parted = {k: float((got[k] - want[k]).abs().max())
              for k in want if got[k].shape != want[k].shape
              or not torch.equal(got[k], want[k])}
    shapes = {k: tuple(v.shape) for k, v in got.items()}
    log(f'{label}: global shapes {shapes}; bit for bit against the '
        f'meshless fit {not parted}')
    if parted:
        fail(f'{label}: parts from the meshless fit (max |diff| {parted})')


def mesh_cost(label, sharded, meshless, reps=3):
    """Log the device ms (profiler, all kernels) and host ms (3 runs
    each, in turns) of a sharded call against its meshless twin."""
    host = {'meshless': [], 'mesh': []}
    calls = (('meshless', meshless), ('mesh', sharded))
    for _ in range(reps):
        for name, call in calls:
            sync()
            t0 = time.perf_counter()
            call()
            sync()
            host[name].append(1e3 * (time.perf_counter() - t0))
    device = {}
    for name, call in calls:
        prof, _ = profile_device(call)
        device[name] = device_times(prof, '')['all kernels']
    card = getattr(phase_device, 'card', '')
    (plain_us, plain_n), (mesh_us, mesh_n) = device['meshless'], \
        device['mesh']
    log(f'timing {label} ({card}): device ms meshless '
        f'{plain_us / 1e3:.4f} in {plain_n} kernels, mesh '
        f'{mesh_us / 1e3:.4f} in {mesh_n} '
        f'(+{(mesh_us - plain_us) / 1e3:.4f}); '
        f'host ms meshless {[round(v, 2) for v in host["meshless"]]}, '
        f'mesh {[round(v, 2) for v in host["mesh"]]}')


def parallel_dtensor_fits(mesh, run, obs, obs3, emb):
    """The trainers' DTensor entry and K12 under an 'f' axis on a world
    of 1: ``fit_integration_sharded(use_fused_em='loop')`` at config 3
    (K12 once, K10 never) and ``CACGMMTrainer`` / ``CWMMTrainer`` /
    ``CBMMTrainer().fit`` of the slice cell's 8 utterances as a DTensor
    (F=257, T=304, D=6, K=3, 20 it: K2 / K6 / K9 once) and
    ``VMFCACGMMTrainer().fit`` of config 3 as DTensors ('auto': K10 19,
    K1 20), each from the trainers' own random draw, against the
    meshless fits bit for bit (the gathers of a world of 1 are copies),
    with the global shapes; the device and host ms of each pair."""
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.models import (
        CACGMMTrainer, CBMMTrainer, CWMMTrainer, VMFCACGMMTrainer)
    from pb_bss_tpu_torch.parallel import (
        fit_integration_sharded, shard_frequencies)
    loop = dict(num_classes=3, iterations=20, use_fused_em='loop')
    k12 = {'integration_em_loop.integration_em_full': 1,
           'integration_em.e_stats': 0}
    sharded = run("fit_integration_sharded(use_fused_em='loop') vMF F=513 "
                  'T=300 E=20, 20 it', lambda: fit_integration_sharded(
                      obs3, emb, mesh, **loop), k12, strict=False)
    meshless = run("VMFCACGMMTrainer.fit(use_fused_em='loop') (no mesh)",
                   lambda: VMFCACGMMTrainer().fit(obs3, emb, **loop), k12,
                   strict=False)
    same_model("fit_integration_sharded(use_fused_em='loop')", sharded,
               meshless)
    mesh_cost("fit_integration_sharded(use_fused_em='loop') config 3",
              lambda: fit_integration_sharded(obs3, emb, mesh, **loop),
              lambda: VMFCACGMMTrainer().fit(obs3, emb, **loop))

    Y = P.transform.stft(obs, 512, 128).permute(0, 3, 2, 1).contiguous()
    Yd = shard_frequencies(Y, mesh, frequency_axis=1)
    options = dict(num_classes=3, iterations=20)
    for Trainer, kernel in ((CACGMMTrainer, 'em_loop.cacgmm_em_full'),
                            (CWMMTrainer, 'cwmm_loop.cwmm_em_full'),
                            (CBMMTrainer, 'cbmm_loop.cbmm_em_full')):
        name = Trainer.__name__
        sharded = run(f'{name}().fit(DTensor) 8 x F=257 T=304, 20 it',
                      lambda: Trainer().fit(Yd, **options), {kernel: 1},
                      strict=False)
        meshless = run(f'{name}().fit (no mesh)',
                       lambda: Trainer().fit(Y, **options), {kernel: 1},
                       strict=False)
        same_model(f'{name}().fit(DTensor)', sharded, meshless)
        mesh_cost(f'{name}().fit(DTensor) 8 x 4.8 s',
                  lambda: Trainer().fit(Yd, **options),
                  lambda: Trainer().fit(Y, **options))

    obs3d = shard_frequencies(obs3, mesh)
    embd = shard_frequencies(emb, mesh)
    k10 = {'integration_em.e_stats': 19, 'eigh.eigh_jacobi': 20,
           'integration_em_loop.integration_em_full': 0}
    sharded = run('VMFCACGMMTrainer().fit(DTensor) F=513 T=300 E=20, 20 it',
                  lambda: VMFCACGMMTrainer().fit(obs3d, embd, **options),
                  k10, strict=False)
    meshless = run('VMFCACGMMTrainer().fit (no mesh)',
                   lambda: VMFCACGMMTrainer().fit(obs3, emb, **options),
                   k10, strict=False)
    same_model('VMFCACGMMTrainer().fit(DTensor)', sharded, meshless)
    mesh_cost('VMFCACGMMTrainer().fit(DTensor) config 3',
              lambda: VMFCACGMMTrainer().fit(obs3d, embd, **options),
              lambda: VMFCACGMMTrainer().fit(obs3, emb, **options))


def same_prediction(label, got, want, observation):
    """Fail unless ``got``, a model's prediction of the DTensor
    ``observation``, is a DTensor placed as it (mesh, placements, global
    shape) whose value is ``want``'s, the meshless prediction, bit for
    bit."""
    import torch
    from pb_bss_tpu_torch._shard import is_dtensor
    placed = (is_dtensor(got)
              and got.device_mesh == observation.device_mesh
              and tuple(got.placements) == tuple(observation.placements)
              and tuple(got.shape) == tuple(want.shape))
    same = placed and torch.equal(got.full_tensor(), want)
    log(f'{label}: a DTensor placed as its input {placed}; bit for bit '
        f'against the meshless predict {same}')
    if not same:
        fail(f'{label}: not the meshless prediction, placed as its input')


def parallel_batch_fits(mesh, run, obs):
    """The JAX package's multi-host layout on a world of 1: the slice
    cell's 8 utterances (F=257, T=304, D=6, K=3, 20 it) as a DTensor split
    over 'b' and 'f' of the (1, 1) mesh (``shard_batch_and_frequencies``)
    through ``CACGMMTrainer`` (K2 once), its frequency-constant fit (K5
    1 + 19), ``CWMMTrainer`` (K6 once) and ``CBMMTrainer`` (K9 once);
    config 3 at B=8 (F=513, T=300, E=20) through
    ``VMFCACGMMTrainer(use_fused_em='loop')`` (K12 once); the multi-host
    dry run's sequence (``shard_batch_from_process_local``, the
    frequency-constant fit with ``use_fused_em=False``: K1 in every
    M-step, then ``predict``). Each fit and each fitted model's
    ``predict`` of the DTensor (and ``CACGMM.log_likelihood``) against
    the meshless call bit for bit, with the device and host ms of each
    fit pair and of the cACGMM predict."""
    import torch
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.models import (
        CACGMMTrainer, CBMMTrainer, CWMMTrainer, VMFCACGMMTrainer)
    from pb_bss_tpu_torch.parallel import (
        shard_batch_and_frequencies, shard_batch_from_process_local)
    Y = P.transform.stft(obs, 512, 128).permute(0, 3, 2, 1).contiguous()
    Yb = shard_batch_and_frequencies(Y, mesh)
    fc = {'em_step.m_init': 1, 'em_step.em_step': 19,
          'em_loop.cacgmm_em_full': 0}
    for label, Trainer, extra, want in (
            ('CACGMMTrainer', CACGMMTrainer, {},
             {'em_loop.cacgmm_em_full': 1}),
            ('CACGMMTrainer fc', CACGMMTrainer,
             {'weight_constant_axis': (-3, -1)}, fc),
            ('CWMMTrainer', CWMMTrainer, {}, {'cwmm_loop.cwmm_em_full': 1}),
            ('CBMMTrainer', CBMMTrainer, {}, {'cbmm_loop.cbmm_em_full': 1})):
        options = dict(num_classes=3, iterations=20, **extra)
        sharded = run(f"{label}.fit(('b', 'f') DTensor) 8 x F=257 T=304, "
                      '20 it', lambda: Trainer().fit(Yb, **options), want,
                      strict=False)
        meshless = run(f'{label}.fit (no mesh)',
                       lambda: Trainer().fit(Y, **options), want,
                       strict=False)
        same_model(f"{label}.fit(('b', 'f') DTensor)", sharded, meshless)
        same_prediction(f"{label} predict(('b', 'f') DTensor)",
                        sharded.predict(Yb), meshless.predict(Y), Yb)
        mesh_cost(f"{label}.fit(('b', 'f') DTensor) 8 x 4.8 s",
                  lambda: Trainer().fit(Yb, **options),
                  lambda: Trainer().fit(Y, **options))
        if label == 'CACGMMTrainer':
            model = meshless
            mesh_cost("CACGMM.predict(('b', 'f') DTensor) 8 x 4.8 s",
                      lambda: model.predict(Yb), lambda: model.predict(Y))
            total, plain = model.log_likelihood(Yb), model.log_likelihood(Y)
            log(f'CACGMM.log_likelihood of the DTensor {float(total)!r}, '
                f'meshless {float(plain)!r}')
            if not torch.equal(total, plain):
                fail('CACGMM.log_likelihood of the DTensor parts from the '
                     'meshless call')

    y, _, _ = em_inputs(8, 513, 6, 3, 300, seed=152)
    obs3 = y.transpose(-1, -2).contiguous()
    g = torch.Generator('cuda').manual_seed(153)
    emb = torch.randn((8, 513, 300, 20), generator=g, device='cuda')
    emb = emb / emb.norm(dim=-1, keepdim=True)
    obs3d = shard_batch_and_frequencies(obs3, mesh)
    embd = shard_batch_and_frequencies(emb, mesh)
    loop = dict(num_classes=3, iterations=20, use_fused_em='loop')
    k12 = {'integration_em_loop.integration_em_full': 1,
           'integration_em.e_stats': 0}
    sharded = run("VMFCACGMMTrainer.fit(('b', 'f') DTensor, 'loop') B=8 "
                  'F=513 T=300 E=20, 20 it',
                  lambda: VMFCACGMMTrainer().fit(obs3d, embd, **loop), k12,
                  strict=False)
    meshless = run("VMFCACGMMTrainer.fit('loop') B=8 (no mesh)",
                   lambda: VMFCACGMMTrainer().fit(obs3, emb, **loop), k12,
                   strict=False)
    same_model("VMFCACGMMTrainer.fit(('b', 'f') DTensor, 'loop')", sharded,
               meshless)
    same_prediction("VMFCACGMM predict(('b', 'f') DTensor)",
                    sharded.predict(obs3d, embd),
                    meshless.predict(obs3, emb), obs3d)
    mesh_cost("VMFCACGMMTrainer.fit(('b', 'f') DTensor, 'loop') config 3 "
              'B=8', lambda: VMFCACGMMTrainer().fit(obs3d, embd, **loop),
              lambda: VMFCACGMMTrainer().fit(obs3, emb, **loop))

    # scripts/dcn_dryrun.py's sequence: each 'b' index passes its own
    # utterances (here the one rank all 8)
    local = shard_batch_from_process_local(Y, mesh)
    dcn = dict(num_classes=3, iterations=20, weight_constant_axis=(-3, -1),
               use_fused_em=False)
    scan = {'eigh.eigh_jacobi': 20, 'em_loop.cacgmm_em_full': 0,
            'em_step.m_init': 0, 'em_step.em_step': 0,
            'em_stream.e_stats': 0}
    sharded = run('dcn_dryrun sequence: shard_batch_from_process_local, '
                  'CACGMMTrainer.fit fc use_fused_em=False, 8 x F=257 '
                  'T=304, 20 it', lambda: CACGMMTrainer().fit(local, **dcn),
                  scan, strict=False)
    meshless = run('CACGMMTrainer.fit fc use_fused_em=False (no mesh)',
                   lambda: CACGMMTrainer().fit(Y, **dcn), scan, strict=False)
    same_model('dcn_dryrun sequence fit', sharded, meshless)
    if tuple(sharded.weight.shape) != (8, 1, 3, 1):
        fail(f'dcn_dryrun sequence weight {tuple(sharded.weight.shape)}')
    affiliation = sharded.predict(local)
    same_prediction('dcn_dryrun sequence predict', affiliation,
                    meshless.predict(Y), local)
    error = float((affiliation.full_tensor().sum(-2) - 1).abs().max())
    log(f'dcn_dryrun sequence: weight {tuple(sharded.weight.shape)}, '
        f'affiliations sum to 1 within {error:.2e}')
    if not error < 1e-3:
        fail(f'dcn_dryrun sequence affiliations sum to 1 within {error}')
    mesh_cost('dcn_dryrun sequence fit 8 x 4.8 s',
              lambda: CACGMMTrainer().fit(local, **dcn),
              lambda: CACGMMTrainer().fit(Y, **dcn))


def check_stft_methods(obs):
    """stft / istft with each ``method=`` the JAX package takes ('auto',
    'fft', 'matmul') on the card at the slice cell (8 x 6 channels of
    4.8 s): every value runs the one cuFFT path, so each equals the
    default call bit for bit."""
    import torch
    from pb_bss_tpu_torch.transform import istft, stft
    X = stft(obs, 512, 128)
    n = obs.shape[-1]
    x = istft(X, 512, 128, num_samples=n)
    for method in ('auto', 'fft', 'matmul'):
        same = (torch.equal(stft(obs, 512, 128, method=method), X)
                and torch.equal(istft(X, 512, 128, num_samples=n,
                                      method=method), x))
        log(f"stft / istft(method={method!r}) on the card: "
            f"{'bit for bit' if same else 'DIFFERS from'} the default call")
        if not same:
            fail(f'stft / istft(method={method!r}) parts from the default')


def run_examples(run):
    """The four examples of the port (examples/*_torch.py) through their
    ``main`` on the card at the JAX example tests' sizes (the mixture
    example at 3 iterations, the others at their defaults), each with
    the kernels its code launches: the mixture example K2 once and K3
    once a class (3); the integration example K10 39 and K1 40 a model
    (40 iterations, two models); the evaluation example's
    separate_batch K2 and K3 once; the streaming example K2 once (the
    warm-up) and K1 twice (inner iterations) a streamed block (10
    blocks of 4,096 samples, 8 of them the warm-up). Logs each
    example's printed lines and host seconds, and holds the integration
    accuracy above 0.8 and the streaming reconstruction below 1e-4."""
    import contextlib
    import importlib
    import io
    sys.path.insert(0, str(ROOT / 'examples'))
    try:
        modules = {name: importlib.import_module(f'{name}_example_torch')
                   for name in ('mixture_model', 'integration_model',
                                'evaluation', 'streaming')}
    finally:
        sys.path.remove(str(ROOT / 'examples'))
    cases = (
        ('mixture_model', dict(iterations=3),
         {'em_loop.cacgmm_em_full': 1, 'gev.gev': 3}),
        ('integration_model', {},
         {'integration_em.e_stats': 78, 'eigh.eigh_jacobi': 80}),
        ('evaluation', {}, {'em_loop.cacgmm_em_full': 1, 'gev.gev': 1}),
        ('streaming', {},
         {'em_loop.cacgmm_em_full': 1, 'eigh.eigh_jacobi': 4}))
    printed = {}
    card = getattr(phase_device, 'card', '')
    for name, kwargs, want in cases:
        out = io.StringIO()

        def call():
            with contextlib.redirect_stdout(out):
                modules[name].main(device='cuda', **kwargs)

        t0 = time.perf_counter()
        run(f'examples/{name}_example_torch.py main({kwargs})', call, want)
        seconds = time.perf_counter() - t0
        printed[name] = out.getvalue()
        log(f'example {name}_example_torch ({card}): {seconds:.2f} s of '
            'host; printed:')
        for line in printed[name].strip().splitlines():
            log(f'    {line}')
    for line in printed['integration_model'].strip().splitlines():
        if float(line.split('accuracy')[1].split('(')[0]) <= 0.8:
            fail(f'integration example below 0.8: {line}')
    error = float(printed['streaming'].split(
        'reconstruction error:')[1].split()[0])
    if not error < 1e-4:
        fail(f'streaming example reconstruction error {error}')
    for name, lines in (('mixture_model', ('mask-based extraction',
                                           'GEV+BAN beamforming')),
                        ('evaluation', ('SDR gain', 'STOI'))):
        for line in lines:
            if line not in printed[name]:
                fail(f'{name} example did not print {line!r}')


def phase_parallel_and_rest():
    """The last modules on the card. ``parallel`` on a world of size 1
    over NCCL (``initialize_distributed`` at a tcp address of this host,
    ``make_mesh((1, 1), ('b', 'f'))``): ``separate_batch(mesh=)`` on the
    slice cell (8 x 4.8 s, 20 iterations, 'gev+ban'; K2 once and K3 once,
    as the meshless call) against the meshless call, with the host and
    device ms of both; ``fit_cacgmm_sharded`` with frequency-constant
    weights at the bench shape (B=8, F=513, T=300: K5) and
    ``fit_integration_sharded`` at config 3 (F=513, T=300, E=20: K10)
    against the same fits without a mesh; the trainers' DTensor entry and
    K12 under the 'f' axis (:func:`parallel_dtensor_fits`). The
    collectives run at world size 1, where they are no-ops, so the mesh
    results equal the meshless ones. Then ``deflationSeed`` (K1 once a
    deflation step) and ``flag`` on the first utterance against the CPU,
    ``utils.profiling.trace`` around one ``separate``, the STFT's
    ``method=`` values (:func:`check_stft_methods`) and the four
    examples (:func:`run_examples`). Returns the launches of the kernels
    on these paths."""
    import tempfile
    import warnings
    import torch
    import torch.distributed as dist
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.initializer.deflation import deflationSeed
    from pb_bss_tpu_torch.initializer.deterministic import flag
    from pb_bss_tpu_torch.models import CACGMMTrainer, VMFCACGMMTrainer
    from pb_bss_tpu_torch.parallel import (
        fit_cacgmm_sharded, fit_integration_sharded, initialize_distributed,
        make_mesh)
    from pb_bss_tpu_torch.utils import profiling
    path = dict.fromkeys(('em_loop.cacgmm_em_full', 'gev.gev',
                          'em_step.m_init', 'em_step.em_step',
                          'integration_em.e_stats', 'eigh.eigh_jacobi',
                          'cwmm_loop.cwmm_em_full', 'cbmm_loop.cbmm_em_full',
                          'integration_em_loop.integration_em_full'), 0)
    idle = dict.fromkeys(counters(), 0)
    card = getattr(phase_device, 'card', '')

    def run(what, call, want, strict=True):
        """call() with the counters reset; fail unless the kernels in
        ``want`` (and, if ``strict``, no other) launched as given."""
        sync()
        reset_counters()
        out = call()
        sync()
        launches = read_counters()
        expect_launches(what, launches, {**idle, **want} if strict
                        else want)
        for k in path:
            path[k] += launches[k]
        return out

    initialize_distributed(f'127.0.0.1:{free_port()}', 1, 0)
    try:
        mesh = make_mesh((1, 1), ('b', 'f'))
        log(f'parallel: world {dist.get_world_size()} over '
            f'{dist.get_backend()}, mesh {tuple(mesh.shape)} '
            f'{mesh.mesh_dim_names} on {mesh.device_type}')

        obs, _ = load_utterances(range(8))
        obs = obs.cuda()
        options = dict(num_classes=3, iterations=20, beamformer='gev+ban')
        plain = P.separate_batch(obs, **options)
        slice_launches = {'em_loop.cacgmm_em_full': 1, 'gev.gev': 1}
        meshed = run("separate_batch(mesh=(1, 1) ('b', 'f')) 8 x 4.8 s, "
                     "'gev+ban', 20 it",
                     lambda: P.separate_batch(obs, mesh=mesh, **options),
                     slice_launches)
        if not bool(torch.isfinite(meshed).all()):
            fail('separate_batch(mesh=) output is not finite')
        mesh_gap('separate_batch', meshed, plain)
        host = {'meshless': [], 'mesh': []}
        for _ in range(3):
            for label, kwargs in (('meshless', {}), ('mesh', {'mesh': mesh})):
                sync()
                t0 = time.perf_counter()
                P.separate_batch(obs, **kwargs, **options)
                sync()
                host[label].append(1e3 * (time.perf_counter() - t0))
        device, names = {}, {}
        for label, kwargs in (('meshless', {}), ('mesh', {'mesh': mesh})):
            prof, _ = profile_device(
                lambda: P.separate_batch(obs, **kwargs, **options))
            device[label] = device_times(prof, '')['all kernels']
            names[label] = kernel_table(prof)
        extra = {k: v for k, v in names['mesh'].items()
                 if v[1] != names['meshless'].get(k, (0, 0))[1]}
        log('parallel separate_batch: kernels whose launches the mesh '
            'changed (device us, launches; meshless in brackets):')
        for key, (us, n) in sorted(extra.items(), key=lambda kv: -kv[1][0]):
            log(f'    {us:9.1f} x{n:<4d} ({names["meshless"].get(key)}) '
                f'{key[:80]}')
        for label in ('meshless', 'mesh'):
            log(f'timing parallel separate_batch {label} (8 x 4.8 s, '
                f"'gev+ban', 20 it; {card}): host ms "
                f'{[round(v, 2) for v in host[label]]}, device ms '
                f'{device[label][0] / 1e3:.4f} in {device[label][1]} '
                'kernels')

        y, aff, _ = em_inputs(8, 513, 6, 3, 300, seed=140)
        Y = y.transpose(-1, -2).contiguous()
        fc = dict(iterations=20, weight_constant_axis=(-3, -1))
        k5 = {'em_step.m_init': 1, 'em_step.em_step': 19,
              'em_loop.cacgmm_em_full': 0, 'em_stream.e_stats': 0}
        sharded = run('fit_cacgmm_sharded fc B=8 F=513 T=300, 20 it',
                      lambda: fit_cacgmm_sharded(
                          Y, mesh, initialization=aff, frequency_axis=1,
                          **fc), k5, strict=False)
        unsharded = run('CACGMMTrainer.fit fc (no mesh)',
                        lambda: CACGMMTrainer().fit(
                            Y, initialization=aff, **fc), k5, strict=False)
        mesh_gap('fit_cacgmm_sharded weight', sharded.weight,
                 unsharded.weight)
        mesh_gap('fit_cacgmm_sharded eigenvalues',
                 sharded.cacg.covariance_eigenvalues,
                 unsharded.cacg.covariance_eigenvalues)

        y, _, _ = em_inputs(1, 513, 6, 3, 300, seed=150)
        obs3 = y[0].transpose(-1, -2).contiguous()
        g = torch.Generator('cuda').manual_seed(151)
        emb = torch.randn((513, 300, 20), generator=g, device='cuda')
        emb = emb / emb.norm(dim=-1, keepdim=True)
        k10 = {'integration_em.e_stats': 19, 'eigh.eigh_jacobi': 20}
        sharded = run('fit_integration_sharded vMF F=513 T=300 E=20, 20 it',
                      lambda: fit_integration_sharded(
                          obs3, emb, mesh, num_classes=3, iterations=20),
                      k10)
        unsharded = run('VMFCACGMMTrainer.fit (no mesh)',
                        lambda: VMFCACGMMTrainer().fit(
                            obs3, emb, num_classes=3, iterations=20), k10)
        for leaf in ('mean', 'concentration'):
            mesh_gap(f'fit_integration_sharded vmf.{leaf}',
                     getattr(sharded.vmf, leaf),
                     getattr(unsharded.vmf, leaf))
        mesh_gap('fit_integration_sharded eigenvalues',
                 sharded.cacg.covariance_eigenvalues,
                 unsharded.cacg.covariance_eigenvalues)
        parallel_dtensor_fits(mesh, run, obs, obs3, emb)
        parallel_batch_fits(mesh, run, obs)
    finally:
        dist.destroy_process_group()

    check_stft_methods(obs)
    run_examples(run)

    Y = P.transform.stft(obs[0], 512, 128).permute(2, 1, 0).contiguous()
    seed = run('deflationSeed F=257 T=304 D=6, 3 sources',
               lambda: deflationSeed(Y, 3), {'eigh.eigh_jacobi': 2})
    cpu = deflationSeed(Y.cpu(), 3)
    err = float((seed.cpu() - cpu).abs().max())
    log(f'deflationSeed card against CPU: {err:.2e} (atol 1e-3)')
    if not (bool(torch.isfinite(seed).all()) and err <= 1e-3):
        fail(f'deflationSeed on the card parts from the CPU by {err}')
    for minimum in (0, 0.1):
        card_flag = flag(Y, 3, permutation_free=True, minimum=minimum)
        if card_flag.device.type != 'cuda' or not torch.equal(
                card_flag.cpu(), flag(Y.cpu(), 3, permutation_free=True,
                                      minimum=minimum)):
            fail(f'flag(minimum={minimum}) on the card differs from the CPU')
    log('flag: card equals CPU (minimum 0 and 0.1)')

    with tempfile.TemporaryDirectory() as log_dir:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always', RuntimeWarning)
            with profiling.trace(log_dir):
                P.separate(obs[0], iterations=20, beamformer='gev+ban')
                sync()
        [trace_file] = [f for f in os.listdir(log_dir)
                        if f.endswith('.pt.trace.json')]
        size = os.path.getsize(os.path.join(log_dir, trace_file))
        with open(os.path.join(log_dir, trace_file)) as f:
            kernels = sum(1 for e in json.load(f)['traceEvents']
                          if e.get('cat') == 'kernel')
        empty = [str(w.message) for w in caught
                 if 'no device event' in str(w.message)]
        log(f'profiling.trace around separate(): {size} bytes, {kernels} '
            f'kernel events, device events captured {not empty}'
            + (f' (warned: {empty[0]})' if empty else ''))
        if size == 0:
            fail('profiling.trace wrote an empty file')
    return path


def time_extraction():
    """separate_batch of 8 x 4.8 s per extraction route and with
    refine='fca': the host clock around synchronized calls (distinct
    utterances a repetition, after a warm-up) and one call's device time
    (the profiler) with the share of K1 and K3; get_bf_vector alone on
    the pipeline's PSDs per route (call, device, host); stable_solve at
    6,168 systems and the FCA fit alone on the folded 2,056 bins. Returns
    {case: ms}."""
    import statistics
    import torch
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.extraction import get_bf_vector
    from pb_bss_tpu_torch.models import FCATrainer
    from pb_bss_tpu_torch.ops.linalg import stable_solve
    from pb_bss_tpu_torch.transform import stft
    out = {}
    batches = [load_utterances(range(8 * r, 8 * r + 8))[0].cuda()
               for r in range(1, 5)]
    card = phase_device.card
    for route in ['gev+ban', *EXTRACTION_LAUNCHES, 'fca']:
        options = dict(refine='fca') if route == 'fca' \
            else dict(beamformer=route)
        P.separate_batch(batches[0], iterations=20, **options)
        sync()
        host = []
        for obs in batches[1:]:
            t0 = time.perf_counter()
            P.separate_batch(obs, iterations=20, **options)
            sync()
            host.append(1e3 * (time.perf_counter() - t0))
        prof, _ = profile_device(
            lambda: P.separate_batch(batches[1], iterations=20, **options))
        device = device_times(prof, '')['all kernels'][0] / 1e3
        k1 = sum(us for us, _ in device_times(prof, 'eigh').values()) / 1e3
        k3 = sum(us for us, _ in device_times(prof, 'gev').values()) / 1e3
        out[f'{route} host'] = statistics.median(host)
        out[f'{route} device'] = device
        log(f'timing separate_batch(8 x 4.8 s, {route!r}, 20 it): host '
            f'{[round(t, 3) for t in host]} ms a batch, device {device:.4f} '
            f'ms, K1 {k1:.4f} ({k1 / device:.3f}), K3 {k3:.4f} '
            f'({k3 / device:.3f}) [{card}]')
    target, noise = pipeline_psds(batches[0])
    for route in EXTRACTION_LAUNCHES:
        split_four(out, f'get_bf_vector {route} 6168',
                   lambda t, n, r=route: get_bf_vector(r, t, n),
                   [(target, noise)] + [pipeline_psds(b) for b in
                                        batches[1:3]], 'eigh')
    g = torch.Generator('cuda').manual_seed(79)
    ins = []
    for _ in range(6):
        a = torch.randn((6168, 6, 6), dtype=torch.complex64, device='cuda',
                        generator=g)
        ins.append((a @ a.conj().transpose(-1, -2),
                    torch.randn((6168, 6, 6), dtype=torch.complex64,
                                device='cuda', generator=g)))
    split_four(out, 'stable_solve 6168', stable_solve, ins, 'eigh')
    host = []
    for a, b in ins:
        sync()
        t0 = time.perf_counter()
        stable_solve(a, b)
        host.append(1e3 * (time.perf_counter() - t0))
    log(f'stable_solve 6168: host ms a call, synchronized before each: '
        f'{[round(t, 3) for t in host]}')
    top_kernels('stable_solve 6168', stable_solve, ins[1])
    top_kernels("get_bf_vector('mvdr_souden+ban') 6168",
                lambda t, n: get_bf_vector('mvdr_souden+ban', t, n),
                (target, noise))
    # the FCA fit alone on the folded bins of 8 x 4.8 s
    obs = batches[1]
    Y = stft(obs, 512, 128).permute(0, 3, 2, 1).reshape(
        8 * 257, -1, 6)
    fits = []
    for _ in range(3):
        masks = torch.rand((8 * 257, 3, Y.shape[1]), device='cuda',
                           generator=g)
        fits.append((Y, masks / masks.sum(-2, keepdim=True)))
    split_four(out, 'FCATrainer.fit 2056 bins 20 it',
               lambda y, m: FCATrainer().fit(y, initialization=m,
                                             iterations=20).power,
               fits, 'eigh')
    top_kernels('FCATrainer.fit 2056 bins 20 it',
                lambda y, m: FCATrainer().fit(y, initialization=m,
                                              iterations=20).power, fits[0])
    for key, ms in out.items():
        log(f'  {key}: {ms:.4f} ms')
    return out


def long_recordings(first_seed, count):
    """``count`` 60 s, 6-channel recordings (observation and the
    reference-channel speech images), each LONG_PIECES concatenated
    dummy scenarios cut to LONG_SAMPLES. The direct-path delays depend
    only on the speaker and channel index, so the two speakers stand
    still across the joins."""
    import numpy as np
    import torch
    from pb_bss_tpu_torch.testing import low_reverberation_data
    obs, images = [], []
    for r in range(count):
        data = [low_reverberation_data(seed=first_seed + LONG_PIECES * r + i)
                for i in range(LONG_PIECES)]
        obs.append(np.concatenate(
            [d['observation'] for d in data], -1)[:, :LONG_SAMPLES])
        images.append(np.concatenate(
            [d['speech_image'][:, 0] for d in data], -1)[:, :LONG_SAMPLES])
    return (torch.as_tensor(np.stack(obs), dtype=torch.float32),
            torch.as_tensor(np.stack(images)))


def counters():
    """{'<module>.<function>': wrapper} of every kernel's launch counter,
    as the wrappers register them (``ops._build.counted``) when the
    package imports their modules; ``mm_stream.mm_stats`` is K7's, the
    streamed pass of both the Watson and the Bingham fits."""
    import pb_bss_tpu_torch  # noqa: F401  (imports every wrapper)
    from pb_bss_tpu_torch.utils import profiling
    return {name.removeprefix('launches.'): fn
            for name, fn in profiling._launch_counters.items()}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in counters().items()}


def phase_long():
    """The long-recording path: 60 s recordings past the whole-fit
    kernel's gate run the streamed EM (K4) with the Jacobi kernel (K1)
    in its M-step finish."""
    import torch
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.evaluation import si_sdr
    from pb_bss_tpu_torch.evaluation import si_sdr_stft
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer

    obs, images = long_recordings(1000, 4)
    obs = obs.cuda()
    sync()
    reset_counters()
    out = P.separate_batch(obs, num_classes=3, iterations=20,
                           beamformer='gev+ban')
    sync()
    launches = read_counters()
    log(f'long path separate_batch(4 x {tuple(obs.shape[1:])}, '
        f"'gev+ban', 20 it) -> {tuple(out.shape)}; launches {launches}")
    if not (launches['em_loop.cacgmm_em_full'] == 0
            and launches['em_stream.e_stats'] >= 1
            and launches['eigh.eigh_jacobi'] >= 1
            and launches['gev.gev'] == 1):
        fail(f'long path launches {launches}, expected K2 = 0, K4 >= 1, '
             'K1 >= 1, K3 = 1')
    if not bool(torch.isfinite(out).all()):
        fail('long separate_batch output is not finite')
    scores = si_sdr_stft(images[:, :, None],
                         out.cpu().double()[:, None]).max(-1).values
    log('long path per-frequency SI-SDR (dB), best estimate per speaker:',
        [[round(v, 2) for v in row] for row in scores.tolist()])
    means = scores.mean(0)
    log('long path batch mean per speaker:',
        [round(v, 2) for v in means.tolist()])
    if not (bool((means >= LONG_MEAN_FLOOR_DB).all())
            and bool((scores >= LONG_SINGLE_FLOOR_DB).all())):
        fail(f'long-path separation quality below the floor '
             f'({LONG_MEAN_FLOOR_DB} dB mean, {LONG_SINGLE_FLOOR_DB} dB '
             'single)')

    reset_counters()
    single = P.separate(obs[0])
    sync()
    single_launches = read_counters()
    if single.shape != (3, obs.shape[-1]) or \
            not bool(torch.isfinite(single).all()):
        fail(f'separate() at its defaults on 60 s gave '
             f'{tuple(single.shape)} or non-finite output')
    mask_scores = si_sdr(images[0][:, None],
                         single.cpu().double()[None]).max(-1).values
    log('separate() defaults (mask, 80 it) on 60 s: SI-SDR per speaker',
        [round(v, 2) for v in mask_scores.tolist()], '| launches',
        single_launches)
    if single_launches['em_stream.e_stats'] < 1:
        fail(f'separate() on 60 s did not launch K4: {single_launches}')

    phase_cli(obs[0].cpu().numpy(), name='long_mixture')

    # the plain EM loop on the card: its M-step eigh launches K1
    y, aff, _ = em_inputs(1, 257, 6, 3, 304, seed=30)
    reset_counters()
    model = CACGMMTrainer().fit(y[0].transpose(-1, -2), iterations=5,
                                initialization=aff[0], use_fused_em=False)
    sync()
    scan_launches = read_counters()
    log(f'fit(use_fused_em=False) on CUDA (F=257, T=304): launches '
        f'{scan_launches}')
    if scan_launches['eigh.eigh_jacobi'] < 1 or \
            scan_launches['em_loop.cacgmm_em_full'] != 0:
        fail(f'the scan path on CUDA did not run through K1: '
             f'{scan_launches}')
    if not bool(torch.isfinite(model.cacg.covariance_eigenvalues).all()):
        fail('scan-path fit on CUDA is not finite')
    return launches


def expect_launches(what, got, want):
    """Fail unless the counters in ``want`` read exactly as given."""
    log(f'{what}: launches {got}')
    wrong = {k: got[k] for k, v in want.items() if got[k] != v}
    if wrong:
        fail(f'{what}: launches {wrong}, expected '
             f'{ {k: want[k] for k in wrong} }')


def phase_cwmm():
    """The complex Watson mixture on the card: separate_batch(model=
    'cwmm') of the 4.8 s utterances and of the 60 s recordings, both
    inside the whole-fit Watson kernel's gate (K6 once, K3 once);
    CWMMTrainer.fit at the long-T config (F=513, T=4000, 10 iterations:
    K7 1 from-init + 9 step passes, K1 in every M-step) and with
    frequency-constant weights at the bench shape (K7 1 + 19, K1 20).
    Returns the launches of the path's kernels."""
    import torch
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.evaluation import si_sdr_stft
    none = {'em_loop.cacgmm_em_full': 0, 'em_stream.e_stats': 0}

    obs, images = load_utterances(range(8))
    obs = obs.cuda()
    sync()
    reset_counters()
    out = P.separate_batch(obs, num_classes=3, iterations=20,
                           beamformer='gev+ban', model='cwmm')
    sync()
    launches = read_counters()
    expect_launches(f"separate_batch(8 x {tuple(obs.shape[1:])}, 'gev+ban', "
                    "20 it, model='cwmm')", launches,
                    {'cwmm_loop.cwmm_em_full': 1, 'mm_stream.mm_stats': 0,
                     'gev.gev': 1, **none})
    path = {'cwmm_loop.cwmm_em_full': launches['cwmm_loop.cwmm_em_full']}
    if not bool(torch.isfinite(out).all()):
        fail("separate_batch(model='cwmm') output is not finite")
    scores = si_sdr_stft(images[:, :, None],
                         out.cpu().double()[:, None]).max(-1).values
    log('cwmm per-frequency SI-SDR (dB), best estimate per speaker:',
        [[round(v, 2) for v in row] for row in scores.tolist()])
    means = scores.mean(0)
    log('cwmm batch mean per speaker:', [round(v, 2) for v in means.tolist()])
    if not (bool((means >= CWMM_MEAN_FLOOR_DB).all())
            and bool((scores >= CWMM_SINGLE_FLOOR_DB).all())):
        fail(f'cwmm separation quality below the floor ({CWMM_MEAN_FLOOR_DB}'
             f' dB mean, {CWMM_SINGLE_FLOOR_DB} dB single)')

    obs, images = long_recordings(1000, 4)
    obs = obs.cuda()
    sync()
    reset_counters()
    t0 = time.perf_counter()
    out = P.separate_batch(obs, num_classes=3, iterations=20,
                           beamformer='gev+ban', model='cwmm')
    sync()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    route = ('whole fit (K6)' if launches['cwmm_loop.cwmm_em_full']
             else 'streamed (K7)')
    log(f"cwmm long path separate_batch(4 x {tuple(obs.shape[1:])}, "
        f"'gev+ban', 20 it): route {route}; {1e3 * seconds:.1f} ms host "
        'clock (the first call of this shape)')
    expect_launches('cwmm long path', launches,
                    {'cwmm_loop.cwmm_em_full': 1, 'mm_stream.mm_stats': 0,
                     'gev.gev': 1, **none})
    if not bool(torch.isfinite(out).all()):
        fail("separate_batch(model='cwmm') on 60 s is not finite")
    scores = si_sdr_stft(images[:, :, None],
                         out.cpu().double()[:, None]).max(-1).values
    log('cwmm long path batch mean per speaker:',
        [round(v, 2) for v in scores.mean(0).tolist()])

    from pb_bss_tpu_torch.models.cwmm import CWMMTrainer
    for label, (B, F, T), iterations, kwargs in (
            ('T=4000 (long-T config)', (1, 513, 4000), 10, {}),
            ('fc B=8 F=513 T=300', (8, 513, 300), 20,
             dict(weight_constant_axis=(-3, -1)))):
        y, aff, _ = em_inputs(B, F, 6, 3, T, seed=60)
        Y = y.transpose(-1, -2).contiguous()
        if B == 1:
            Y, aff = Y[0], aff[0]
        sync()
        reset_counters()
        model = CWMMTrainer().fit(Y, initialization=aff,
                                  iterations=iterations, **kwargs)
        sync()
        launches = read_counters()
        expect_launches(f'CWMMTrainer.fit {label}, {iterations} it',
                        launches, {'mm_stream.mm_stats': iterations,
                                   'eigh.eigh_jacobi': iterations,
                                   'cwmm_loop.cwmm_em_full': 0, **none})
        path['cwmm_em_long'] = path.get('cwmm_em_long', 0) \
            + launches['mm_stream.mm_stats']
        wsum = (model.weight.sum(-2) - 1).abs().max().item()
        finite = bool(torch.isfinite(model.complex_watson.concentration)
                      .all() and torch.isfinite(model.weight).all())
        log(f'  weight {tuple(model.weight.shape)}, |sum w - 1| {wsum:.2e}, '
            f'finite {finite}, kappa range '
            f'[{model.complex_watson.concentration.min().item():.3g}, '
            f'{model.complex_watson.concentration.max().item():.3g}]')
        if not (finite and wsum < 1e-4):
            fail(f'CWMMTrainer.fit {label} is not finite or not normalized')
    return path


def phase_cbmm():
    """The complex Bingham mixture on the card: separate_batch(model=
    'cbmm') of the 4.8 s utterances (K9 once, K3 once, no K7 or K8);
    CBMMTrainer.fit at the long-T config (F=513, T=4000, 5 iterations: K7
    5 passes, K1 in every M-step, K8 three launches for the cold first
    solve and one per warm solve) and with frequency-constant weights at
    the bench shape (20 iterations); the scan path (frequency-constant
    weights with the inline DHTV aligner, which the kernels do not take:
    K8 and K1 in every M-step); and the warm-start recipe's quality
    against its control. Returns the launches of the path's kernels."""
    import torch
    import pb_bss_tpu_torch as P
    from pb_bss_tpu_torch.evaluation import si_sdr_stft
    from pb_bss_tpu_torch.models.cbmm import CBMMTrainer
    from pb_bss_tpu_torch.permutation_alignment import (
        DHTVPermutationAlignment)
    # the CBMM quality floors and the CPU numbers behind them live beside
    # the recipes, where the slow CPU test reads them too
    from pb_bss_tpu_torch.testing.cbmm_quality import (
        MEAN_FLOOR_DB as CBMM_MEAN_FLOOR_DB,
        SINGLE_FLOOR_DB as CBMM_SINGLE_FLOOR_DB,
        WARM_MEAN_FLOOR_DB as CBMM_WARM_MEAN_FLOOR_DB,
        WARM_SINGLE_FLOOR_DB as CBMM_WARM_SINGLE_FLOOR_DB, cbmm_quality)
    none = {'em_loop.cacgmm_em_full': 0, 'em_stream.e_stats': 0,
            'cwmm_loop.cwmm_em_full': 0}
    path = dict.fromkeys(('cbmm_loop.cbmm_em_full', 'cbmm_em_long',
                          'bingham.bingham_chord_solve'), 0)

    def add(launches):
        for k in path:
            path[k] += launches['mm_stream.mm_stats' if k == 'cbmm_em_long'
                                else k]

    obs, images = load_utterances(range(8))
    obs = obs.cuda()
    sync()
    reset_counters()
    out = P.separate_batch(obs, num_classes=3, iterations=20,
                           beamformer='gev+ban', model='cbmm')
    sync()
    launches = read_counters()
    add(launches)
    expect_launches(f"separate_batch(8 x {tuple(obs.shape[1:])}, 'gev+ban', "
                    "20 it, model='cbmm')", launches,
                    {'cbmm_loop.cbmm_em_full': 1, 'mm_stream.mm_stats': 0,
                     'bingham.bingham_chord_solve': 0, 'gev.gev': 1, **none})
    # a bin where one class takes every frame leaves the other classes'
    # noise PSD exactly 0, and the GEV beamformer of such a bin is
    # non-finite in both packages (ROADMAP queue 3): the random start
    # reaches that in some utterances (JAX's separate: 5 of these 8 on the
    # CPU, the port's separate_batch 1)
    finite = torch.isfinite(out).flatten(1).all(-1).cpu()
    log(f"cbmm separate_batch: finite utterances {int(finite.sum())} of "
        f'{len(finite)}')
    if int(finite.sum()) < 5:
        fail("separate_batch(model='cbmm') output is not finite in more "
             'than 3 of 8 utterances')
    scores = si_sdr_stft(images[finite][:, :, None],
                         out.cpu().double()[finite][:, None]).max(-1).values
    log('cbmm per-frequency SI-SDR (dB), best estimate per speaker, finite '
        'utterances:', [[round(v, 2) for v in row] for row in scores.tolist()])
    means = scores.mean(0)
    log('cbmm batch mean per speaker:', [round(v, 2) for v in means.tolist()])
    if not (bool((means >= CBMM_MEAN_FLOOR_DB).all())
            and bool((scores >= CBMM_SINGLE_FLOOR_DB).all())):
        fail(f'cbmm separation quality below the floor ({CBMM_MEAN_FLOOR_DB}'
             f' dB mean, {CBMM_SINGLE_FLOOR_DB} dB single)')

    for recipe, want in (('warm', {'em_loop.cacgmm_em_full': 1}),
                         ('random', {'em_loop.cacgmm_em_full': 0})):
        sync()
        reset_counters()
        scores = cbmm_quality(obs, images, recipe)
        sync()
        launches = read_counters()
        add(launches)
        expect_launches(f'cbmm {recipe} recipe, 8 x 4.8 s, 20 it', launches,
                        {'cbmm_loop.cbmm_em_full': 1, 'gev.gev': 1, **want})
        means = scores.mean(0)
        log(f'  cbmm {recipe} recipe SI-SDR per speaker (dB): '
            f'{[[round(v, 2) for v in row] for row in scores.tolist()]}; '
            f'batch means {[round(v, 2) for v in means.tolist()]}')
        passed = (bool((means >= CBMM_WARM_MEAN_FLOOR_DB).all())
                  and bool((scores >= CBMM_WARM_SINGLE_FLOOR_DB).all()))
        if recipe == 'warm' and not bool(torch.isfinite(scores).all()):
            fail('cbmm warm recipe: non-finite estimates')
        if recipe == 'warm' and not passed:
            fail(f'cbmm warm recipe below the floor ({CBMM_WARM_MEAN_FLOOR_DB}'
                 f' dB mean, {CBMM_WARM_SINGLE_FLOOR_DB} dB single)')
        if recipe == 'random' and passed:
            fail('the cbmm control (random start) meets the warm-recipe '
                 'floors: they would not catch a warm start not applied')

    fc = dict(weight_constant_axis=(-3, -1))
    for label, (B, F, T), iterations, kwargs in (
            ('T=4000 (config 3e)', (1, 513, 4000), 5, {}),
            ('fc B=8 F=513 T=300', (8, 513, 300), 20, fc)):
        y, aff, _ = em_inputs(B, F, 6, 3, T, seed=84)
        Y = y.transpose(-1, -2).contiguous()
        if B == 1:
            Y, aff = Y[0], aff[0]
        sync()
        reset_counters()
        model = CBMMTrainer().fit(Y, initialization=aff,
                                  iterations=iterations, **kwargs)
        sync()
        launches = read_counters()
        add(launches)
        expect_launches(f'CBMMTrainer.fit {label}, {iterations} it',
                        launches, {'mm_stream.mm_stats': iterations,
                                   'eigh.eigh_jacobi': iterations,
                                   'bingham.bingham_chord_solve':
                                       3 + iterations - 1,
                                   'cbmm_loop.cbmm_em_full': 0, **none})
        ev = model.complex_bingham.covariance_eigenvalues
        wsum = (model.weight.sum(-2) - 1).abs().max().item()
        finite = bool(torch.isfinite(ev).all()
                      and torch.isfinite(model.weight).all())
        log(f'  weight {tuple(model.weight.shape)}, |sum w - 1| {wsum:.2e}, '
            f'finite {finite}, eigenvalue range [{ev.min().item():.4g}, '
            f'{ev.max().item():.4g}]')
        if not (finite and wsum < 1e-4):
            fail(f'CBMMTrainer.fit {label} is not finite or not normalized')

    # the scan path on the card: its M-step eigh and moment inversion
    # launch K1 and K8
    y, aff, _ = em_inputs(1, 257, 6, 3, 304, seed=85)
    sync()
    reset_counters()
    model, posterior = CBMMTrainer().fit(
        y[0].transpose(-1, -2), initialization=aff[0], iterations=5,
        inline_permutation_aligner=DHTVPermutationAlignment.from_stft_size(
            512), _return_affiliation=True, **fc)
    sync()
    launches = read_counters()
    add(launches)
    expect_launches('CBMMTrainer.fit fc + inline DHTV (scan path), F=257 '
                    'T=304, 5 it', launches,
                    {'bingham.bingham_chord_solve': 3 + 4,
                     'eigh.eigh_jacobi': 5, 'cbmm_loop.cbmm_em_full': 0,
                     'mm_stream.mm_stats': 0, **none})
    if not (bool(torch.isfinite(posterior).all()) and bool(torch.isfinite(
            model.complex_bingham.covariance_eigenvalues).all())):
        fail('the CBMM scan path on the card is not finite')
    return path


def phase_integration():
    """The integration models on the card at the JAX package's bench
    config 3 (F=513, T=300, D=6, K=3, E=20, random unit embeddings, 20
    iterations): VMFCACGMMTrainer().fit unbatched and at B=8 and
    GCACGMMTrainer().fit (spherical), each through 'auto' (K10 once per
    iteration after the first, K1 in all 20 M-steps) and
    use_fused_em='loop' (K12 once, K1 in the first M-step); then
    VMFCACGMMTrainer().fit_predict on the eight 4.8 s utterances with
    oracle embeddings against the floors of
    ``testing/integration_quality.py``, and its control with random
    embeddings, which must fail them. Returns the launches of the path's
    kernels."""
    import torch
    from pb_bss_tpu_torch.models import GCACGMMTrainer, VMFCACGMMTrainer
    from pb_bss_tpu_torch.testing import integration_quality as iq
    path = dict.fromkeys(('integration_em.e_stats',
                          'integration_em_loop.integration_em_full',
                          'eigh.eigh_jacobi'), 0)
    idle = dict.fromkeys(counters(), 0)
    step = {'integration_em.e_stats': 19, 'eigh.eigh_jacobi': 20}

    def add(launches):
        for k in path:
            path[k] += launches[k]

    E = 20
    for label, B, trainer, kwargs in (
            ('VMFCACGMMTrainer', 1, VMFCACGMMTrainer, {}),
            ('VMFCACGMMTrainer', 8, VMFCACGMMTrainer, {}),
            ("GCACGMMTrainer('spherical')", 1, GCACGMMTrainer,
             dict(covariance_type='spherical'))):
        y, _, _ = em_inputs(B, 513, 6, 3, 300, seed=110 + B)
        obs = y.transpose(-1, -2)
        g = torch.Generator('cuda').manual_seed(120 + B)
        emb = torch.randn((B, 513, 300, E), generator=g, device='cuda')
        emb = emb / emb.norm(dim=-1, keepdim=True)
        if B == 1:
            obs, emb = obs[0], emb[0]
        for route, want in (('auto', step),
                            ('loop',
                             {'integration_em_loop.integration_em_full': 1,
                              'eigh.eigh_jacobi': 1})):
            sync()
            reset_counters()
            model = trainer().fit(obs, emb, num_classes=3, iterations=20,
                                  use_fused_em=route, **kwargs)
            sync()
            launches = read_counters()
            add(launches)
            expect_launches(
                f'{label}.fit B={B} F=513 T=300 D=6 K=3 E={E}, 20 it, '
                f'use_fused_em={route!r}', launches, {**idle, **want})
            aff = model.predict(obs, emb)
            finite = bool(torch.isfinite(aff).all()) and bool(
                torch.isfinite(model.cacg.covariance_eigenvalues).all())
            asum = (aff.sum(-2) - 1).abs().max().item()
            weight = model.weight.reshape(-1, 3).mean(0).tolist()
            log(f'  finite {finite}, |sum_k posterior - 1| {asum:.1e}, '
                f'mean weight per class {[round(v, 4) for v in weight]}')
            if not (finite and asum < 1e-4):
                fail(f'{label}.fit B={B} use_fused_em={route!r} is not '
                     'finite or its posterior is not normalized')

    observations, images, noise = iq.utterances()
    observations = observations.cuda()
    for kind in iq.EMBEDDINGS:
        sync()
        reset_counters()
        scores, accuracy = iq.integration_quality(
            observations, images, noise, iq.embeddings(images, noise, kind))
        sync()
        launches = read_counters()
        add(launches)
        expect_launches(f'integration quality ({kind} embeddings), '
                        'VMFCACGMMTrainer.fit_predict 8 x 4.8 s, 20 it',
                        launches, {**idle, **step})
        passed = iq.passes(scores, accuracy)
        log(f'  {kind}: decision accuracy '
            f'{[round(a, 3) for a in accuracy.tolist()]}; SI-SDR per speaker '
            f'{[[round(v, 2) for v in row] for row in scores.tolist()]}; batch'
            f' means {[round(v, 2) for v in scores.mean(0).tolist()]}; '
            f'passes the floors {passed}')
        if kind == 'oracle' and not passed:
            fail(f'integration quality below the floors (accuracy '
                 f'{iq.ACCURACY_FLOOR}, {iq.MEAN_FLOOR_DB} dB mean, '
                 f'{iq.SINGLE_FLOOR_DB} dB single)')
        if kind == 'random' and passed:
            fail('the integration control (random embeddings) meets the '
                 'floors: they would not catch a spectral model that does '
                 'not act')
    return path


def phase_fc_path():
    """The rest of the cACGMM trainer on the card: frequency-constant
    weights through K5 (batched, resumed, and with the inline aligners),
    use_pallas_em through K11's scatter with K1 in the M-step, and the
    public E-step kernel. Returns the launches of the path's kernels."""
    import torch
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer
    from pb_bss_tpu_torch.ops.em_estep import cacgmm_e_step
    from pb_bss_tpu_torch.testing.inline_quality import (
        ALIGNERS, CONTROL, inline_aligner_quality, utterance)
    fc = dict(weight_constant_axis=(-3, -1))
    none = {'em_loop.cacgmm_em_full': 0, 'em_stream.e_stats': 0}
    path = dict.fromkeys(('em_step.m_init', 'em_step.em_step',
                          'em_estep.cacgmm_em_scatter',
                          'em_estep.cacgmm_e_step', 'eigh.eigh_jacobi'), 0)

    def add(launches):
        for k in path:
            path[k] += launches[k]

    # the JAX package's frequency-constant benchmark configuration
    y, aff, _ = em_inputs(8, 513, 6, 3, 300, seed=40)
    Y = y.transpose(-1, -2).contiguous()
    sync()
    reset_counters()
    model = CACGMMTrainer().fit(Y, initialization=aff, iterations=20, **fc)
    sync()
    launches = read_counters()
    add(launches)
    expect_launches('fc fit B=8 F=513 T=300, 20 it', launches, {
        'em_step.m_init': 1, 'em_step.em_step': 19, **none})
    finite = bool(torch.isfinite(model.cacg.covariance_eigenvalues).all())
    wsum = (model.weight.sum(-2) - 1).abs().max().item()
    log(f'  weight {tuple(model.weight.shape)}, |sum w - 1| {wsum:.2e}, '
        f'finite {finite}')
    if not (finite and model.weight.shape == (8, 1, 3, 1) and wsum < 1e-4):
        fail('fc fit at the bench shape is not finite or misshaped')

    reset_counters()
    resumed = CACGMMTrainer().fit(Y, initialization=model, iterations=5,
                                  **fc)
    sync()
    launches = read_counters()
    add(launches)
    expect_launches('fc fit resumed from its model, 5 it', launches, {
        'em_step.m_init': 0, 'em_step.em_step': 5, **none})
    if not bool(torch.isfinite(resumed.cacg.covariance_eigenvalues).all()):
        fail('resumed fc fit is not finite')

    observation, images = utterance()
    for name in ALIGNERS + (CONTROL,):
        sync()
        reset_counters()
        scores, affiliation = inline_aligner_quality(
            observation.cuda(), images, name)
        sync()
        launches = read_counters()
        add(launches)
        expect_launches(f'fit_predict fc + inline {name}, 4.8 s, 20 it',
                        launches, {'em_step.m_init': 1,
                                   'em_step.em_step': 19, **none})
        scores = [round(float(v), 2) for v in scores]
        log(f'  SI-SDR per speaker (dB), masks at the reference channel, '
            f'no alignment afterwards: {scores}')
        passed = (sum(scores) / len(scores) >= INLINE_MEAN_FLOOR_DB
                  and min(scores) >= INLINE_SINGLE_FLOOR_DB)
        if not bool(torch.isfinite(affiliation).all()):
            fail(f'fc + inline {name}: non-finite masks')
        if name == CONTROL and passed:
            fail('the fc fit without an aligner meets the inline-aligner '
                 'floors: they would not catch an alignment not applied')
        if name != CONTROL and not passed:
            fail(f'fc + inline {name}: quality below the floor '
                 f'({INLINE_MEAN_FLOOR_DB} dB mean, '
                 f'{INLINE_SINGLE_FLOOR_DB} dB single)')

    for F, T, seed in ((257, 304, 41), (513, 300, 42)):
        y, aff, _ = em_inputs(1, F, 6, 3, T, seed)
        Y = y[0].transpose(-1, -2).contiguous()
        sync()
        reset_counters()
        model = CACGMMTrainer().fit(Y, initialization=aff[0], iterations=20,
                                    use_pallas_em=True)
        # the posterior through the public E-step kernel
        vec = model.cacg.covariance_eigenvectors
        posterior, _ = cacgmm_e_step(
            y[0].real.contiguous(), y[0].imag.contiguous(),
            vec.real.contiguous(), vec.imag.contiguous(),
            1. / model.cacg.covariance_eigenvalues,
            model.cacg.log_determinant, model.weight[..., 0])
        sync()
        launches = read_counters()
        add(launches)
        expect_launches(f'fit(use_pallas_em=True) F={F} T={T}, 20 it, then '
                        'cacgmm_e_step', launches, {
                            'em_estep.cacgmm_em_scatter': 19,
                            'eigh.eigh_jacobi': 20,
                            'em_estep.cacgmm_e_step': 1, 'em_step.em_step': 0,
                            **none})
        agree = (posterior.argmax(-2)
                 == model.predict(Y).argmax(-2)).float().mean().item()
        log(f'  finite {bool(torch.isfinite(posterior).all())}, argmax '
            f'agreement of cacgmm_e_step with predict {agree:.4f}')
        if not (bool(torch.isfinite(model.cacg.covariance_eigenvalues).all())
                and agree > 0.99):
            fail(f'use_pallas_em fit at F={F} is not finite, or the '
                 'E-step kernel disagrees with predict')
    return path


# float32 operations beside sepbench.harness.counts' em_flops and
# jacobi_flops (whose form='assembled' is the Bingham kernels' quadratic
# form through the assembled V diag(lambda) V^H, 4 per upper-triangle
# entry on the shared products): the warm rotation V^H A V is 16 D^3 per
# class, the scaled eigenbasis V diag(lambda^-1/2) 2 D^2 and an assembled
# form V diag(lambda) V^H 8 D^3.


# float32 operations of the Watson EM pieces, counted as em_flops counts:
# the products y_d conj(y_e) once per frame, shared by the classes and the
# scatter; per (frame, class) the rank-1 form <y, m> (8 per channel), its
# squared magnitude and kappa q - log Z (~5), the softmax (~10), and 4 per
# upper-triangle entry for the scatter.
def cwmm_flops(frames, K, D, e_step=True, scatter=True):
    P = D * (D + 1) // 2
    per_class = (8 * D + 15 if e_step else 0) + (4 * P if scatter else 0)
    return frames * ((3 * D + 6 * (P - D) if scatter else 0) + K * per_class)


# float32 operations of the Bingham EM pieces: the cascades of the moment
# inversion (bingham.cascade_flops each; per (bin, class) the cold first
# solve runs cold_rounds x (1 + (D - 1) + cold_steps) of them and each warm
# solve 1 + (D - 1) + warm_steps, plus one for log c per iteration), the
# full-form E-step and the scatter counted as em_flops counts the cACGMM's
# (the same quadratic form over the upper triangle), the forms
# V diag(lambda) V^H (8 D^3 per class), and the Jacobi.
def bingham_flops(N, K, D, T, iterations, cold_rounds=3, cold_steps=10,
                  warm_steps=16, sweeps=6, warm_sweeps=2):
    from pb_bss_tpu_torch.ops.bingham import cascade_flops, solve_cascades
    cascades = (solve_cascades(D, cold_rounds, cold_steps)
                + (iterations - 1) * solve_cascades(D, 1, warm_steps)
                + iterations)
    return (N * K * cascades * cascade_flops(D)
            + iterations * (em_flops(N * T, K, D, form='assembled')
                            + N * K * 8 * D ** 3)
            + jacobi_flops(N * K, D, sweeps) + (iterations - 1) * (
                jacobi_flops(N * K, D, warm_sweeps) + N * K * 16 * D ** 3))


# float32 operations of one integration-model E-step and its sums, counted
# as em_flops counts: per frame the products y_d conj(y_e) of the scatter
# once, shared by the classes, and the embedding's norm (vMF) or squares
# (Gaussian); per (frame, class) the quadratic form as the projection on
# the eigenvectors (8 per complex multiply-add, D^2 of them, and 3 per
# eigenvalue), the spectral dot (2 per dimension; the Gaussian's two dots
# 4), ~10 for the logs and the softmax, the scatter (4 per upper-triangle
# entry), the resultants (2 per dimension) and the Gaussian's second
# moments (2).
def integration_flops(frames, K, D, E, mode):
    P = D * (D + 1) // 2
    gaussian = mode == 'gaussian'
    per_frame = 3 * D + 6 * (P - D) + (E if gaussian else 2 * E)
    per_class = 8 * D * D + 3 * D + 4 * P + 10 \
        + (8 * E if gaussian else 4 * E)
    return frames * (per_frame + K * per_class)


def phase_timing(errors, launches, long_launches, fc_launches,
                 cwmm_launches, cbmm_launches, integration_launches,
                 stream_launches_, parallel_launches):
    import torch
    from pb_bss_tpu_torch.ops.eigh import eigh_jacobi, eigh_jacobi_reference
    from pb_bss_tpu_torch.ops.em_loop import (
        cacgmm_em_full, cacgmm_em_full_reference)
    from pb_bss_tpu_torch.ops.em_stream import (
        cacgmm_em_long, cacgmm_em_long_reference, e_stats,
        e_stats_reference)
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

    # K1 at the long path's M-step shape (4 x 257 bins x 3 classes)
    inputs = [(hermitian_batch(4 * 257 * 3, 6, 500 + i),) for i in range(6)]
    eigh_ms = cuda_time(eigh_jacobi, inputs)
    eigh_plain = cuda_time(eigh_jacobi_reference, inputs[:3])
    # the library call that computes the same function (timed here,
    # never called by the port)
    eigh_library = cuda_time(torch.linalg.eigh, inputs)
    log(f'timing K1 3084 matrices 6x6 c64: kernel {eigh_ms:.4f} ms, plain '
        f'{eigh_plain:.4f} ms, torch.linalg.eigh {eigh_library:.4f} ms')

    # K4 at four 60 s recordings: one statistics pass in model mode, and
    # the whole streamed EM (20 iterations) against its plain twin
    B, F, T = 4, 257, 3753
    N = B * F
    em_in = [em_inputs(B, F, 6, 3, T, 600 + i) for i in range(4)]
    weight, ev, vec = cacgmm_em_long_reference(*em_in[0], iterations=1)
    model = dict(eigenvalues=ev.reshape(N, 3, 6),
                 eigenvectors=vec.reshape(N, 3, 6, 6),
                 weight=weight.reshape(N, 3), affiliation_eps=1e-10)
    stats_in = [(y.reshape(N, 6, T),) for y, _, _ in em_in]
    stats_ms = cuda_time(lambda y: e_stats(y, **model), stats_in)
    stats_plain = cuda_time(lambda y: e_stats_reference(y, **model),
                            stats_in[:3])
    log(f'timing K4 statistics pass B=4 F=257 D=6 K=3 T=3753 (model '
        f'mode): kernel {stats_ms:.4f} ms, plain {stats_plain:.4f} ms')
    long_ms = cuda_time(lambda y, a, q: cacgmm_em_long(
        y, a, q, iterations=20), em_in[1:])
    long_plain = cuda_time(lambda y, a, q: cacgmm_em_long_reference(
        y, a, q, iterations=20), em_in[1:3])
    log(f'timing cacgmm_em_long B=4 F=257 T=3753, 20 it: kernels '
        f'{long_ms:.3f} ms, plain {long_plain:.3f} ms')
    time_em_splits()

    fc_times = time_fc()
    estep_times = time_estep()
    cwmm_times = time_cwmm()
    cbmm_times = time_cbmm()
    integration_times = time_integration()

    short = time_e2e()
    e2e(short, 8, 'utterance (4.8 s)', model='cwmm')
    e2e(short, 8, 'utterance (4.8 s)', model='cbmm')
    profile_separate('cwmm', (('8 x 4.8 s', short[1]), (
        '4 x 60 s', long_recordings(2000, 4)[0].cuda())))
    profile_separate('cbmm', (('8 x 4.8 s', short[1]),))

    # the least time of each timed call, from the shapes of its inputs
    D, K = 6, 3
    N2, T2 = 8 * 257, 304
    # y, the initial affiliations and quadratic forms in; weight,
    # eigenvalues, eigenvectors and affiliations out
    k2_bytes = N2 * D * T2 * 8 + 2 * N2 * K * T2 * 4 \
        + N2 * K * (4 + 4 * D + 8 * D * D + 4 * T2)
    k2_flops = 20 * (em_flops(N2 * T2, K, D) + N2 * K * 2 * D ** 2) \
        + jacobi_flops(N2 * K, D, 6) + 19 * (
            jacobi_flops(N2 * K, D, 2) + N2 * K * 16 * D ** 3)
    n3 = 8 * 257 * 3
    # Cholesky, two triangular solves, the Jacobi, the back-substitution
    k3_flops = n3 * 8 * (D ** 3 // 3 + D ** 3 + D * D // 2) \
        + jacobi_flops(n3, D, 6)
    k3_bytes = n3 * (2 * D * D * 8 + D * 8)
    n1 = 4 * 257 * 3
    k1_bytes = n1 * (D * D * 8 + D * 4 + D * D * 8)
    # y and the model in; the two time chunks' partial sums out
    k4_bytes = nbytes(stats_in[0][0], model['eigenvalues'],
                      model['eigenvectors'], model['weight']) \
        + 2 * N * K * (D * D * 8 + 4)
    k4_flops = em_flops(N * T, K, D) + N * K * 2 * D ** 2
    # the streaming path's launches (both modes) join the counts of the
    # kernels it runs: K2 (the warm-up fits), K1 (each block's M-step)
    # and K3 (each beamformed block)
    streamed = {k: sum(m[k] for m in stream_launches_.values())
                for k in ('em_loop.cacgmm_em_full', 'eigh.eigh_jacobi',
                          'gev.gev')}
    # and so do the parallel phase's (the mesh separate_batch, the
    # sharded fits, the DTensor fits, deflationSeed, the examples)
    for k in streamed:
        streamed[k] += parallel_launches[k]
    rows = [
        ('cacgmm_em_full', 'em_loop.cu', 'pallas_em_loop.py:386',
         launches['em_loop.cacgmm_em_full']
         + streamed['em_loop.cacgmm_em_full'],
         errors['em_slice'], slice_ms, slice_plain,
         bound(k2_bytes, k2_flops), None),
        ('gev', 'gev.cu', 'pallas_gev.py:176',
         launches['gev.gev'] + streamed['gev.gev'], errors['gev_slice'],
         gslice_ms, gslice_plain, bound(k3_bytes, k3_flops), None),
        ('eigh_jacobi', 'eigh.cu', 'pallas_eigh.py:124',
         long_launches['eigh.eigh_jacobi'] + streamed['eigh.eigh_jacobi'],
         errors['eigh'], eigh_ms, eigh_plain,
         bound(k1_bytes, jacobi_flops(n1, D, 6)), eigh_library),
        ('cacgmm_em_long', 'em_stream.cu', 'pallas_em_stream.py:248',
         long_launches['em_stream.e_stats'], errors['stream'], stats_ms,
         stats_plain, bound(k4_bytes, k4_flops), None),
        ('cacgmm_em_fc_init', 'em_step.cu', 'pallas_em_step.py:288',
         fc_launches['em_step.m_init']
         + parallel_launches['em_step.m_init'], errors['fc']['init'],
         *fc_times['init'], None),
        ('cacgmm_em_fc_step', 'em_step.cu', 'pallas_em_step.py:288',
         fc_launches['em_step.em_step']
         + parallel_launches['em_step.em_step'], errors['fc']['step'],
         *fc_times['step'], None),
        ('cacgmm_e_step', 'em_estep.cu', 'pallas_em.py:83',
         fc_launches['em_estep.cacgmm_e_step'], errors['e_step'],
         *estep_times['e_step'], None),
        ('cacgmm_em_scatter', 'em_estep.cu', 'pallas_em.py:193',
         fc_launches['em_estep.cacgmm_em_scatter'], errors['scatter'],
         *estep_times['scatter'], None),
        ('cwmm_em_full', 'cwmm_loop.cu', 'pallas_cwmm_loop.py:296',
         cwmm_launches['cwmm_loop.cwmm_em_full']
         + parallel_launches['cwmm_loop.cwmm_em_full'],
         errors['cwmm_slice'],
         *cwmm_times['cwmm_em_full'], None),
        ('cwmm_em_long', 'mm_stream.cu', 'pallas_mm_stream.py:252',
         cwmm_launches['cwmm_em_long'], errors['watson_stream'],
         *cwmm_times['cwmm_em_long'], None),
        ('bingham_chord_solve', 'bingham.cu', 'pallas_bingham.py:293',
         cbmm_launches['bingham.bingham_chord_solve'], errors['bingham'],
         *cbmm_times['bingham_chord_solve'], None),
        ('cbmm_em_full', 'cbmm_loop.cu', 'pallas_cbmm_loop.py:338',
         cbmm_launches['cbmm_loop.cbmm_em_full']
         + parallel_launches['cbmm_loop.cbmm_em_full'],
         errors['cbmm_slice'],
         *cbmm_times['cbmm_em_full'], None),
        ('cbmm_em_long', 'mm_stream.cu', 'pallas_mm_stream.py:252',
         cbmm_launches['cbmm_em_long'], errors['bingham_stream'],
         *cbmm_times['cbmm_em_long'], None),
        ('integration_e_stats', 'integration_em.cu',
         'pallas_integration_em.py:282',
         integration_launches['integration_em.e_stats']
         + parallel_launches['integration_em.e_stats'],
         errors['integration_stats'],
         *integration_times['integration_e_stats'], None),
        ('integration_em_full', 'integration_em_loop.cu',
         'pallas_integration_em_loop.py:530',
         integration_launches['integration_em_loop.integration_em_full']
         + parallel_launches['integration_em_loop.integration_em_full'],
         errors['integration_loop'],
         *integration_times['integration_em_full'], None),
    ]
    kernels = []
    for (name, source, replaces, count, err, ms, plain, (bound_ms, by),
         library) in rows:
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'pb_bss_tpu_torch/csrc/{source}',
            'replaces': f'pb_bss_tpu/ops/{replaces}', 'launches': count,
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain,
            'bound_ms': bound_ms, 'bound_by': by, 'library_ms': library})
        log(f'bound {name}: {bound_ms:.4f} ms by {by}; kernel {ms:.4f} ms '
            f'({bound_ms / ms:.3f} of the bound)')
    return kernels


def e2e(batches, count, label, model='cacgmm'):
    """Host clock around synchronized separate_batch calls, distinct
    recordings per repetition, after one warm-up call."""
    import pb_bss_tpu_torch as P
    P.separate_batch(batches[0], iterations=20, beamformer='gev+ban',
                     model=model)
    sync()
    times = []
    for obs in batches[1:]:
        t0 = time.perf_counter()
        P.separate_batch(obs, iterations=20, beamformer='gev+ban',
                         model=model)
        sync()
        times.append(time.perf_counter() - t0)
    per_utt = [1e3 * t / count for t in times]
    log(f"timing e2e separate_batch({count}, gev+ban, 20 it, "
        f"model='{model}'): ms per {label} "
        f'{[round(t, 2) for t in per_utt]}')


def time_e2e():
    """The cACGMM main path end to end: separate_batch of 8 x 4.8 s
    utterances (whole-fit EM) and of 4 x 60 s recordings (streamed EM).
    Returns the 4.8 s batches."""
    short = [load_utterances(range(8 * r, 8 * r + 8))[0].cuda()
             for r in range(1, 5)]
    e2e(short, 8, 'utterance (4.8 s)')
    e2e([long_recordings(first, 4)[0].cuda()
         for first in (1000, 2000, 3000)], 4, '60 s recording')
    return short


def time_em_splits():
    """The split of K2's, K4's, K9's and K5's time (the last two in
    :func:`time_cbmm_fc_splits`) and of K7's and K8's
    (:func:`time_stream_chord_splits`), with their own arguments only:
    K2 (B=8, F=257, D=6, K=3) at 20 iterations against 1, warm_sweeps 2
    against 0, T=304 against 32, T=303 against 304 (the scatter's frame
    group, ``em_loop.scatter_frames``: 2 at D=6, so 303 frames leave one
    to its one-by-one tail), and at the bench.py shape (B=8, F=513,
    T=300); K4 (B=4, F=257, T=3753) from_init mode (the sums alone)
    against model mode (E-step and sums). Returns {case: ms}."""
    from pb_bss_tpu_torch.ops.em_loop import cacgmm_em_full
    from pb_bss_tpu_torch.ops.em_stream import (
        cacgmm_em_long_reference, e_stats)
    out = {}
    for F, T in ((257, 304), (257, 32), (257, 303), (513, 300)):
        inputs = [em_inputs(8, F, 6, 3, T, 3000 + i) for i in range(6)]
        for iterations, warm in ((20, 2), (1, 2), (20, 0)):
            if T != 304 and (iterations, warm) != (20, 2):
                continue
            case = f'K2 F={F} T={T} it={iterations} warm={warm}'
            out[case] = cuda_time(lambda y, a, q: cacgmm_em_full(
                y, a, q, iterations=iterations, sweeps=6,
                warm_sweeps=warm), inputs)
    B, F, D, K, T = 4, 257, 6, 3, 3753
    N = B * F
    ins = [em_inputs(B, F, D, K, T, 3100 + i) for i in range(5)]
    weight, ev, vec = cacgmm_em_long_reference(*ins[0], iterations=1)
    model = dict(eigenvalues=ev.reshape(N, K, D),
                 eigenvectors=vec.reshape(N, K, D, D),
                 weight=weight.reshape(N, K), affiliation_eps=1e-10)
    out['K4 from_init'] = cuda_time(lambda y, a, q: e_stats(
        y.reshape(N, D, T), affiliation=a.reshape(N, K, T),
        quadratic_form=q.reshape(N, K, T)), ins)
    out['K4 model'] = cuda_time(
        lambda y, a, q: e_stats(y.reshape(N, D, T), **model), ins)
    from pb_bss_tpu_torch.ops import _build, em_loop, em_stream
    lib = _build.load('em_loop')
    if hasattr(em_loop, '_threads'):  # not in older checkouts
        # the CTA shape: the slice shape with 5 warps a CTA (2 rounds of
        # frames) against the 4 that em_loop._threads takes
        chosen = em_loop._threads
        em_loop._threads = lambda D, K, T: 160
        inputs = [em_inputs(8, 257, 6, 3, 304, 3000 + i) for i in range(6)]
        out['K2 F=257 T=304 it=20 warm=2 160 threads'] = cuda_time(
            lambda y, a, q: cacgmm_em_full(y, a, q, iterations=20, sweeps=6,
                                           warm_sweeps=2), inputs)
        em_loop._threads = chosen
    if hasattr(em_stream, '_WAVES'):  # not in older checkouts
        # the grid's waves: K4's model-mode pass with 1, 2 and 8 whole
        # waves against the 4 that em_stream._WAVES takes
        chosen = em_stream._WAVES
        for waves in (1, 2, 8):
            em_stream._WAVES = waves
            out[f'K4 model {waves} waves'] = cuda_time(
                lambda y, a, q: e_stats(y.reshape(N, D, T), **model), ins)
        em_stream._WAVES = chosen
    if hasattr(lib, 'cacgmm_em_full_occupancy'):
        threads = em_loop._threads(6, 3, 304)
        per_sm = lib.cacgmm_em_full_occupancy(6, 3, 304, threads)
        log(f'occupancy: K2 CTAs per SM at D=6, K=3, T=304 ({threads} '
            f'threads) {per_sm}; K4 resident CTAs at D=6, K=3 '
            f'{resident_ctas("em_stream", 6, 3)}')
    out.update(time_cbmm_fc_splits())
    out.update(time_stream_chord_splits())
    out.update(time_watson_integration_splits())
    out.update(time_eigh_stats_splits())
    log('timing splits (ms per call): '
        + '; '.join(f'{case} {ms:.4f}' for case, ms in out.items()))
    return out


def time_cbmm_fc_splits():
    """The split of K9's and K5's time, with their own arguments only: K9
    (B=8, F=257, D=6, K=3) at 20 iterations against 1, warm_steps 16
    against 0 (the steady solve's chord steps) and T=304 against 32 (the
    frames against the fixed work), and at the bench.py shape (F=513,
    T=300); K5 (B=8, F=513, D=6, K=3) the 20-iteration fc fit, the init, a
    step at warm_sweeps 2 against 0 and at T=300 against 32. Returns
    {case: ms}."""
    from pb_bss_tpu_torch.ops import em_step
    from pb_bss_tpu_torch.ops.cbmm_loop import cbmm_em_full
    out = {}
    for F, T in ((257, 304), (257, 32), (513, 300)):
        ins = [watson_inputs(8, F, 6, 3, T, 3200 + i)[:2]
               for i in range(4)]
        for iterations, warm_steps in ((20, 16), (1, 16), (20, 0)):
            if T != 304 and (iterations, warm_steps) != (20, 16):
                continue
            out[f'K9 F={F} T={T} it={iterations} warm_steps={warm_steps}'] \
                = cuda_time(lambda y, a: cbmm_em_full(
                    y, a, iterations=iterations, warm_steps=warm_steps), ins)
    B, F, D, K = 8, 513, 6, 3
    fits = [em_inputs(B, F, D, K, 300, 3400 + i) for i in range(4)]
    out['K5 fc fit F=513 T=300 it=20'] = cuda_time(
        lambda y, a, q: em_step.cacgmm_em_fc(y, a, q, iterations=20), fits)
    for T in (300, 32):
        ins = [fold_inputs(B, F, D, K, T, 3300 + i)[:3] for i in range(6)]
        init = dict(sweeps=6, eigenvalue_floor=1e-10)
        if T == 300:
            out[f'K5 init F=513 T={T}'] = cuda_time(
                lambda y, a, q: em_step.m_init(y, a, q, **init), ins)
        states = []
        for y, aff, qf in ins:
            vec, ev, asum = em_step.m_init(y, aff, qf, **init)
            states.append((y, ev, vec, asum.reshape(B, F, K).sum(1) / (F * T)))
        for warm in ((2, 0) if T == 300 else (2,)):
            out[f'K5 step F=513 T={T} warm_sweeps={warm}'] = cuda_time(
                lambda *x: em_step.em_step(
                    *x, warm_sweeps=warm, eigenvalue_floor=1e-10,
                    affiliation_eps=1e-10), states)
    return out


def resident_ctas(name, *shape):
    """CTAs of one pass of the streamed kernel library ``name`` (K4's or
    K7's) resident on the card at once, or None where the package timed
    (``--package``) predates the shared plan ``ops/_plan.py``."""
    import torch
    try:
        from pb_bss_tpu_torch.ops import _plan
    except ImportError:
        return None
    return _plan.capacity(name, torch.cuda.current_device(), *shape)


def time_stream_chord_splits():
    """The split of K7's and K8's time, with their own arguments only: K7
    (B=1, F=513, D=6, K=3) in from-init mode (the sums alone) against
    step mode (E-step and sums), Watson against Bingham, T=4000 against
    512 (the frames against the fixed work), and at T=4000 the wrapper's
    host time per call (no synchronization inside the window) against
    the kernel's device time per launch (the profiler); K8 (D=6) a warm
    solve of 3,084 problems at 16 steps against 0 (the step chain against
    the finite-difference phase) and of 24,672 problems at 16 steps
    (whether the card is filled or latency sets the pace). Returns {case:
    ms}."""
    from pb_bss_tpu_torch.ops import bingham
    from pb_bss_tpu_torch.ops.mm_stream import mm_stats
    out = {}
    log('occupancy: K7 resident CTAs at D=6, K=3: Watson '
        f'{resident_ctas("mm_stream", 6, 3, 0)}, Bingham '
        f'{resident_ctas("mm_stream", 6, 3, 1)}')
    for T in (4000, 512):
        ws = watson_states(513, T, 3500 + T, 4)
        cases = (('from_init', lambda y, a, *_: mm_stats(y, affiliation=a),
                  ws),
                 ('watson step', watson_step(mm_stats), ws),
                 ('bingham step', bingham_step(mm_stats),
                  bingham_states(513, T, 3600 + T, 4)))
        for name, call, states in cases:
            out[f'K7 {name} T={T}'] = cuda_time(call, states)
            kernel, every, host = device_ms_per_launch(call, states[0],
                                                       'mm_stream')
            out[f'K7 {name} T={T} device per launch'] = kernel
            if T == 4000:
                out[f'K7 {name} T={T} host per call'] = host
                out[f'K7 {name} T={T} device per call, all kernels'] = every
    # K8
    D = 6
    bounds = dict(lower=-32768. / (D - 1), upper=-1e-3)
    for B in (3084, 24672):
        solves = chord_problems(B, D, 3700 + B, 4) * 5
        for steps in ((16, 0) if B == 3084 else (16,)):
            out[f'K8 P={B} steps={steps}'] = cuda_time(
                lambda s, x: bingham.bingham_chord_solve(
                    s, x, iterations=steps, **bounds), solves)
    return out


def separate_device_ms(obs, model):
    """(device ms of all kernels, host ms) of one separate_batch(obs,
    model=...) call, after a warm-up call of the same shape: the
    profiler for the device, the host clock around the synchronized
    call."""
    import pb_bss_tpu_torch as P
    P.separate_batch(obs, iterations=20, beamformer='gev+ban', model=model)
    sync()
    prof, wall = profile_device(lambda: P.separate_batch(
        obs, iterations=20, beamformer='gev+ban', model=model))
    return device_times(prof, '')['all kernels'][0] / 1e3, 1e3 * wall


def time_watson_integration_splits():
    """The split of K6's and K12's time, with their own arguments only.
    K6 (B=8, F=257, D=6, K=3) at 20 iterations against 1, warm_sweeps 2
    against 0 (the warm sweeps), T=304 against 32 (the frames against the
    fixed work), at the bench.py shape (F=513, T=300) and at the 4 x 60 s
    shape (B=4, F=257, T=3753); the device time of separate_batch(model=
    'cwmm') on 8 x 4.8 s and 4 x 60 s. K12 (vMF, F=513, D=6, K=3) at
    config 3 (B=1, T=300, E=20): 19 iterations against 1, T=300 against
    32, E=20 against 1, a grid of 132 CTAs against the wrapper's, and
    at B=8; the host clock of VMFCACGMMTrainer.fit(use_fused_em='loop')
    at config 3. Returns {case: ms}."""
    import statistics
    import torch
    from pb_bss_tpu_torch.models import VMFCACGMMTrainer
    from pb_bss_tpu_torch.ops import integration_em_loop as il
    from pb_bss_tpu_torch.ops.cwmm_loop import cwmm_em_full
    out = {}
    for B, F, T in ((8, 257, 304), (8, 257, 32), (8, 513, 300),
                    (4, 257, 3753)):
        count = 3 if T > 1000 else 6
        ins = [watson_inputs(B, F, 6, 3, T, 3800 + i)[:2]
               for i in range(count)]
        for iterations, warm in ((20, 2), (1, 2), (20, 0)):
            if (B, F, T) != (8, 257, 304) and (iterations, warm) != (20, 2):
                continue
            out[f'K6 B={B} F={F} T={T} it={iterations} warm={warm}'] = \
                cuda_time(lambda y, a: cwmm_em_full(
                    y, a, iterations=iterations, warm_sweeps=warm), ins)
        del ins
    short = load_utterances(range(8, 16))[0].cuda()
    out['separate_batch cwmm 8 x 4.8 s device'], \
        out['separate_batch cwmm 8 x 4.8 s host'] = \
        separate_device_ms(short, 'cwmm')
    long = long_recordings(2000, 4)[0].cuda()
    out['separate_batch cwmm 4 x 60 s device'], \
        out['separate_batch cwmm 4 x 60 s host'] = \
        separate_device_ms(long, 'cwmm')
    del short, long

    D, K, F = 6, 3, 513

    def whole_fit(iterations, grid=None):
        return lambda y, emb, ev, vec, w, spec, sal: il.integration_em_full(
            y, emb, vec, ev, w, *spec, iterations=iterations,
            bins_per_utt=F, grid=grid)

    for B, T, E in ((1, 300, 20), (1, 32, 20), (1, 300, 1), (8, 300, 20)):
        ins = [integration_inputs(B * F, D, K, T, E, B, 'vmf', 3900 + i)
               for i in range(4)]
        cases = [(19, None)]
        if (B, T, E) == (1, 300, 20):
            cases += [(1, None), (19, 132), (19, 264)]
        for iterations, grid in cases:
            ms = cuda_time(whole_fit(iterations, grid), ins)
            out[f'K12 vmf B={B} T={T} E={E} it={iterations} grid='
                f'{il.integration_em_full.last_grid}'] = ms
        del ins
    fits = []
    for i in range(4):
        y, _, _ = em_inputs(1, F, D, K, 300, 3950 + i)
        g = torch.Generator('cuda').manual_seed(3950 + i)
        emb = torch.randn((F, 300, 20), generator=g, device='cuda')
        fits.append((y[0].transpose(-1, -2),
                     emb / emb.norm(dim=-1, keepdim=True)))
    times = []
    for obs, emb in fits:
        sync()
        t0 = time.perf_counter()
        VMFCACGMMTrainer().fit(obs, emb, num_classes=K, iterations=20,
                               use_fused_em='loop')
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    out["VMFCACGMMTrainer.fit 'loop' F=513 T=300 host (median of 3)"] = \
        statistics.median(times[1:])
    return out


def split_four(out, label, call, ins, key):
    """The four numbers of a kernel's split into ``out``: the call (CUDA
    events, a distinct input a call), the device time of the kernels
    whose name holds ``key`` per launch and of every kernel per call (the
    profiler), and the wrapper's host time per call."""
    out[f'{label} call'] = cuda_time(call, ins)
    kernel, every, host = device_ms_per_launch(call, ins[0], key)
    out[f'{label} device per launch'] = kernel
    out[f'{label} device per call, all kernels'] = every
    out[f'{label} host per call'] = host


def time_eigh_stats_splits():
    """The split of K1's and K10's time, with their own arguments only,
    and of the two paths they carry. K1 at 3,084 6 x 6 complex64 matrices
    (the long path's M-step: 4 x 257 bins x 3 classes) and at 1,539 (513
    bins x 3 classes, the integration 'auto' finish), at D = 2, 3, 8 and
    16 and in float32: the call (CUDA events, a distinct input a call),
    the kernel's device time per launch and that of every kernel of a
    call (the profiler: with the sort in torch, its torch.sort and
    torch.gather), and the wrapper's host time per call; and the CTA size.
    K10 at bench config 3 (F=513, T=300, D=6, K=3, E=20), vMF and
    Gaussian, B=1 and B=8: the same four numbers (every kernel of a call
    less the kernel is the wrapper's tail), and (vMF) the CTA's threads
    and the grid's waves. Then
    VMFCACGMMTrainer.fit('auto') and fit('loop') at config 3 on the host
    clock (median of 3 after a warm-up) and the device time of separate_batch of 4 x 60 s
    (K4 and K1 on the long path). Returns {case: ms}."""
    import statistics
    import torch
    from pb_bss_tpu_torch.models import VMFCACGMMTrainer
    from pb_bss_tpu_torch.ops import eigh as eigh_op
    from pb_bss_tpu_torch.ops import integration_em
    out = {}

    def four(label, call, ins, key):
        split_four(out, label, call, ins, key)

    for B, D, dtype in ((3084, 6, torch.complex64),
                        (1539, 6, torch.complex64),
                        (3084, 6, torch.float32), (3084, 2, torch.complex64),
                        (3084, 3, torch.complex64), (3084, 8, torch.complex64),
                        (3084, 16, torch.complex64)):
        ins = [(hermitian_batch(B, D, 4000 + i, dtype),) for i in range(6)]
        name = 'c64' if dtype == torch.complex64 else 'f32'
        four(f'K1 B={B} D={D} {name}', eigh_op.eigh_jacobi, ins, 'eigh')
    if hasattr(eigh_op, 'cta_warps'):  # not in older checkouts
        # the CTA size: 1, 2 and 4 warps a CTA against the wrapper's choice
        ins = [(hermitian_batch(3084, 6, 4000 + i),) for i in range(6)]
        chosen = eigh_op.cta_warps
        log(f'K1 B=3084 D=6: the wrapper takes {chosen(3084, 6, 132)} '
            'warps a CTA on 132 SMs')
        for warps in (1, 2, 4):
            eigh_op.cta_warps = lambda B, D, sms, w=warps: w
            label = f'K1 B=3084 D=6 c64 {warps} warps a CTA'
            out[f'{label} call'] = cuda_time(eigh_op.eigh_jacobi, ins)
            out[f'{label} device per launch'] = device_ms_per_launch(
                eigh_op.eigh_jacobi, ins[0], 'eigh')[0]
        eigh_op.cta_warps = chosen
    D, K, E, F, T = 6, 3, 20, 513, 300
    for mode in ('vmf', 'gaussian'):
        for B in (1, 8):
            ins = [integration_inputs(B * F, D, K, T, E, B, mode, 4100 + i)
                   for i in range(4)]

            def call(y, emb, ev, vec, w, spec, sal, mode=mode):
                return integration_em.e_stats(
                    y, emb, eigenvalues=ev, eigenvectors=vec, weight=w,
                    mu=spec[0], kappa=spec[1], log_c=spec[2],
                    bins_per_utt=F, spectral_mode=mode)

            four(f'K10 {mode} B={B}', call, ins, 'integration_stats')
            if mode == 'vmf' and hasattr(integration_em, '_WAVES'):
                # the CTA's threads and the grid's waves against the
                # wrapper's choice
                chosen = integration_em.TILE, integration_em._WAVES
                for threads, waves in ((256, 1), (256, 2), (256, 4),
                                       (128, 2), (128, 4)):
                    integration_em.TILE = threads
                    integration_em._WAVES = waves
                    label = f'K10 vmf B={B} {threads} threads {waves} waves'
                    out[f'{label} call'] = cuda_time(call, ins)
                    out[f'{label} device per launch'] = device_ms_per_launch(
                        call, ins[0], 'integration_stats')[0]
                integration_em.TILE, integration_em._WAVES = chosen
            del ins
    fits = []
    for i in range(4):
        y, _, _ = em_inputs(1, F, D, K, T, 4200 + i)
        g = torch.Generator('cuda').manual_seed(4200 + i)
        emb = torch.randn((F, T, E), generator=g, device='cuda')
        fits.append((y[0].transpose(-1, -2),
                     emb / emb.norm(dim=-1, keepdim=True)))
    for route in ('auto', 'loop'):
        times = []
        for obs, emb in fits:
            sync()
            t0 = time.perf_counter()
            VMFCACGMMTrainer().fit(obs, emb, num_classes=K, iterations=20,
                                   use_fused_em=route)
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        out[f"VMFCACGMMTrainer.fit {route!r} F=513 T=300 host (median of "
            "3)"] = statistics.median(times[1:])
    long = long_recordings(2000, 4)[0].cuda()
    out['separate_batch cacgmm 4 x 60 s device'], \
        out['separate_batch cacgmm 4 x 60 s host'] = \
        separate_device_ms(long, 'cacgmm')
    log('timing K1 / K10 splits (ms): '
        + '; '.join(f'{case} {ms:.4f}' for case, ms in out.items()))
    return out


def time_gev_estep_splits():
    """The split of K3's and K11's time, with their own arguments only,
    and of the paths they carry. K3 at 513 and 6,168 pencils of D=6 (the
    slice cell's 8 x 257 bins x 3 classes), at 6,168 also D = 2, 3, 8
    and 16, and get_gev_vector on 6,168 pencils whole (with its torch
    work; its K3 launches a call): the call (CUDA events, a distinct
    input a call), the kernel's device time per launch and that of every
    kernel of a call (the profiler), and the wrapper's host time per
    call; where the package has them, the warps a CTA against the
    wrapper's choice. K11: the E-step at F=513 T=300, the scatter at
    F=257 T=304 and F=513 T=3753, the same four numbers, and where the
    package has them the grid's waves against the wrapper's choice and
    the trainer's route (em_scatter_model) at F=257 T=304. Then CACGMMTrainer.fit(use_pallas_em=True) at F=257
    T=304, 20 iterations, on the host clock (the medians of the first 3
    and of 10 after a warm-up) with its device time, and the device time
    of separate_batch of 8 x 4.8 s (the slice cell). Returns {case:
    ms}."""
    import statistics
    import torch
    from pb_bss_tpu_torch.extraction.beamformer import get_gev_vector
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer
    from pb_bss_tpu_torch.ops import em_estep
    from pb_bss_tpu_torch.ops import gev as gev_op
    out = {}
    for B, D in ((513, 6), (6168, 6), (6168, 2), (6168, 3), (6168, 8),
                 (6168, 16)):
        ins = [pencils(B, D, 4300 + i) for i in range(6)]
        split_four(out, f'K3 B={B} D={D}', gev_op.gev, ins, 'gev')
        if B == 6168 and D == 6 and hasattr(gev_op, 'cta_warps'):
            chosen = gev_op.cta_warps
            log(f'K3 B=6168 D=6: the wrapper takes {chosen(6168, 6, 132)} '
                'warps a CTA on 132 SMs')
            for warps in (1, 2, 4):
                gev_op.cta_warps = lambda B, D, sms, w=warps: w
                label = f'K3 B=6168 D=6 {warps} warps a CTA'
                out[f'{label} call'] = cuda_time(gev_op.gev, ins)
                out[f'{label} device per launch'] = device_ms_per_launch(
                    gev_op.gev, ins[0], 'gev')[0]
            gev_op.cta_warps = chosen
        del ins
    ins = [pencils(6168, 6, 4400 + i) for i in range(6)]
    split_four(out, 'get_gev_vector B=6168 D=6', get_gev_vector, ins, 'gev')
    gev_op.gev.launches = 0
    get_gev_vector(*ins[0])
    sync()
    out['get_gev_vector B=6168 D=6 K3 launches a call'] = gev_op.gev.launches
    prof, _ = profile_device(lambda: get_gev_vector(*ins[1]))
    log(f'profile get_gev_vector B=6168 D=6: device us (count) '
        f'{device_times(prof, "")}')
    del ins
    D, K = 6, 3
    for name, call, key, F, T in (
            ('e_step', em_estep.cacgmm_e_step, 'em_e_step', 513, 300),
            ('scatter', em_estep.cacgmm_em_scatter, 'em_scatter', 257, 304),
            ('scatter', em_estep.cacgmm_em_scatter, 'em_scatter', 513,
             3753)):
        ins = [estep_inputs(F, D, K, T, 4500 + i) for i in range(6)]
        label = f'K11 {name} F={F} T={T}'
        split_four(out, label, call, ins, key)
        if hasattr(em_estep, 'WAVES'):
            chosen = em_estep.WAVES
            for waves in (1, 2, 4):
                if waves == chosen:
                    continue
                em_estep.WAVES = waves
                knob = f'{label} {waves} waves'
                out[f'{knob} call'] = cuda_time(call, ins)
                out[f'{knob} device per launch'] = device_ms_per_launch(
                    call, ins[0], key)[0]
            em_estep.WAVES = chosen
            log(f'{label}: the wrapper takes {em_estep.THREADS} threads in '
                f'{chosen} waves')
        if name == 'scatter' and T == 304 and hasattr(em_estep,
                                                     'em_scatter_model'):
            # the trainer's route: the complex tensors as they are
            split_four(out, f'K11 em_scatter_model F={F} T={T}',
                       em_estep.em_scatter_model,
                       [(torch.complex(a[0], a[1]), torch.complex(a[2], a[3]),
                         *a[4:]) for a in ins], key)
        del ins
    y, aff, _ = em_inputs(1, 257, D, K, 304, 4600)
    Y, aff = y[0].transpose(-1, -2).contiguous(), aff[0]
    times = []
    for _ in range(11):
        sync()
        t0 = time.perf_counter()
        CACGMMTrainer().fit(Y, initialization=aff, iterations=20,
                            use_pallas_em=True)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    log(f'timing fit(use_pallas_em=True) F=257 T=304, 20 it: host ms '
        f'{[round(t, 3) for t in times[1:]]} (after one warm-up)')
    out['fit(use_pallas_em=True) F=257 T=304 host (median of 3)'] = \
        statistics.median(times[1:4])
    out['fit(use_pallas_em=True) F=257 T=304 host (median of 10)'] = \
        statistics.median(times[1:])
    prof, _ = profile_device(lambda: CACGMMTrainer().fit(
        Y, initialization=aff, iterations=20, use_pallas_em=True))
    out['fit(use_pallas_em=True) F=257 T=304 device'] = \
        device_times(prof, '')['all kernels'][0] / 1e3
    log(f'profile fit(use_pallas_em=True) F=257 T=304: device us (count) '
        f'{device_times(prof, "")}')
    short = load_utterances(range(8, 16))[0].cuda()
    out['separate_batch cacgmm 8 x 4.8 s device'], \
        out['separate_batch cacgmm 8 x 4.8 s host'] = \
        separate_device_ms(short, 'cacgmm')
    log('timing K3 / K11 splits (ms): '
        + '; '.join(f'{case} {ms:.4f}' for case, ms in out.items()))
    return out


def time_fc():
    """K5 at the JAX package's frequency-constant benchmark shape (B=8,
    F=513, D=6, K=3, T=300): each kernel per launch against its twin,
    the whole fit per 20 iterations, and the port's scan path on the
    same fit on the card. Returns {kernel: (ms, plain_ms, bound)}."""
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer
    from pb_bss_tpu_torch.ops import em_step
    B, F, D, K, T = 8, 513, 6, 3, 300
    N = B * F
    ins = [fold_inputs(B, F, D, K, T, 700 + i) for i in range(6)]
    states = []
    for y, aff, qf, _, _ in ins:
        vec, ev, asum = em_step.m_init(y, aff, qf, sweeps=6,
                                       eigenvalue_floor=1e-10)
        w = asum.reshape(B, F, K).sum(1) / (F * T)
        states.append((y, ev, vec, w))
    init = dict(sweeps=6, eigenvalue_floor=1e-10)
    step = dict(warm_sweeps=2, eigenvalue_floor=1e-10, affiliation_eps=1e-10)
    init_ms = cuda_time(lambda y, a, q, *_: em_step.m_init(y, a, q, **init),
                        ins)
    init_plain = cuda_time(lambda y, a, q, *_: em_step.m_init_reference(
        y, a, q, **init), ins[:3])
    step_ms = cuda_time(lambda *x: em_step.em_step(*x, **step), states)
    step_plain = cuda_time(lambda *x: em_step.em_step_reference(*x, **step),
                           states[:3])
    log(f'timing K5 B=8 F=513 D=6 K=3 T=300: init kernel {init_ms:.4f} ms '
        f'(plain {init_plain:.4f}), step kernel {step_ms:.4f} ms (plain '
        f'{step_plain:.4f})')
    y, aff, qf = ins[0][:3]
    init_bytes = nbytes(y, aff, qf) + N * K * (8 * D * D + 4 * D + 4)
    init_flops = em_flops(N * T, K, D, e_step=False) \
        + jacobi_flops(N * K, D, 6)
    y, ev, vec, w = states[0]
    step_bytes = nbytes(y, ev, vec, w) + N * K * (8 * D * D + 4 * D + 4)
    step_flops = em_flops(N * T, K, D) \
        + N * K * (16 * D ** 3 + 2 * D ** 2) + jacobi_flops(N * K, D, 2)

    fits = [em_inputs(B, F, D, K, T, 800 + i) for i in range(4)]
    fit_ms = cuda_time(lambda y, a, q: em_step.cacgmm_em_fc(
        y, a, q, iterations=20), fits)
    fit_plain = cuda_time(lambda y, a, q: em_step.cacgmm_em_fc_reference(
        y, a, q, iterations=20), fits[:2])
    scan_ms = cuda_time(lambda y, a, q: CACGMMTrainer().fit(
        y.transpose(-1, -2), initialization=a, iterations=20,
        weight_constant_axis=(-3, -1), use_fused_em=False), fits[:3])
    log(f'timing cacgmm_em_fc B=8 F=513 T=300, 20 it: kernels {fit_ms:.3f} '
        f'ms ({20e3 / fit_ms:.1f} iters/s), plain twins {fit_plain:.3f} ms; '
        f'the scan path on the card (use_fused_em=False) {scan_ms:.3f} ms')

    # the stage split of one fc fit: the launches alone, the torch work
    # between them, and the inline aligner's share (B=1, F=257, T=304)
    prof, _ = profile_device(
        lambda: em_step.cacgmm_em_fc(*fits[0], iterations=20))
    log(f'profile cacgmm_em_fc B=8 F=513 T=300, 20 it: device us (count) '
        f'by kernel {device_times(prof, "em_fc")}')
    return {'init': (init_ms, init_plain, bound(init_bytes, init_flops)),
            'step': (step_ms, step_plain, bound(step_bytes, step_flops))}


def device_times(prof, key):
    """{kernel name: (device us, launches)} of a profile's kernels whose
    name holds ``key`` ('' for all, summed under 'all kernels'). A
    capture that recorded no device time (``prof`` None, see
    :func:`profile_device`) has none to give: NaN under 'all kernels'."""
    if prof is None:
        return {} if key else {'all kernels': (math.nan, 0)}
    table = kernel_table(prof)
    if not key:
        return {'all kernels': (round(sum(us for us, _ in table.values()), 1),
                                sum(n for _, n in table.values()))}
    out = {}
    for event_key, (us, count) in table.items():
        if key in event_key:
            name = re.search(r'(\w+)\((?!anonymous)', event_key)
            out[name.group(1) if name else event_key] = (round(us, 1),
                                                         count)
    return out


def kernel_table(prof):
    """{kernel name: (device us, launches)} of every device event of a
    profile (empty when the capture recorded nothing)."""
    if prof is None:
        return {}
    out = {}
    for event in prof.key_averages():
        us = getattr(event, 'device_time_total', None)
        if us is None:
            us = getattr(event, 'cuda_time_total', 0)
        if not us or getattr(event, 'device_type', None) is not None and \
                'CUDA' not in str(event.device_type):
            continue
        out[event.key] = (us, event.count)
    return out


def top_kernels(label, call, state, count=8):
    """Log the ``count`` kernels of one call(*state) (after a warm-up
    call) that take the most device time: name, ms and launches."""
    call(*state)
    sync()
    prof, _ = profile_device(lambda: call(*state))
    if prof is None:
        log(f'{label}: device time not measured (empty profiler capture)')
        return
    rows = sorted(((us, n, key[:70]) for key, (us, n)
                   in kernel_table(prof).items()), reverse=True)
    total = sum(us for us, _, _ in rows)
    log(f'{label}: {total / 1e3:.4f} ms of device time in '
        f'{sum(n for _, n, _ in rows)} kernels; the largest:')
    for us, n, name in rows[:count]:
        log(f'    {us / 1e3:.4f} ms  x{n}  {name}')


# captures of this process that recorded no device time through all
# their attempts (see profile_device)
EMPTY_CAPTURES = []


def profile_device(run, attempts=5, activities=('CPU', 'CUDA')):
    """(profile, seconds of wall) of run() under the profiler. On the
    card a CUPTI capture now and then records no device time at all,
    sometimes several in a row, and the next ones record again; such a
    capture is taken again after a pause, up to ``attempts`` times. A
    capture that stays empty gives None for the profile: its device
    times are not measured (NaN), and the callers that need a kernel's
    time take it from CUDA events around its calls
    (:func:`device_ms_per_launch`)."""
    import torch
    kinds = [getattr(torch.profiler.ProfilerActivity, a)
             for a in activities]
    for attempt in range(attempts):
        if attempt:
            time.sleep(1.0)
        sync()
        with torch.profiler.profile(activities=kinds) as prof:
            t0 = time.perf_counter()
            run()
            sync()
            wall = time.perf_counter() - t0
        if device_times(prof, '')['all kernels'][0] > 0:
            return prof, wall
        log(f'profiler: capture {attempt + 1} recorded no device time')
    EMPTY_CAPTURES.append(wall)
    log(f'profiler: a capture stayed empty ({len(EMPTY_CAPTURES)} in this '
        'process); its device times are not measured (nan)')
    return None, wall


def device_ms_per_launch(call, state, key, reps=20):
    """(device ms per launch of the kernels whose name holds ``key``,
    device ms of all kernels per call, host ms per call) of ``reps``
    calls of call(*state): the profiler for the device, the host clock
    around the calls (no synchronization inside the window) for the
    host. Where the profiler's capture stays empty, CUDA events around
    the calls stand for both device times: an upper bound, since the
    stream's idle gaps and the call's other kernels count."""
    call(*state)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        call(*state)
    host = 1e3 * (time.perf_counter() - t0) / reps

    def run():
        for _ in range(reps):
            call(*state)

    prof, _ = profile_device(run)
    if prof is None:
        events = cuda_time(call, [state] * reps, warmup=0)
        log(f'{key}: the profiler recorded nothing; CUDA events around '
            f'the calls give {events:.4f} ms a call for the kernels')
        return events, events, host
    kernel = sum(us for us, _ in device_times(prof, key).values())
    every = device_times(prof, '')['all kernels'][0]
    return kernel / reps / 1e3, every / reps / 1e3, host


def time_fc_stages():
    """Host clock of a 20-iteration fc fit with and without each inline
    aligner on one 4.8 s utterance (F=257, T=304), and the device time
    of its K5 launches: the aligner's share of the fit. Then the
    use_pallas_em fit at the same shape."""
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer
    from pb_bss_tpu_torch.permutation_alignment import (
        DHTVPermutationAlignment, GreedyPermutationAlignment)
    y, aff, _ = em_inputs(1, 257, 6, 3, 304, 900)
    Y, aff = y[0].transpose(-1, -2).contiguous(), aff[0]
    for name, aligner in (('none', None),
                          ('greedy', GreedyPermutationAlignment('cos')),
                          ('dhtv', DHTVPermutationAlignment.from_stft_size(
                              512))):
        times = []
        for _ in range(4):
            sync()
            t0 = time.perf_counter()
            CACGMMTrainer().fit(Y, initialization=aff, iterations=20,
                                weight_constant_axis=(-3, -1),
                                inline_permutation_aligner=aligner)
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        prof, _ = profile_device(lambda: CACGMMTrainer().fit(
            Y, initialization=aff, iterations=20,
            weight_constant_axis=(-3, -1),
            inline_permutation_aligner=aligner))
        log(f'timing fc fit F=257 T=304, 20 it, inline aligner {name}: ms '
            f'{[round(t, 3) for t in times[1:]]} (after one warm-up); '
            f'profiled device us (count) {device_times(prof, "em_fc")} of '
            f'{device_times(prof, "")}')

    times = []
    for _ in range(4):
        sync()
        t0 = time.perf_counter()
        CACGMMTrainer().fit(Y, initialization=aff, iterations=20,
                            use_pallas_em=True)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    log(f'timing fit(use_pallas_em=True) F=257 T=304, 20 it: ms '
        f'{[round(t, 3) for t in times[1:]]} (after one warm-up)')


def time_cwmm():
    """K6 per 20-iteration fit at the slice shape (B=8, F=257, T=304), at
    the bench shape (B=8, F=513, T=300) and at four 60 s recordings (B=4,
    F=257, T=3753), K7 per statistics pass at the long-T config (F=513,
    T=4000, step mode), and K2 with saliency and a source-activity mask
    at the slice shape, each against its twin. Returns {kernel: (ms,
    plain_ms, bound)}."""
    from pb_bss_tpu_torch.ops.cwmm_loop import (
        cwmm_em_full, cwmm_em_full_reference)
    from pb_bss_tpu_torch.ops.em_loop import (
        cacgmm_em_full, cacgmm_em_full_reference)
    from pb_bss_tpu_torch.ops.mm_stream import mm_stats, mm_stats_reference
    D, K = 6, 3
    out = {}

    def fits(B, F, T, seed, count=6):
        ins = [watson_inputs(B, F, D, K, T, seed + i)[:2]
               for i in range(count)]
        ms = cuda_time(lambda y, a: cwmm_em_full(
            y, a, iterations=20, warm_sweeps=2), ins)
        # the twin's 20-iteration fit takes seconds here: two timed
        # calls, no warm-up (phase_kernels ran it already)
        plain = cuda_time(lambda y, a: cwmm_em_full_reference(
            y, a, iterations=20), ins[:2], warmup=0)
        log(f'timing K6 B={B} F={F} D={D} K={K} T={T}, 20 it: kernel '
            f'{ms:.3f} ms ({20e3 / ms:.1f} iters/s), plain {plain:.3f} ms')
        return ms, plain, ins[0]

    ms, plain, (y, a) = fits(8, 257, 304, 1100)
    N, T = y.shape[0], y.shape[-1]
    k6_bytes = nbytes(y, a) + N * K * (4 + 8 * D + 4 + 4 * T)
    k6_flops = 20 * cwmm_flops(N * T, K, D) + jacobi_flops(N * K, D, 6) \
        + 19 * (jacobi_flops(N * K, D, 2) + N * K * 16 * D ** 3)
    out['cwmm_em_full'] = (ms, plain, bound(k6_bytes, k6_flops))
    fits(8, 513, 300, 1200)
    # K6 at four 60 s recordings (T=3753); phase_timing profiles it inside
    # separate_batch(model='cwmm') of the same shape
    fits(4, 257, 3753, 1250, count=3)

    # K2 with saliency and a mask at the slice shape, 20 iterations
    ins = [fold_inputs(8, 257, D, K, 304, 1300 + i, saliency=True,
                       mask=True) for i in range(6)]
    kw = dict(iterations=20, sweeps=6)
    ms2 = cuda_time(lambda y, a, q, s, m: cacgmm_em_full(
        y, a, q, warm_sweeps=2, saliency=s, source_activity_mask=m, **kw),
        ins)
    plain2 = cuda_time(lambda y, a, q, s, m: cacgmm_em_full_reference(
        y, a, q, saliency=s, source_activity_mask=m, **kw), ins[:2],
        warmup=0)
    log(f'timing K2 +saliency +mask B=8 F=257 D={D} K={K} T=304, 20 it: '
        f'kernel {ms2:.3f} ms, plain {plain2:.3f} ms')

    # K7: one step-mode pass at F=513, T=4000 from the twin's first M-step
    states = watson_states(513, 4000, 1400, 5)
    call7 = cuda_time(watson_step(mm_stats), states)
    plain7 = cuda_time(watson_step(mm_stats_reference), states[:3])
    # the wrapper's host work can exceed the kernel's time: the kernel's
    # own time is its device time per launch
    ms7, every7, host7 = device_ms_per_launch(
        watson_step(mm_stats), states[0], 'mm_stream')
    y = states[0][0]
    N, _, T = y.shape
    log(f'timing K7 statistics pass N={N} D={D} K={K} T={T} (step mode): '
        f'kernel {ms7:.4f} ms (device, per launch; every kernel of a call '
        f'{every7:.4f}), wrapper call {call7:.4f} ms (host {host7:.4f} '
        f'ms), plain {plain7:.4f} ms')
    P = D * (D + 1) // 2
    # y and the model in; the upper-triangle sums and asum out
    k7_bytes = nbytes(y, *states[0][2:]) + N * K * (8 * P + 4)
    out['cwmm_em_long'] = (ms7, plain7,
                           bound(k7_bytes, cwmm_flops(N * T, K, D)))
    return out


def profile_separate(model, cases):
    """Device time by kernel, wall time and the device's idle share of one
    separate_batch(model=...) call per (label, observations) case (after
    the e2e warm-up of the same shapes)."""
    import pb_bss_tpu_torch as P
    for label, obs in cases:
        P.separate_batch(obs, iterations=20, beamformer='gev+ban',
                         model=model)
        sync()
        prof, wall = profile_device(lambda: P.separate_batch(
            obs, iterations=20, beamformer='gev+ban', model=model))
        wall *= 1e3
        busy = device_times(prof, '')['all kernels'][0] / 1e3
        log(f"profile separate_batch({label}, model='{model}'): wall "
            f'{wall:.2f} ms (profiled), device busy {busy:.2f} ms, idle '
            f'share {1 - busy / wall:.3f}; device us (count) of the EM '
            f'kernels {device_times(prof, model)}, GEV '
            f'{device_times(prof, "gev")}')


def time_cbmm():
    """K8 per warm 16-step launch at the streamed route's M-step shape
    (4 x 257 bins x 3 classes), K9 per 20-iteration fit at the slice shape
    (B=8, F=257, T=304) and at the bench shape (B=8, F=513, T=300), the
    Bingham K7 per step-mode pass at the long-T config (F=513, T=4000),
    each against its twin; and the streamed fit of config 3e (5
    iterations) with its kernels against its twins. Returns {kernel: (ms,
    plain_ms, bound)}."""
    from pb_bss_tpu_torch.ops.bingham import (
        bingham_chord_solve, bingham_chord_solve_reference, cascade_flops,
        solve_cascades)
    from pb_bss_tpu_torch.ops.cbmm_loop import (
        cbmm_em_full, cbmm_em_full_reference)
    from pb_bss_tpu_torch.ops.mm_stream import (
        cbmm_em_long, cbmm_em_long_reference, mm_stats, mm_stats_reference)
    D, K = 6, 3
    out = {}

    # K8: warm solves from the twin's cold solution perturbed by 5%
    B = 4 * 257 * 3
    solves = chord_problems(B, D, 1500, 6)
    bounds = dict(iterations=16, lower=-32768. / (D - 1), upper=-1e-3)
    ms8 = cuda_time(lambda s, x: bingham_chord_solve(s, x, **bounds),
                    solves)
    plain8 = cuda_time(lambda s, x: bingham_chord_solve_reference(
        s, x, **bounds), solves[:3])
    k8_flops = B * solve_cascades(D, 1, 16) * cascade_flops(D)
    log(f'timing K8 {B} problems D={D}, warm 16 steps: kernel {ms8:.4f} ms, '
        f'plain {plain8:.4f} ms')
    out['bingham_chord_solve'] = (ms8, plain8,
                                  bound(3 * B * D * 4, k8_flops))

    def fits(Bu, F, T, seed):
        ins = [watson_inputs(Bu, F, D, K, T, seed + i)[:2] for i in range(4)]
        ms = cuda_time(lambda y, a: cbmm_em_full(y, a, iterations=20), ins)
        # the twin's 20-iteration fit takes seconds here: two timed
        # calls, no warm-up (phase_kernels ran it already)
        plain = cuda_time(lambda y, a: cbmm_em_full_reference(
            y, a, iterations=20), ins[:2], warmup=0)
        log(f'timing K9 B={Bu} F={F} D={D} K={K} T={T}, 20 it: kernel '
            f'{ms:.3f} ms ({20e3 / ms:.1f} iters/s), plain {plain:.3f} ms')
        return ms, plain, ins[0]

    ms9, plain9, (y, a) = fits(8, 257, 304, 1600)
    N, T = y.shape[0], y.shape[-1]
    # y and the initial affiliations in; weight, eigenvalues, eigenvectors,
    # log c and affiliations out
    k9_bytes = nbytes(y, a) + N * K * (4 + 4 * D + 8 * D * D + 4 + 4 * T)
    out['cbmm_em_full'] = (ms9, plain9,
                           bound(k9_bytes, bingham_flops(N, K, D, T, 20)))
    fits(8, 513, 300, 1700)

    # the Bingham K7: one step-mode pass at F=513, T=4000 from the twin's
    # first M-step
    states = bingham_states(513, 4000, 1800, 5)
    call7 = cuda_time(bingham_step(mm_stats), states)
    plain7 = cuda_time(bingham_step(mm_stats_reference), states[:3])
    ms7, every7, host7 = device_ms_per_launch(
        bingham_step(mm_stats), states[0], 'mm_stream')
    y = states[0][0]
    N, _, T = y.shape
    log(f'timing K7 bingham statistics pass N={N} D={D} K={K} T={T} (step '
        f'mode): kernel {ms7:.4f} ms (device, per launch; every kernel of a '
        f'call {every7:.4f}), wrapper call {call7:.4f} ms (host '
        f'{host7:.4f} ms), plain {plain7:.4f} ms')
    P_ = D * (D + 1) // 2
    k7_bytes = nbytes(y, *states[0][2:]) + N * K * (8 * P_ + 4)
    out['cbmm_em_long'] = (ms7, plain7, bound(
        k7_bytes, em_flops(N * T, K, D, form='assembled')
        + N * K * 8 * D ** 3))

    # the streamed fit of config 3e: its kernels against its twins
    ins = [em_inputs(1, 513, D, K, 4000, 1900 + i)[:2] for i in range(3)]
    long_ms = cuda_time(lambda y, a: cbmm_em_long(y, a, iterations=5),
                        ins[1:])
    long_plain = cuda_time(lambda y, a: cbmm_em_long_reference(
        y, a, iterations=5), ins[1:2])
    log(f'timing cbmm_em_long F=513 T=4000, 5 it: kernels {long_ms:.3f} ms, '
        f'plain {long_plain:.3f} ms')
    return out


def time_integration():
    """K10 per vMF pass at bench config 3 (F=513, T=300, D=6, K=3, E=20,
    random unit embeddings) and at B=8, K12 per 19-iteration vMF fit (the
    trainer's in-kernel iterations) at config 3, each against its twin,
    and K12 at B=8;
    and VMFCACGMMTrainer().fit at config 3 (20 iterations) through 'auto'
    (K10 + K1) and 'loop' (K12), in turns, host clock around synchronized
    fits, distinct inputs per repetition: the K12 : K10 ratio of a whole
    fit. Returns {kernel: (ms, plain_ms, bound)}."""
    import statistics
    import torch
    from pb_bss_tpu_torch.models import VMFCACGMMTrainer
    from pb_bss_tpu_torch.ops import integration_em_loop as il
    from pb_bss_tpu_torch.ops.integration_em import e_stats, e_stats_reference
    D, K, E, F, T = 6, 3, 20, 513, 300
    out = {}

    def stats(fn):
        return lambda y, emb, ev, vec, w, spec, sal: fn(
            y, emb, eigenvalues=ev, eigenvectors=vec, weight=w, mu=spec[0],
            kappa=spec[1], log_c=spec[2], bins_per_utt=F)

    def whole_fit(fn):
        return lambda y, emb, ev, vec, w, spec, sal: fn(
            y, emb, vec, ev, w, *spec, iterations=19, bins_per_utt=F)

    for B in (1, 8):
        ins = [integration_inputs(B * F, D, K, T, E, B, 'vmf', 2000 + 10 * B
                                  + i) for i in range(6)]
        ms = cuda_time(stats(e_stats), ins)
        plain = cuda_time(stats(e_stats_reference), ins[:3])
        log(f'timing K10 vmf pass B={B} F={F} D={D} K={K} T={T} E={E}: '
            f'kernel {ms:.4f} ms, plain {plain:.4f} ms')
        if B == 1:
            y, emb, ev, vec, w, spec, _ = ins[0]
            # y, the embedding and the model in; the scatter, the
            # affiliation sums and the resultants out
            moved = nbytes(y, emb, ev, vec, w, *spec) \
                + F * K * (8 * D * D + 4 + 4 * E)
            flops = integration_flops(F * T, K, D, E, 'vmf')
            out['integration_e_stats'] = (ms, plain, bound(moved, flops))
            ms12 = cuda_time(whole_fit(il.integration_em_full), ins[:4])
            plain12 = cuda_time(whole_fit(il.integration_em_full_reference),
                                ins[4:6], warmup=0)
            log(f'timing K12 vmf B=1 F={F} D={D} K={K} T={T} E={E}, 19 it: '
                f'kernel {ms12:.3f} ms (grid '
                f'{il.integration_em_full.last_grid}), plain {plain12:.3f} ms')
            # the inputs and the initial state in, the state and the
            # accumulators out; per iteration the E-step and its sums, the
            # warm rotation (16 D^3 a class), the Jacobi (6 sweeps, then 2)
            moved = 2 * nbytes(ev, vec, w) + nbytes(y, emb, *spec) \
                + K * (E + 1) * 4
            flops = 19 * (integration_flops(F * T, K, D, E, 'vmf')
                          + F * K * 16 * D ** 3) \
                + jacobi_flops(F * K, D, 6) + 18 * jacobi_flops(F * K, D, 2)
            out['integration_em_full'] = (ms12, plain12, bound(moved, flops))
        else:
            ms12 = cuda_time(whole_fit(il.integration_em_full), ins[:4])
            log(f'timing K12 vmf B={B} F={F} D={D} K={K} T={T} E={E}, 19 it: '
                f'kernel {ms12:.3f} ms (grid '
                f'{il.integration_em_full.last_grid})')

    fits = []
    for i in range(4):
        y, _, _ = em_inputs(1, F, D, K, T, 2200 + i)
        g = torch.Generator('cuda').manual_seed(2200 + i)
        emb = torch.randn((F, T, E), generator=g, device='cuda')
        fits.append((y[0].transpose(-1, -2),
                     emb / emb.norm(dim=-1, keepdim=True)))
    route_ms = {'auto': [], 'loop': []}
    for route in ('auto', 'loop', 'loop', 'auto'):
        VMFCACGMMTrainer().fit(*fits[0], num_classes=K, iterations=20,
                               use_fused_em=route)
        sync()
        for obs, emb in fits[1:]:
            t0 = time.perf_counter()
            VMFCACGMMTrainer().fit(obs, emb, num_classes=K, iterations=20,
                                   use_fused_em=route)
            sync()
            route_ms[route].append(1e3 * (time.perf_counter() - t0))
    ratio = statistics.median(route_ms['loop']) \
        / statistics.median(route_ms['auto'])
    log(f'timing VMFCACGMMTrainer.fit F={F} T={T} D={D} K={K} E={E}, 20 it '
        f"(host clock): 'auto' (K10 19 + K1 20) "
        f"{[round(t, 3) for t in route_ms['auto']]} ms, 'loop' (K12 1 + K1 "
        f"1) {[round(t, 3) for t in route_ms['loop']]} ms; median ratio "
        f'loop / auto {ratio:.3f}')
    for route in ('auto', 'loop'):
        prof, wall = profile_device(lambda: VMFCACGMMTrainer().fit(
            *fits[1], num_classes=K, iterations=20, use_fused_em=route))
        wall *= 1e3
        busy = device_times(prof, '')['all kernels'][0] / 1e3
        log(f'profile VMFCACGMMTrainer.fit({route!r}) F={F} T={T}: wall '
            f'{wall:.2f} ms (profiled), device busy {busy:.2f} ms, idle '
            f'share {1 - busy / wall:.3f}; device us (count) of the '
            f'integration kernels {device_times(prof, "integration")}, K1 '
            f'{device_times(prof, "eigh")}')
    return out


def time_estep():
    """K11 per launch against its twins: the E-step at F=513, T=300 and
    the scatter at the use_pallas_em slice shape F=257, T=304. Returns
    {kernel: (ms, plain_ms, bound)}."""
    from pb_bss_tpu_torch.ops import em_estep
    out = {}
    D, K = 6, 3
    for name, fn, ref, F, T in (
            ('e_step', em_estep.cacgmm_e_step,
             em_estep.cacgmm_e_step_reference, 513, 300),
            ('scatter', em_estep.cacgmm_em_scatter,
             em_estep.cacgmm_em_scatter_reference, 257, 304)):
        ins = [estep_inputs(F, D, K, T, 1000 + i) for i in range(6)]
        ms = cuda_time(fn, ins)
        plain = cuda_time(ref, ins[:3])
        inverse = F * K * 2 * D ** 2  # the scaled eigenbases
        if name == 'e_step':
            moved = nbytes(*ins[0]) + 2 * F * K * T * 4
            flops = em_flops(F * T, K, D, scatter=False) + inverse
        else:
            moved = nbytes(*ins[0]) + F * K * (2 * D * D + 1) * 4
            flops = em_flops(F * T, K, D) + inverse
        log(f'timing K11 {name} F={F} D={D} K={K} T={T}: kernel {ms:.4f} ms, '
            f'plain {plain:.4f} ms')
        out[name] = (ms, plain, bound(moved, flops))
    return out


def timed(phase, *args):
    """Run one phase, synchronize, and log its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    sync()
    log(f'{phase.__name__}: {time.perf_counter() - t0:.1f} s')
    return out


def main():
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument(
        '--only', default=None,
        help='comma-separated phases to run after the build instead of '
             'the whole smoke test (floor, splits, cacgmm, cbmm, cwmm, '
             'integration, e2e, eigh, integration_stats, '
             'eigh_stats_splits, gev_estep_splits, extraction_checks, '
             'extraction, streaming, surface, parallel, evaluation); '
             'prints no kernels line')
    parser.add_argument(
        '--package', default=None,
        help='import pb_bss_tpu_torch from this directory (with --only: '
             'another checkout, to time two versions in one call)')
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this smoke test needs '
             'a CUDA device')
    if args.package is not None:
        sys.path.insert(0, str(pathlib.Path(args.package).resolve()))
    if importlib.util.find_spec('pb_bss_tpu_torch') is None:
        sys.path.insert(0, str(ROOT))
        if importlib.util.find_spec('pb_bss_tpu_torch') is None:
            fail('pb_bss_tpu_torch not found: run from a checkout of the '
                 'repository')
    if args.only is not None:
        phases = {'floor': phase_floor, 'splits': time_em_splits,
                  'cacgmm': phase_kernels_cacgmm, 'cbmm': phase_kernels_cbmm,
                  'cwmm': phase_kernels_cwmm,
                  'integration': phase_kernels_integration_loop,
                  'e2e': time_e2e, 'eigh': phase_kernels_eigh,
                  'integration_stats': phase_kernels_integration_stats,
                  'eigh_stats_splits': time_eigh_stats_splits,
                  'gev_estep_splits': time_gev_estep_splits,
                  'extraction_checks': phase_extraction_checks,
                  'extraction': time_extraction,
                  'streaming': phase_streaming_checks,
                  'surface': phase_surface,
                  'parallel': phase_parallel_and_rest,
                  'evaluation': phase_evaluation}
        try:
            card = timed(phase_device)
            log('package:', importlib.util.find_spec(
                'pb_bss_tpu_torch').origin)
            timed(phase_build)
            for name in args.only.split(','):
                timed(phases[name])
        except SystemExit:
            raise
        except Exception:
            traceback.print_exc()
            fail('a phase raised')
        print(card)
        print(json.dumps({'ok': True, 'only': args.only}))
        return
    try:
        card = timed(phase_device)
        timed(phase_build)
        errors = timed(phase_kernels)
        timed(phase_floor)
        timed(phase_guards)
        launches = timed(phase_main_path)
        timed(phase_evaluation)
        timed(phase_extraction)
        timed(phase_fca)
        stream_launches_ = timed(phase_streaming)
        timed(phase_surface)
        parallel_launches = timed(phase_parallel_and_rest)
        long_launches = timed(phase_long)
        fc_launches = timed(phase_fc_path)
        cwmm_launches = timed(phase_cwmm)
        cbmm_launches = timed(phase_cbmm)
        integration_launches = timed(phase_integration)
        kernels = timed(phase_timing, errors, launches, long_launches,
                        fc_launches, cwmm_launches, cbmm_launches,
                        integration_launches, stream_launches_,
                        parallel_launches)
        timed(time_fc_stages)
        timed(time_streaming)
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        fail('a phase raised')
    log(f'profiler: {len(EMPTY_CAPTURES)} captures stayed empty through '
        'their attempts (their device times nan; a kernel\'s time per '
        'launch from CUDA events around its calls)')
    if 'jax' in sys.modules:
        fail('jax was imported')
    if any(not math.isfinite(k[f]) for k in kernels
           for f in ('max_abs_err', 'ms', 'plain_ms', 'bound_ms')):
        fail(f'non-finite kernel result: {kernels}')
    unlaunched = [k['name'] for k in kernels if k['launches'] < 1]
    if unlaunched:
        fail(f'kernels never launched on their paths: {unlaunched}')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
