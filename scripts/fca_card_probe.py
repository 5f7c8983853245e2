"""The FCA-refined separation of the benchmark's ``utt.b256.fca`` cell
(``separate_batch(refine='fca')``) on one CUDA card: a sweep of the
batch, and a probe of the refinement's solves. Imports no JAX.

    python3 scripts/fca_card_probe.py --seed 1234 \
        --batches 64,128,256,512 --seconds 8 --probe 256

``--batches``: for each batch the cell's driver and traffic generator
(its ``pool_batches`` distinct batches kept on the card), one warm-up
call, then calls back to back for ``--seconds``; one JSON line with the
audio seconds separated per second, the mean call ms and the peak of
allocated memory (the pool included, as a run's ``memory_peak_bytes``).

``--probe B``: one call at batch B, outside any timing, with each
system of ``stable_solve`` in the refinement counted where its float32
gate took the pseudo-inverse (its answer is not the LU solution bit for
bit), apart for the IP rows and the back-transform's inverse, and the
least normalized spatial spectrum the fit returns against the
eigenvalue floor. One JSON line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sepbench.harness import runner, spans  # noqa: E402

CELL = 'utt.b256.fca'


def _driver(torch, batch, seed):
    cell = runner.Cell(CELL)
    cell.traffic = dict(cell.traffic, batch=batch)
    driver = runner.make_driver(cell, seed, torch, torch.device('cuda'))
    driver.setup()
    wrappers = spans.Wrappers()
    driver.install(wrappers)
    return driver, wrappers


def sweep(torch, batch, seed, seconds):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    driver, wrappers = _driver(torch, batch, seed)
    try:
        driver.call(-1)
        torch.cuda.synchronize()
        times = []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            t0 = time.perf_counter()
            driver.call(len(times))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        wrappers.close()
    return {'batch': batch, 'calls': len(times),
            'audio_s_per_s': driver.work_per_call() * len(times)
            / sum(times),
            'call_ms': 1e3 * sum(times) / len(times),
            'peak_gb': torch.cuda.max_memory_allocated() / 1e9}


def probe(torch, batch, seed):
    from pb_bss_tpu_torch.models import _precision, fca
    solve, fit = fca.stable_solve, fca._fca_fit
    taken = {'ip_rows': [0, 0], 'inverse': [0, 0]}
    spectra = []

    def counted(a, b, **kwargs):
        x = solve(a, b, **kwargs)
        with _precision.full_fp32():
            lu, _ = torch.linalg.solve_ex(a, b, check_errors=False)
        pinv = (x != lu).flatten(-2).any(-1)
        kind = taken['inverse' if b.shape[-1] == b.shape[-2] else 'ip_rows']
        kind[0] += int(pinv.sum())
        kind[1] += pinv.numel()
        return x

    def kept(*args, **kwargs):
        out = fit(*args, **kwargs)
        spectra.append((out[1].min().item(),
                        kwargs['eigenvalue_floor'],
                        int((out[1] <= kwargs['eigenvalue_floor']).sum())))
        return out

    driver, wrappers = _driver(torch, batch, seed)
    fca.stable_solve, fca._fca_fit = counted, kept
    try:
        driver.call(0)
        torch.cuda.synchronize()
    finally:
        fca.stable_solve, fca._fca_fit = solve, fit
        wrappers.close()
    [(least, floor, at_floor)] = spectra
    return {'batch': batch, 'probe': 'solves',
            **{f'{k}_pinv': v[0] for k, v in taken.items()},
            **{f'{k}_systems': v[1] for k, v in taken.items()},
            'least_spectrum': least, 'eigenvalue_floor': floor,
            'spectra_at_floor': at_floor}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--batches', default='')
    parser.add_argument('--seconds', type=float, default=8.0)
    parser.add_argument('--probe', type=int, default=0)
    args = parser.parse_args(argv)
    runner.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print('fca_card_probe: needs a CUDA device', file=sys.stderr)
        return 2
    runner.import_program()
    runner.build(runner.Cell(CELL).spec['kernels'])
    for batch in [int(b) for b in args.batches.split(',') if b]:
        print(json.dumps(sweep(torch, batch, args.seed, args.seconds)),
              flush=True)
    if args.probe:
        print(json.dumps(probe(torch, args.probe, args.seed)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
