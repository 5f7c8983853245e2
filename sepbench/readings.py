"""Readings behind a cell's limits, in one process.

    python3 sepbench/readings.py --workload utt.b512 --seeds 1,2,3 \
        [--control-seeds 7,8,9] [--program-tf32-seeds 7,8,9] [--calls 2]

Prints one JSON line per seed and kind: the numbers a run's check
compares, for the system (``program``), for the reference in TF32 in
its place (``control``) and for the system with its own TF32 switch on
(``program_tf32``). Runs on the card; the cell's kernels are built
once.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from sepbench.harness import readings, runner  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(',') if s]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=_seeds, default=[])
    parser.add_argument('--control-seeds', type=_seeds, default=[])
    parser.add_argument('--program-tf32-seeds', type=_seeds, default=[])
    parser.add_argument('--calls', type=int, default=None)
    args = parser.parse_args(argv)
    cell = runner.Cell(args.workload)
    runner.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print('sepbench: readings need a CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda')
    runner.import_program()
    runner.build(cell.spec['kernels'])
    calls = args.calls or cell.spec['check_calls']
    jobs = ([('program', s) for s in args.seeds]
            + [('control', s) for s in args.control_seeds]
            + [('program_tf32', s) for s in args.program_tf32_seeds])
    for kind, seed in jobs:
        start = time.perf_counter()
        if kind == 'control':
            numbers = readings.control(cell, seed, calls, torch, device)
        else:
            numbers = readings.program(cell, seed, calls, torch, device,
                                       tf32=kind == 'program_tf32')
        print(json.dumps({'workload': cell.name, 'kind': kind, 'seed': seed,
                          'calls': calls, 'numbers': numbers,
                          'seconds': time.perf_counter() - start}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
