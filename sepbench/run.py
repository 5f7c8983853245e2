"""The benchmark of pb_bss_tpu_torch on NVIDIA GPUs.

    python3 sepbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one workload of ``BENCHMARK.json`` from the root of a checkout:
builds the cell's kernels, makes its inputs from ``--seed``, warms up,
then drives the system back to back for ``--seconds`` and checks a
sample of what the window produced against the plain reference under
``sepbench/reference``. With ``--trace 0`` it reports the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled stretch at the start of the window. The last line of standard
output is the result as one JSON object; the numbers compared and their
limits are the last lines of standard error. Exits non-zero, printing no
result, without enough CUDA devices, without the system under test in
the checkout, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sepbench.harness import device as device_info  # noqa: E402

PROCESS_START = device_info.process_start()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from sepbench.harness import runner
    try:
        cell = runner.Cell(args.workload)
        runner.set_cache_dirs()
        import torch
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            raise runner.Failure(
                2, f'{args.workload} needs {cell.chips} CUDA device(s); '
                   f'torch sees {torch.cuda.device_count()}')
        result = runner.run(
            cell, args.seed, args.seconds, bool(args.trace), torch=torch,
            device=torch.device('cuda'), process_start=PROCESS_START,
            log=lambda line: print(line, file=sys.stderr, flush=True))
    except runner.Failure as failure:
        print(f'sepbench: {failure}', file=sys.stderr, flush=True)
        return failure.code
    checks = result['checks']
    for name, row in checks.items():
        print(f'{name} {row["value"]!r} limit {row["limit"]!r}',
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
