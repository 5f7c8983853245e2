"""Cells cut to a size the CPU tests hold: two utterances a batch and
a few EM iterations; the check and its limits are the cell's own."""
from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from sepbench.harness import runner  # noqa: E402


def cell(name='utt.b512', iterations=6, batch=2, **config):
    """The workload ``name`` with a small batch, pool and EM."""
    out = runner.Cell(name)
    out.traffic = dict(out.traffic, batch=batch, pool_batches=1)
    out.config = dict(out.config, iterations=iterations, **config)
    return out
