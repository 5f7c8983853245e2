"""The check at a cell's own size on the card: the system passes and
the control fails (the reference in TF32 in the system's place, or,
for a driver without one, the system with its own TF32 switch on). Marked ``gpu``;
each test skips without a CUDA device (decided inside the test). Run on
a GPU machine with ``python -m pytest sepbench/tests -m gpu``."""
from __future__ import annotations

import pytest
import torch

from small import ROOT  # noqa: F401  (puts the repository on the path)
from sepbench.harness import readings, runner

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize('name', ['utt.b512', 'minute.b64', 'score.b512'])
def test_system_passes_and_control_fails_at_full_size(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    cell = runner.Cell(name)
    runner.set_cache_dirs()
    runner.import_program()
    runner.build(cell.spec['kernels'])
    device = torch.device('cuda')
    limits = cell.spec['limits']
    program = readings.program(cell, 2 ** 31 + 77, 1, torch, device)
    assert all(program[n] <= limit for n, limit in limits.items()), program
    driver = runner.load_module('drivers', cell.spec['driver'])
    if hasattr(driver.Driver, 'control'):
        control = readings.control(cell, 2 ** 31 + 77, 1, torch, device)
    else:
        control = readings.program(cell, 2 ** 31 + 77, 1, torch, device,
                                   tf32=True)
    assert any(control[n] > limit for n, limit in limits.items()), control
