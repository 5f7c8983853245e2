"""The check of the FCA cell at its own size on the card: the system
passes, the control (the reference in TF32 in the system's place) fails
``fca_gap``, and the system with DHTV's choice swapped in a band of
more than a tenth of the bins fails ``mask_gap``. Each prints its
numbers as a JSON line (``-s`` shows them). Marked ``gpu``; the tests
skip without a CUDA device (decided inside the test). Run on a GPU
machine with ``python -m pytest sepbench/tests -m gpu``."""
from __future__ import annotations

import json

import pytest
import torch

from small import ROOT  # noqa: F401  (puts the repository on the path)
from sepbench.harness import readings, runner

pytestmark = pytest.mark.gpu

SEED = 2 ** 31 + 77


def swap_a_band(calculate_mapping):
    """DHTV's mapping with classes 0 and 1 swapped in the upper 15% of
    the bins: a fault in more than a tenth of the bins."""
    def swapped(self, mask):
        mapping = calculate_mapping(self, mask).clone()  # (*B, K, F)
        band = slice(int(0.85 * mapping.shape[-1]), None)
        mapping[..., [0, 1], band] = mapping[..., [1, 0], band]
        return mapping
    return swapped


@pytest.fixture(scope='module')
def cell():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    cell = runner.Cell('utt.b256.fca')
    runner.set_cache_dirs()
    runner.import_program()
    runner.build(cell.spec['kernels'])
    return cell


def _failed(kind, numbers, limits):
    print(json.dumps({'workload': 'utt.b256.fca', 'kind': kind,
                      'seed': SEED, 'numbers': numbers}), flush=True)
    return [n for n, limit in limits.items() if not numbers[n] <= limit]


def test_system_passes_and_control_fails_at_full_size(cell):
    device = torch.device('cuda')
    limits = cell.spec['limits']
    program = readings.program(cell, SEED, 1, torch, device)
    assert not _failed('program', program, limits), program
    control = readings.control(cell, SEED, 1, torch, device)
    assert 'fca_gap' in _failed('control', control, limits), control


def test_a_dhtv_fault_in_a_band_of_bins_fails_mask_gap(cell, monkeypatch):
    from pb_bss_tpu_torch.permutation_alignment import \
        DHTVPermutationAlignment as DHTV
    monkeypatch.setattr(DHTV, 'calculate_mapping',
                        swap_a_band(DHTV.calculate_mapping))
    numbers = readings.program(cell, SEED, 1, torch, torch.device('cuda'))
    assert _failed('dhtv_band', numbers, cell.spec['limits']) \
        == ['mask_gap'], numbers
