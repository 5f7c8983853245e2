"""The check of the benchmark's FCA cell (``utt.b256.fca``, driver
``sepbench/drivers/separate_batch_fca.py``) on the CPU, the cell cut to
one recording of 1 s and 6 EM iterations with its limits as they are:
the program reads correct; the reference in TF32 in its place (the
control) does not, and neither does the program with a fault planted
in the refinement: an IP row skipped, the MU of the spatial spectra
skipped, or one class's output zeroed in more than a tenth of its
bins; nor the program with DHTV's choice swapped in a band of more
than a tenth of the bins, which ``mask_gap`` alone sees. The eigenvalue floor never binds on this traffic, so dropping it
leaves every output as it was (where it binds, the reference sees it:
``tests/test_torch_fca_reference.py``).

The numbers come from ``sepbench.harness.readings``, the driver and
check a run uses, without the run's look for a card and for JAX."""
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
for path in (ROOT, ROOT / 'sepbench' / 'tests'):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from pb_bss_tpu_torch.models import fca  # noqa: E402
from sepbench.harness import readings, traffic  # noqa: E402
from small import cell  # noqa: E402
from test_sepbench_card_fca import swap_a_band  # noqa: E402

torch.set_num_threads(2)

SEED = 2 ** 31 + 4321
CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def small():
    return cell('utt.b256.fca', batch=1, samples=8000)


def _failed(numbers, limits):
    return [name for name, limit in limits.items()
            if not numbers[name] <= limit]


def _program(small):
    return readings.program(small, SEED, 1, torch, CPU)


def test_the_program_reads_correct(small):
    numbers = _program(small)
    assert not _failed(numbers, small.spec['limits']), numbers


def test_the_control_reads_not_correct(small):
    numbers = readings.control(small, SEED, 1, torch, CPU)
    assert 'fca_gap' in _failed(numbers, small.spec['limits']), numbers


def _skip_a_row(original):
    def update(q, products, sigma2):
        return torch.cat([q[:, :1], original(q, products, sigma2)[:, 1:]],
                         1)
    return update


def _fit_without_the_spectra_mu(y, q, lam, v, *, iterations, q_iterations,
                                eigenvalue_floor):
    """The refinement's fit with the MU of lambda left out."""
    products = fca._FrameProducts(y)
    for _ in range(iterations):
        p, _ = fca._transformed_power(q, y)
        sigma2 = fca._sigma2(v, lam)
        num = torch.einsum('fkd,fdt->fkt', lam, p / sigma2 ** 2)
        den = torch.einsum('fkd,fdt->fkt', lam, 1.0 / sigma2)
        v = v * torch.sqrt(num / (den + fca._EPS)) + fca._EPS
        scale = lam.mean(-1, keepdim=True)
        lam = torch.clamp(lam / scale, min=eigenvalue_floor)
        v = v * scale
        sigma2 = fca._sigma2(v, lam)
        for _ in range(q_iterations):
            q = fca._ip_update(q, products, sigma2)
    return q, lam, v


def _zero_a_class(original):
    def separate(self, y):
        images = original(self, y).clone()  # (F, K, T, D)
        images[int(0.85 * images.shape[0]):, 0] = 0
        return images
    return separate


@pytest.mark.parametrize('fault', ['ip_row', 'spectra_mu', 'class_zeroed'])
def test_a_fault_in_the_refinement_reads_not_correct(small, monkeypatch,
                                                     fault):
    if fault == 'ip_row':
        monkeypatch.setattr(fca, '_ip_update', _skip_a_row(fca._ip_update))
    elif fault == 'spectra_mu':
        monkeypatch.setattr(fca, '_fca_fit', _fit_without_the_spectra_mu)
    else:
        monkeypatch.setattr(fca.FCA, 'separate',
                            _zero_a_class(fca.FCA.separate))
    numbers = _program(small)
    assert _failed(numbers, small.spec['limits']) == ['fca_gap'], numbers


def test_a_dhtv_fault_in_a_band_of_bins_reads_not_correct(small,
                                                         monkeypatch):
    from pb_bss_tpu_torch.permutation_alignment import \
        DHTVPermutationAlignment as DHTV
    monkeypatch.setattr(DHTV, 'calculate_mapping',
                        swap_a_band(DHTV.calculate_mapping))
    numbers = _program(small)
    assert _failed(numbers, small.spec['limits']) == ['mask_gap'], numbers
    # of the order of one, where the limit is a tenth
    assert numbers['mask_gap'] > 0.5, numbers


def test_the_floor_does_not_bind_on_this_traffic(small, monkeypatch):
    from pb_bss_tpu_torch import separate_batch
    observations = torch.as_tensor(
        traffic.pool(small.config, small.traffic, SEED))[0]
    fit, spectra = fca._fca_fit, []

    def spy(*args, **kwargs):
        out = fit(*args, **kwargs)
        spectra.append(out[1])
        return out

    def run(floor):
        monkeypatch.setattr(fca, '_fca_fit', lambda *a, **k: spy(
            *a, **dict(k, eigenvalue_floor=floor)))
        return separate_batch(observations, iterations=6, refine='fca',
                              generator=torch.Generator().manual_seed(1))
    sound = run(1e-6)
    assert spectra[0].min() > 100 * 1e-6
    assert torch.equal(run(0.0), sound)
