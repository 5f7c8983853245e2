"""The port's FCA refinement (``pb_bss_tpu_torch.models.fca``) against
the benchmark's plain float64 reference (``sepbench/reference/fca.py``)
on seeded random mixtures at a small size (F=9, T=100, D=6, K=3): one
MU + IP iteration from the same start, a 20-iteration fit and its
Wiener images by the per-bin quantile that the benchmark's ``fca_gap``
reads, a batch folded into the bins against one utterance at a time,
and the eigenvalue floor, which the reference holds and whose absence
the comparison sees where the floor binds."""
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pb_bss_tpu_torch.models.fca import FCATrainer  # noqa: E402
from sepbench.harness import runner  # noqa: E402
from sepbench.reference import fca as reference  # noqa: E402

torch.set_num_threads(2)

DRIVER = runner.load_module('drivers', 'separate_batch_fca')
LIMIT = runner.Cell('utt.b256.fca').spec['limits']['fca_gap']


def _mixture(seed, F=9, T=100, D=6, K=3, noise=0.1):
    """K point sources (a random mixing vector a bin) active in random
    frames, plus white noise: (F, T, D) complex128 and the activity masks
    (F, K, T) float64 the fit starts from."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.complex(torch.randn(*shape, generator=g,
                                         dtype=torch.float64),
                             torch.randn(*shape, generator=g,
                                         dtype=torch.float64))
    active = (torch.rand(K, T, generator=g, dtype=torch.float64)
              < 0.6).to(torch.float64)
    y = (normal(F, D, K) @ (normal(F, K, T) * active)).transpose(-1, -2) \
        + noise * normal(F, T, D)
    masks = active + 0.05 * torch.rand(F, K, T, generator=g,
                                       dtype=torch.float64)
    return y, masks / masks.sum(1, keepdim=True)


def _program(y, masks, iterations, **kwargs):
    return FCATrainer(**kwargs).fit(y, initialization=masks,
                                    iterations=iterations)


def _reference(y, masks, iterations):
    """(Q, lambda, v) and the Wiener images (F, K, T) at channel 0."""
    yt = y.transpose(-1, -2).to(torch.complex128)
    model = reference.fit(yt, masks.to(torch.float64), iterations)
    return model, reference.images(*model, yt, 0)


def _gap(images, want):
    """``fca_gap`` of images (F, K, T) against the reference's."""
    return DRIVER.fca_gap(images.permute(1, 2, 0)[None],
                          want.permute(1, 2, 0)[None])[0]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_one_iteration_from_the_same_start(seed):
    """float32 program, float64 reference. The powers and spectra are
    float32 rounding (~1e-7) carried through a few products and square
    roots: 1e-5. The diagonalizer's rows are IP solves of systems with
    condition numbers up to ~1e2-1e3 here, which multiply the rounding:
    1e-4 of the largest entry of a bin's Q."""
    y, masks = _mixture(seed)
    ours = _program(y.to(torch.complex64), masks.to(torch.float32), 1)
    (q, lam, v), _ = _reference(y, masks, 1)
    torch.testing.assert_close(ours.eigenvalue.double(), lam, rtol=1e-5,
                               atol=1e-5)
    scale = v.abs().amax(-1, keepdim=True)
    assert ((ours.power.double() - v).abs() / scale).max() < 1e-5
    q_scale = q.abs().amax((-1, -2), keepdim=True)
    assert ((ours.diagonalizer.to(torch.complex128) - q).abs()
            / q_scale).max() < 1e-4


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_twenty_iterations_and_separate_by_the_per_bin_quantile(seed):
    """The refinement's 20 iterations and the back-transform in float32
    against the float64 reference, read as the benchmark reads them;
    below the cell's limit and, without the bins' IP systems going
    near-singular here, at float32 rounding (3-10e-6 measured)."""
    y, masks = _mixture(seed)
    ours = _program(y.to(torch.complex64), masks.to(torch.float32), 20)
    images = ours.separate(y.to(torch.complex64))[..., 0]  # (F, K, T)
    _, want = _reference(y, masks, 20)
    gap = _gap(images, want)
    assert gap < LIMIT and gap < 1e-4, gap


def test_a_batch_folded_into_the_bins_equals_one_at_a_time():
    """Three utterances folded into 27 bins fit and separate as each
    alone, in the program and in the reference: the bins are
    independent. The batched products and solves may block differently
    at another batch, so the two part by rounding carried over 20
    iterations: in float32 by the benchmark's per-bin quantile, below
    1e-4 (each of the two fits lies 3-10e-6 from the float64 reference,
    and they part by up to 1.5e-5), in float64 to 1e-9."""
    pairs = [_mixture(seed) for seed in (3, 4, 5)]
    y = torch.cat([p[0] for p in pairs])
    masks = torch.cat([p[1] for p in pairs])
    c64 = y.to(torch.complex64)
    folded = _program(c64, masks.float(), 20)
    folded_images = folded.separate(c64)
    _, folded_want = _reference(y, masks, 20)
    for i, (y_i, m_i) in enumerate(pairs):
        rows = slice(9 * i, 9 * i + 9)
        alone = _program(y_i.to(torch.complex64), m_i.float(), 20)
        gap = _gap(folded_images[rows][..., 0],
                   alone.separate(y_i.to(torch.complex64))[..., 0])
        assert gap < 1e-4, gap
        _, want = _reference(y_i, m_i, 20)
        torch.testing.assert_close(folded_want[rows], want, rtol=1e-9,
                                   atol=1e-12 * want.abs().max())


def test_the_floor_where_it_binds():
    """With less noise and fewer frames, 3-9% of the normalized spatial
    spectra reach the floor of 1e-6 within 20 iterations. The program in
    float64 follows the reference to rounding (~1e-11); without its floor
    it reads far above the cell's limit. (On the cell's own traffic the
    floor never binds: see ``tests/test_torch_fca_check.py``.)"""
    y, masks = _mixture(0, T=40, noise=0.01)
    (_, lam, _), want = _reference(y, masks, 20)
    assert (lam <= 1.0001e-6).float().mean() > 0.02
    sound = _program(y, masks, 20)
    assert _gap(sound.separate(y)[..., 0], want) < 1e-8
    floorless = _program(y, masks, 20, eigenvalue_floor=0.0)
    assert _gap(floorless.separate(y)[..., 0], want) > 100 * LIMIT
