"""The hand-written CUDA kernels against their plain PyTorch twins on a
card. Marked ``gpu``; each test skips when no CUDA device is present
(decided inside the fixture, never at import). Run on a GPU machine
with ``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu``
(the shared conftest imports jax)."""
import pytest
import torch

from pb_bss_tpu_torch.ops.em_loop import (
    cacgmm_em_full,
    cacgmm_em_full_reference,
)
from pb_bss_tpu_torch.ops.gev import gev, gev_reference

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernels have no CPU mode)')
    return torch.device('cuda')


def _unit_norm_mixture(F, D, K, T, device):
    g = torch.Generator(device).manual_seed(0)
    y = torch.randn((F, D, T), dtype=torch.complex64, device=device,
                    generator=g)
    y = y / torch.linalg.vector_norm(y, dim=-2, keepdim=True)
    aff = torch.rand((F, K, T), device=device, generator=g)
    return y, aff / aff.sum(-2, keepdim=True)


@pytest.mark.parametrize('D,K,T', [(6, 3, 304), (4, 2, 37), (8, 4, 150)])
def test_em_kernel_one_iteration_matches_plain(cuda, D, K, T):
    y, aff = _unit_norm_mixture(33, D, K, T, cuda)
    qf = torch.ones_like(aff)
    before = cacgmm_em_full.launches
    out = cacgmm_em_full(y, aff, qf, iterations=1, warm_sweeps=2)
    torch.cuda.synchronize()
    assert cacgmm_em_full.launches == before + 1
    ref = cacgmm_em_full_reference(y, aff, qf, iterations=1)
    # one cold iteration: f32 rounding of two Jacobi/E-step orderings
    torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(out[1], ref[1], atol=1e-4, rtol=0)
    torch.testing.assert_close(out[3], ref[3], atol=2e-3, rtol=0)


def test_gev_kernel_matches_plain(cuda):
    g = torch.Generator(cuda).manual_seed(1)
    a = torch.randn((300, 6, 6), dtype=torch.complex64, device=cuda,
                    generator=g)
    eye = torch.eye(6, dtype=torch.complex64, device=cuda)
    phi_xx = a @ a.conj().transpose(-1, -2) + 0.1 * eye
    phi_nn = a.transpose(-1, -2) @ a.conj() + 0.5 * eye
    phi_nn[7] = 0  # not positive definite: non-finite in both
    out = gev(phi_xx, phi_nn)
    ref = gev_reference(phi_xx, phi_nn)
    torch.cuda.synchronize()
    ok = torch.isfinite(out.abs()).all(-1)
    assert torch.equal(ok, torch.isfinite(ref.abs()).all(-1))
    assert not ok[7] and int(ok.sum()) == 299
    inner = torch.einsum('bd,bd->b', ref[ok].conj(), out[ok])
    aligned = out[ok] / (inner / inner.abs())[:, None]
    torch.testing.assert_close(aligned, ref[ok], atol=1e-4, rtol=0)


def test_trainer_routes_to_the_kernel_on_cuda(cuda):
    """'auto' on a CUDA tensor launches the whole-fit kernel once; its
    final (unclipped) E-step is the model's predict up to f32 rounding of
    the two quadratic-form evaluations."""
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer
    g = torch.Generator(cuda).manual_seed(2)
    Y = torch.randn((65, 200, 6), dtype=torch.complex64, device=cuda,
                    generator=g)
    before = cacgmm_em_full.launches
    model, aff = CACGMMTrainer().fit_predict_model(
        Y, num_classes=3, iterations=10)
    torch.cuda.synchronize()
    assert cacgmm_em_full.launches == before + 1
    agree = (aff.argmax(-2) == model.predict(Y).argmax(-2)).float().mean()
    assert agree > 0.98, agree
