"""The hand-written CUDA kernels against their plain PyTorch twins on a
card. Marked ``gpu``; each test skips when no CUDA device is present
(decided inside the fixture, never at import). Run on a GPU machine
with ``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu``
(the shared conftest imports jax)."""
import numpy as np
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


def _hermitian(B, D, dtype, device, seed):
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn((B, D, D), device=device, generator=g)
    if dtype == torch.complex64:
        x = torch.complex(x, torch.randn((B, D, D), device=device,
                                         generator=g))
    return x @ x.conj().transpose(-1, -2) / D


@pytest.mark.parametrize('kind', ['random', 'tiny', 'nan'])
@pytest.mark.parametrize('sort', [True, False])
@pytest.mark.parametrize('dtype', [torch.complex64, torch.float32])
@pytest.mark.parametrize('D', [1, 2, 3, 6, 8, 16])
def test_eigh_kernel_matches_plain(cuda, D, dtype, sort, kind):
    """K1 against its twin, sorted in the kernel or not. 'tiny' scales the
    batch by 1e-20 (held relative to the scale); 'nan' holds a NaN matrix
    and a matrix with one NaN entry, whose NaN eigenvalues come last while
    the other matrices match the twin."""
    from pb_bss_tpu_torch.ops.eigh import eigh_jacobi, eigh_jacobi_reference
    scale = 1e-20 if kind == 'tiny' else 1.
    a = _hermitian(771, D, dtype, cuda, seed=D)
    a[:4] = torch.eye(D, dtype=dtype, device=cuda)
    a = a * scale
    keep = torch.ones(771, dtype=torch.bool, device=cuda)
    if kind == 'nan':
        a[7] = float('nan')
        a[9, 0, 0] = float('nan')
        keep[[7, 9]] = False
    before = eigh_jacobi.launches
    w_o, v_o = eigh_jacobi(a, sort=sort)
    torch.cuda.synchronize()
    assert eigh_jacobi.launches == before + 1
    w, v = eigh_jacobi(a) if not sort else (w_o, v_o)
    if not sort:
        # the Jacobi's order: the sorted call is the unsorted one stably
        # sorted, bit for bit (the twin's unsorted order can part from it
        # where a sweep meets a near tie, so the twin is held sorted)
        order = torch.sort(w_o, dim=-1, stable=True).indices

        def same(x, y):
            return ((x == y) | (torch.isnan(x) & torch.isnan(y))).all()

        assert same(torch.gather(w_o, -1, order), w)
        assert same(torch.gather(v_o, -1, order[:, None].expand_as(v_o)), v)
    w_p, _ = eigh_jacobi_reference(a)
    assert v.dtype == dtype and w.dtype == torch.float32
    # two f32 Jacobi runs of the same rotations: within 2e-5 of the
    # largest eigenvalue; the factorization within 1e-4
    wk, wp, vk, ak = w[keep] / scale, w_p[keep] / scale, v[keep], \
        a[keep] / scale
    lam_max = wp.abs().max(-1, keepdim=True).values
    assert ((wk - wp).abs() <= 2e-5 * lam_max).all()
    recon = vk @ torch.diag_embed(wk).to(dtype) @ vk.conj().transpose(-1, -2)
    assert ((recon - ak).abs().amax((-2, -1))
            <= 1e-4 * ak.abs().amax((-2, -1))).all()
    eye = torch.eye(D, dtype=dtype, device=cuda)
    assert torch.equal(v_o[:4], eye.expand(4, D, D))
    assert torch.equal(w_o[:4], torch.full((4, D), scale, device=cuda))
    if kind == 'nan':
        nan = torch.isnan(w[[7, 9]])
        assert torch.equal(nan, torch.isnan(w_p[[7, 9]]))
        assert (nan.int().diff(dim=-1) >= 0).all()  # NaN last
        assert torch.equal(v_o[7], eye)


def test_eigh_kernel_sorts_in_the_kernel(cuda, monkeypatch):
    """K1's CUDA call is the kernel alone: no torch.sort, torch.gather or
    sort_ascending after it."""
    from pb_bss_tpu_torch.ops import eigh, linalg
    a = _hermitian(3084, 6, torch.complex64, cuda, seed=5)
    w_p, v_p = eigh.eigh_jacobi_reference(a)

    def refuse(*args, **kwargs):
        raise AssertionError('the CUDA call sorted outside the kernel')

    for module, name in ((torch, 'sort'), (torch, 'gather'),
                         (torch, 'argsort'), (linalg, 'sort_ascending')):
        monkeypatch.setattr(module, name, refuse)
    w, v = eigh.eigh_jacobi(a)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert (w.diff(dim=-1) >= 0).all()
    lam_max = w_p.abs().max(-1, keepdim=True).values
    assert ((w - w_p).abs() <= 2e-5 * lam_max).all()


@pytest.mark.parametrize('mode', ['from_init', 'model'])
def test_stream_kernel_one_pass_matches_plain(cuda, mode):
    from pb_bss_tpu_torch.ops.em_stream import (
        cacgmm_em_long_reference, e_stats, e_stats_reference)
    N, D, K, T = 65, 6, 3, 1777
    y, aff = _unit_norm_mixture(N, D, K, T, cuda)
    qf = torch.ones_like(aff)
    if mode == 'from_init':
        kwargs = dict(affiliation=aff, quadratic_form=qf)
    else:
        weight, ev, vec = cacgmm_em_long_reference(y, aff, qf, iterations=1)
        kwargs = dict(eigenvalues=ev, eigenvectors=vec, weight=weight,
                      affiliation_eps=1e-10)
    before = e_stats.launches
    s_k, a_k = e_stats(y, **kwargs)
    torch.cuda.synchronize()
    assert e_stats.launches == before + 1
    s_p, a_p = e_stats_reference(y, **kwargs)
    # f32 sums over T in two orders (and, in model mode, two formulas
    # for the quadratic form): 1e-4 of the largest entry
    assert (s_k - s_p).abs().max() <= 1e-4 * s_p.abs().max()
    torch.testing.assert_close(a_k, a_p, rtol=1e-4, atol=0)


def test_long_fit_routes_to_the_stream_and_eigh_kernels(cuda):
    """T=3300 is past the whole-fit gate at D=6, K=3: 'auto' runs one
    streamed statistics launch and one Jacobi launch per iteration and
    never the whole-fit kernel."""
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer
    from pb_bss_tpu_torch.ops.eigh import eigh_jacobi
    from pb_bss_tpu_torch.ops.em_stream import e_stats
    g = torch.Generator(cuda).manual_seed(3)
    Y = torch.randn((65, 3300, 6), dtype=torch.complex64, device=cuda,
                    generator=g)
    before = (cacgmm_em_full.launches, e_stats.launches, eigh_jacobi.launches)
    model = CACGMMTrainer().fit(Y, num_classes=3, iterations=5)
    torch.cuda.synchronize()
    after = (cacgmm_em_full.launches, e_stats.launches, eigh_jacobi.launches)
    assert after == (before[0], before[1] + 5, before[2] + 5)
    assert torch.isfinite(model.cacg.covariance_eigenvalues).all()


def _lam_close(ev_k, ev_p, rel):
    """Eigenvalues within ``rel`` of each matrix's largest."""
    lam_max = ev_p.abs().max(-1, keepdim=True).values
    return bool(((ev_k - ev_p).abs() <= rel * lam_max).all())


def _covariance(vec, ev):
    return vec @ torch.diag_embed(ev).to(vec.dtype) \
        @ vec.conj().transpose(-1, -2)


@pytest.mark.parametrize('extras', [False, True], ids=['plain', 'sal+mask'])
def test_fc_kernels_one_step_match_plain(cuda, extras):
    """K5's init and step kernels against their twins, one launch each,
    at D=6; with saliency and a mask that silences a class in some bins
    (the 0 * inf hazard at D >= 5)."""
    from pb_bss_tpu_torch.ops import em_step
    B, F, D, K, T = 2, 33, 6, 3, 304
    y, aff = _unit_norm_mixture(B * F, D, K, T, cuda)
    qf = torch.ones_like(aff)
    g = torch.Generator(cuda).manual_seed(5)
    sal = mask = None
    if extras:
        sal = 0.2 + 0.8 * torch.rand((B * F, T), device=cuda, generator=g)
        mask = torch.ones((B * F, K, T), device=cuda)
        mask[3:9, 1] = 0
    before = (em_step.m_init.launches, em_step.em_step.launches)
    init = dict(sweeps=6, eigenvalue_floor=1e-10, saliency=sal)
    vec_k, ev_k, asum_k = em_step.m_init(y, aff, qf, **init)
    vec_p, ev_p, asum_p = em_step.m_init_reference(y, aff, qf, **init)
    weight = asum_p.reshape(B, F, K).sum(1)
    weight = weight / weight.sum(-1, keepdim=True)
    step = dict(warm_sweeps=2, eigenvalue_floor=1e-10,
                affiliation_eps=0. if extras else 1e-10, saliency=sal,
                source_activity_mask=mask, emit_affiliation=True)
    out_k = em_step.em_step(y, ev_p, vec_p, weight, **step)
    out_p = em_step.em_step_reference(y, ev_p, vec_p, weight, **step)
    torch.cuda.synchronize()
    assert (em_step.m_init.launches, em_step.em_step.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(asum_k, asum_p, rtol=1e-4, atol=0)
    torch.testing.assert_close(out_k[2], out_p[2], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(out_k[3], out_p[3], atol=2e-3, rtol=0)
    for (vk, ek), (vp, ep) in (((vec_k, ev_k), (vec_p, ev_p)),
                               ((out_k[0], out_k[1]), (out_p[0], out_p[1]))):
        assert bool(torch.isfinite(ek).all() and torch.isfinite(vk).all())
        # two f32 Jacobi runs and two E-step formulas: 1e-4 of the
        # largest eigenvalue and covariance entry
        assert _lam_close(ek.sort(-1).values, ep.sort(-1).values, 1e-4)
        ck, cp = _covariance(vk, ek), _covariance(vp, ep)
        assert (ck - cp).abs().max() <= 1e-4 * cp.abs().max()


def test_fc_fit_routes_to_the_step_kernels(cuda):
    """'auto' with frequency-constant weights inside K5's gate: one init
    launch and one step launch per further iteration, no plain twin."""
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer
    from pb_bss_tpu_torch.ops import em_step
    from pb_bss_tpu_torch.permutation_alignment import (
        GreedyPermutationAlignment)
    g = torch.Generator(cuda).manual_seed(6)
    Y = torch.randn((65, 200, 6), dtype=torch.complex64, device=cuda,
                    generator=g)
    for aligner in (None, GreedyPermutationAlignment('cos')):
        before = (em_step.m_init.launches, em_step.em_step.launches)
        model = CACGMMTrainer().fit(
            Y, num_classes=3, iterations=5, weight_constant_axis=(-3, -1),
            inline_permutation_aligner=aligner)
        torch.cuda.synchronize()
        assert (em_step.m_init.launches, em_step.em_step.launches) == (
            before[0] + 1, before[1] + 4)
        assert model.weight.shape == (1, 3, 1)
        assert torch.isfinite(model.cacg.covariance_eigenvalues).all()


@pytest.mark.parametrize('T', [304, 1100, 37, 3753])
def test_e_step_kernels_match_plain(cuda, T):
    from pb_bss_tpu_torch.ops import em_estep
    F, D, K = 65, 6, 3
    g = torch.Generator(cuda).manual_seed(7)
    y = torch.randn((F, D, T), dtype=torch.complex64, device=cuda,
                    generator=g)
    a = torch.randn((F, K, D, D), dtype=torch.complex64, device=cuda,
                    generator=g)
    vec = torch.linalg.qr(a)[0]
    ev = 0.1 + 0.9 * torch.rand((F, K, D), device=cuda, generator=g)
    args = (y.real.contiguous(), y.imag.contiguous(), vec.real.contiguous(),
            vec.imag.contiguous(), 1. / ev, torch.log(ev).sum(-1),
            torch.full((F, K), 1. / K, device=cuda))
    before = (em_estep.cacgmm_e_step.launches,
              em_estep.cacgmm_em_scatter.launches)
    aff_k, qf_k = em_estep.cacgmm_e_step(*args)
    s_k = em_estep.cacgmm_em_scatter(*args)
    torch.cuda.synchronize()
    assert (em_estep.cacgmm_e_step.launches,
            em_estep.cacgmm_em_scatter.launches) == (before[0] + 1,
                                                     before[1] + 1)
    aff_p, qf_p = em_estep.cacgmm_e_step_reference(*args)
    s_p = em_estep.cacgmm_em_scatter_reference(*args)
    # the inverse-covariance quadratic form against the projection
    torch.testing.assert_close(qf_k, qf_p, rtol=1e-4, atol=0)
    torch.testing.assert_close(aff_k, aff_p, atol=1e-4, rtol=0)
    for k, p in zip(s_k[:2], s_p[:2]):
        assert (k - p).abs().max() <= 1e-4 * s_p[0].abs().max()
    torch.testing.assert_close(s_k[2], s_p[2], rtol=1e-4, atol=0)


@pytest.mark.parametrize('F,T', [(65, 3753), (257, 304), (133, 300)])
def test_scatter_kernel_repeats_bit_for_bit(cuda, F, T):
    """The split bins are summed in the launch in slot order, so two runs
    agree bit for bit; the trainer's route (em_scatter_model on the
    complex tensors) gives the same bits."""
    from pb_bss_tpu_torch.ops import em_estep
    D, K = 6, 3
    g = torch.Generator(cuda).manual_seed(9)
    y = torch.randn((F, D, T), dtype=torch.complex64, device=cuda,
                    generator=g)
    vec = torch.linalg.qr(torch.randn((F, K, D, D), dtype=torch.complex64,
                                      device=cuda, generator=g))[0]
    ev = 0.1 + 0.9 * torch.rand((F, K, D), device=cuda, generator=g)
    w = torch.rand((F, K), device=cuda, generator=g) + 0.2
    rest = (1. / ev, torch.log(ev).sum(-1), w / w.sum(-1, keepdim=True))
    args = (y.real.contiguous(), y.imag.contiguous(), vec.real.contiguous(),
            vec.imag.contiguous(), *rest)
    first = em_estep.cacgmm_em_scatter(*args)
    second = em_estep.cacgmm_em_scatter(*args)
    model = em_estep.em_scatter_model(y, vec, *rest)
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, model):
        assert torch.equal(a, b) and torch.equal(a, c)
    ref = em_estep.cacgmm_em_scatter_reference(*args)
    for k, p in zip(first[:2], ref[:2]):
        assert (k - p).abs().max() <= 1e-4 * ref[0].abs().max()
    torch.testing.assert_close(first[2], ref[2], rtol=1e-4, atol=0)


@pytest.mark.parametrize('T', [304, 3753])
@pytest.mark.parametrize('K', [5, 8])
@pytest.mark.parametrize('D', list(range(1, 17)))
def test_e_step_kernel_instantiations_match_plain(cuda, D, K, T):
    """Both K11 kernels at every D against their twins, with two groups of
    classes (the pass re-reads a segment and runs the E-step again a
    group) and bins split over CTAs; the scatter repeats bit for bit."""
    from pb_bss_tpu_torch.ops import em_estep
    F = 33
    g = torch.Generator(cuda).manual_seed(100 * D + K)
    y = torch.randn((F, D, T), dtype=torch.complex64, device=cuda,
                    generator=g)
    vec = torch.linalg.qr(torch.randn((F, K, D, D), dtype=torch.complex64,
                                      device=cuda, generator=g))[0]
    ev = 0.1 + 0.9 * torch.rand((F, K, D), device=cuda, generator=g)
    w = torch.rand((F, K), device=cuda, generator=g) + 0.2
    args = (y.real.contiguous(), y.imag.contiguous(), vec.real.contiguous(),
            vec.imag.contiguous(), 1. / ev, torch.log(ev).sum(-1),
            w / w.sum(-1, keepdim=True))
    aff_k, qf_k = em_estep.cacgmm_e_step(*args)
    first = em_estep.cacgmm_em_scatter(*args)
    second = em_estep.cacgmm_em_scatter(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    aff_p, qf_p = em_estep.cacgmm_e_step_reference(*args)
    ref = em_estep.cacgmm_em_scatter_reference(*args)
    torch.testing.assert_close(qf_k, qf_p, rtol=1e-4, atol=0)
    torch.testing.assert_close(aff_k, aff_p, atol=1e-4, rtol=0)
    for k, p in zip(first[:2], ref[:2]):
        assert (k - p).abs().max() <= 1e-4 * ref[0].abs().max()
    torch.testing.assert_close(first[2], ref[2], rtol=1e-4, atol=0)


@pytest.mark.parametrize('D', list(range(1, 17)))
def test_gev_kernel_instantiations_match_plain(cuda, D):
    """K3 at every D against its twin: planted singular and all-zero
    noise PSDs non-finite in both, the rest within 1e-3 after the phase
    and B-normalized; get_gev_vector one launch that gives the twin's
    two-call composition."""
    from pb_bss_tpu_torch.extraction.beamformer import (
        RETRY_LOADING, get_gev_vector)
    from pb_bss_tpu_torch.ops.gev import gev_with_retry_reference
    g = torch.Generator(cuda).manual_seed(20 + D)
    B = 200
    eye = torch.eye(D, dtype=torch.complex64, device=cuda)

    def herm_pd(scale):
        a = torch.randn((B, D, D), dtype=torch.complex64, device=cuda,
                        generator=g)
        return a @ a.conj().transpose(-1, -2) + scale * eye

    phi_xx, phi_nn = herm_pd(0.1), herm_pd(0.5)
    singular = torch.ones(D, device=cuda)
    singular[-1] = 0
    phi_nn[3] = torch.diag(singular).to(phi_nn.dtype)
    phi_nn[7] = 0

    def aligned_error(out, ref, ok):
        inner = torch.einsum('bd,bd->b', ref[ok].conj(), out[ok])
        return (out[ok] / (inner / inner.abs())[:, None]
                - ref[ok]).abs().max().item()

    out = gev(phi_xx, phi_nn)
    ref = gev_reference(phi_xx, phi_nn)
    torch.cuda.synchronize()
    ok = torch.isfinite(out.abs()).all(-1)
    assert torch.equal(ok, torch.isfinite(ref.abs()).all(-1))
    assert not ok[3] and not ok[7] and int(ok.sum()) == B - 2
    assert aligned_error(out, ref, ok) < 1e-3
    bnb = torch.einsum('bd,bde,be->b', out[ok].conj(), phi_nn[ok], out[ok])
    assert (bnb - 1).abs().max() < 1e-3

    before = gev.launches
    retried = get_gev_vector(phi_xx, phi_nn)
    torch.cuda.synchronize()
    assert gev.launches == before + 1
    composed = gev_with_retry_reference(phi_xx, phi_nn, RETRY_LOADING)
    fin = torch.isfinite(retried.abs()).all(-1)
    assert torch.equal(fin, torch.isfinite(composed.abs()).all(-1))
    assert bool(fin[3]) == (D > 1) and not fin[7]
    assert torch.equal(retried[ok], out[ok])
    assert aligned_error(retried, composed, fin) < 1e-3


def test_use_pallas_em_routes_to_the_scatter_kernel(cuda):
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer
    from pb_bss_tpu_torch.ops import em_estep
    from pb_bss_tpu_torch.ops.eigh import eigh_jacobi
    g = torch.Generator(cuda).manual_seed(8)
    Y = torch.randn((65, 304, 6), dtype=torch.complex64, device=cuda,
                    generator=g)
    before = (em_estep.cacgmm_em_scatter.launches, eigh_jacobi.launches)
    model = CACGMMTrainer().fit(Y, num_classes=3, iterations=5,
                                use_pallas_em=True)
    torch.cuda.synchronize()
    assert (em_estep.cacgmm_em_scatter.launches,
            eigh_jacobi.launches) == (before[0] + 4, before[1] + 5)
    assert torch.isfinite(model.cacg.covariance_eigenvalues).all()


def test_em_kernel_with_saliency_and_mask_matches_plain(cuda):
    """K2 with saliency and a source-activity mask that silences a class
    in some bins (affiliation_eps=0: its sum is exactly 0 there, the
    0 * inf hazard at D >= 5), one iteration, against its twin."""
    F, D, K, T = 33, 6, 3, 304
    y, aff = _unit_norm_mixture(F, D, K, T, cuda)
    qf = torch.ones_like(aff)
    g = torch.Generator(cuda).manual_seed(9)
    sal = 0.2 + 0.8 * torch.rand((F, T), device=cuda, generator=g)
    mask = torch.ones((F, K, T), device=cuda, dtype=torch.bool)
    mask[3:9, 1] = False
    kwargs = dict(saliency=sal, source_activity_mask=mask,
                  affiliation_eps=0.)
    before = cacgmm_em_full.launches
    out = cacgmm_em_full(y, aff, qf, iterations=1, warm_sweeps=2, **kwargs)
    torch.cuda.synchronize()
    assert cacgmm_em_full.launches == before + 1
    ref = cacgmm_em_full_reference(y, aff, qf, iterations=1, **kwargs)
    assert all(bool(torch.isfinite(x).all()) for x in out)
    torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(out[1], ref[1], atol=1e-4, rtol=0)
    torch.testing.assert_close(out[3], ref[3], atol=2e-3, rtol=0)
    assert bool((out[3][3:9, 1] == 0).all())


def test_trainer_with_saliency_and_mask_launches_the_whole_fit(cuda):
    """fit(saliency=..., source_activity_mask=...) at T=304 runs K2 once
    on the card (it raised NotImplementedError before the kernel took the
    two extras) and agrees with the twin: one iteration tightly (both
    Jacobis cold), three by the argmax of the posteriors (the kernel's
    later Jacobis are warm-started)."""
    from pb_bss_tpu_torch.models.cacgmm import CACGMMTrainer
    g = torch.Generator(cuda).manual_seed(10)
    Y = torch.randn((65, 304, 6), dtype=torch.complex64, device=cuda,
                    generator=g)
    aff = torch.rand((65, 3, 304), device=cuda, generator=g)
    aff = aff / aff.sum(-2, keepdim=True)
    sal = 0.2 + 0.8 * torch.rand((65, 304), device=cuda, generator=g)
    mask = torch.rand((65, 3, 304), device=cuda, generator=g) > 0.2
    mask[:, 0] |= ~mask.any(1)
    kwargs = dict(initialization=aff, saliency=sal,
                  source_activity_mask=mask)
    for iterations in (1, 3):
        before = cacgmm_em_full.launches
        model, posterior = CACGMMTrainer().fit_predict_model(
            Y, iterations=iterations, **kwargs)
        torch.cuda.synchronize()
        assert cacgmm_em_full.launches == before + 1
        twin, twin_posterior = CACGMMTrainer().fit_predict_model(
            Y.cpu(), iterations=iterations, use_fused_em=True,
            **{k: v.cpu() for k, v in kwargs.items()})
        assert bool((posterior[~mask] == 0).all())
        if iterations == 1:
            torch.testing.assert_close(model.weight.cpu(), twin.weight,
                                       atol=1e-5, rtol=0)
            torch.testing.assert_close(posterior.cpu(), twin_posterior,
                                       atol=2e-3, rtol=0)
        agree = (posterior.argmax(-2).cpu() == twin_posterior.argmax(-2))
        assert agree.float().mean() > 0.99


def _watson_close(out, ref, *, weight, kappa_rtol, overlap, aff=None):
    torch.testing.assert_close(out[0], ref[0], atol=weight, rtol=0)
    torch.testing.assert_close(out[2], ref[2], rtol=kappa_rtol, atol=1e-3)
    inner = torch.einsum('...d,...d->...', out[1].conj(), ref[1]).abs()
    assert inner.min() > 1 - overlap, inner.min()
    if aff is not None:
        torch.testing.assert_close(out[3], ref[3], atol=aff, rtol=0)


@pytest.mark.parametrize('D,K,T,saliency', [
    (6, 3, 304, False), (6, 3, 304, True), (3, 2, 777, False),
    (8, 4, 150, False), (16, 3, 100, False)])
def test_watson_whole_fit_kernel_matches_plain(cuda, D, K, T, saliency):
    """K6 against its twin: one (cold) iteration tightly; 20 iterations
    (warm Jacobi in the kernel) by the argmax of the posteriors."""
    from pb_bss_tpu_torch.ops.cwmm_loop import (
        cwmm_em_full, cwmm_em_full_reference)
    y, aff = _unit_norm_mixture(33, D, K, T, cuda)
    sal = None
    if saliency:
        g = torch.Generator(cuda).manual_seed(11)
        sal = 0.2 + 0.8 * torch.rand((33, T), device=cuda, generator=g)
    before = cwmm_em_full.launches
    out = cwmm_em_full(y, aff, iterations=1, warm_sweeps=2, saliency=sal)
    torch.cuda.synchronize()
    assert cwmm_em_full.launches == before + 1
    ref = cwmm_em_full_reference(y, aff, iterations=1, saliency=sal)
    # one cold iteration: f32 rounding of two Jacobi and E-step orderings;
    # kappa through the steep table
    _watson_close(out, ref, weight=1e-5, kappa_rtol=1e-3, overlap=1e-4,
                  aff=2e-3)
    out = cwmm_em_full(y, aff, iterations=20, warm_sweeps=2, saliency=sal)
    ref = cwmm_em_full_reference(y, aff, iterations=20, saliency=sal)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in out)
    agree = (out[3].argmax(-2) == ref[3].argmax(-2)).float().mean()
    assert agree > 0.9, agree


@pytest.mark.parametrize('mode', ['from_init', 'step', 'step_fc'])
def test_watson_stream_kernel_one_pass_matches_plain(cuda, mode):
    from pb_bss_tpu_torch.models.complex_watson import ComplexWatson
    from pb_bss_tpu_torch.ops.mm_stream import mm_stats, mm_stats_reference
    N, D, K, T = 66, 6, 3, 1777
    y, aff = _unit_norm_mixture(N, D, K, T, cuda)
    g = torch.Generator(cuda).manual_seed(12)
    sal = 0.2 + 0.8 * torch.rand((N, T), device=cuda, generator=g)
    if mode == 'from_init':
        kwargs = dict(affiliation=aff)
    else:
        m = torch.randn((N, K, D), dtype=torch.complex64, device=cuda,
                        generator=g)
        m = m / torch.linalg.vector_norm(m, dim=-1, keepdim=True)
        kappa = 1. + 30. * torch.rand((N, K), device=cuda, generator=g)
        rows = 2 if mode == 'step_fc' else N
        weight = torch.rand((rows, K), device=cuda, generator=g) + 0.2
        kwargs = dict(mode=m, concentration=kappa,
                      log_norm=ComplexWatson.log_norm_tran_vu(kappa, D),
                      weight=weight / weight.sum(-1, keepdim=True),
                      bins_per_weight=N // rows)
    before = mm_stats.launches
    s_k, a_k = mm_stats(y, saliency=sal, **kwargs)
    torch.cuda.synchronize()
    assert mm_stats.launches == before + 1
    s_p, a_p = mm_stats_reference(y, saliency=sal, **kwargs)
    # f32 sums over T in two orders: 1e-4 of the largest entry
    assert (s_k - s_p).abs().max() <= 1e-4 * s_p.abs().max()
    assert torch.equal(s_k, s_k.conj().transpose(-1, -2))
    torch.testing.assert_close(a_k, a_p, rtol=1e-4, atol=0)


@pytest.mark.parametrize('route', ['whole', 'fc', 'long'])
def test_cwmm_trainer_routes_to_the_watson_kernels(cuda, route):
    """'auto' on a CUDA tensor: per-bin weights inside K6's gate launch
    K6 once; frequency-constant weights, or T past the gate, launch K7
    once per iteration with K1 in every M-step finish."""
    from pb_bss_tpu_torch.models.cwmm import CWMMTrainer
    from pb_bss_tpu_torch.ops.cwmm_loop import cwmm_em_full
    from pb_bss_tpu_torch.ops.eigh import eigh_jacobi
    from pb_bss_tpu_torch.ops.mm_stream import mm_stats
    T = 3900 if route == 'long' else 300
    g = torch.Generator(cuda).manual_seed(13)
    Y = torch.randn((65, T, 6), dtype=torch.complex64, device=cuda,
                    generator=g)
    kwargs = dict(weight_constant_axis=(-3, -1)) if route == 'fc' else {}
    before = (cwmm_em_full.launches, mm_stats.launches, eigh_jacobi.launches)
    model, posterior = CWMMTrainer().fit(
        Y, num_classes=3, iterations=5, _return_affiliation=True, **kwargs)
    torch.cuda.synchronize()
    after = (cwmm_em_full.launches, mm_stats.launches, eigh_jacobi.launches)
    want = (1, 0, 0) if route == 'whole' else (0, 5, 5)
    assert tuple(a - b for a, b in zip(after, before)) == want
    assert torch.isfinite(model.complex_watson.concentration).all()
    assert torch.isfinite(posterior).all()


def _bingham_problems(B, D, device, seed, warm=True):
    """Sorted, spaced moments (B, D) and their start: the twin's cold
    solve perturbed by 5% (warm) or the -1/s start (cold)."""
    from pb_bss_tpu_torch.models.complex_bingham import (
        _remove_duplicate_eigenvalues, find_eigenvalues)
    rng = np.random.default_rng(seed)
    s = np.sort(rng.dirichlet(np.full(D, 0.7), size=B), -1)
    _, s = _remove_duplicate_eigenvalues(torch.as_tensor(s, dtype=torch.float32))
    lam = find_eigenvalues(s, use_pallas=True)
    x0 = lam * (1 + 0.05 * torch.as_tensor(
        rng.standard_normal((B, 1)), dtype=torch.float32))
    x0[:, -1] = 0
    return s.to(device), torch.sort(x0, -1).values.to(device)


def _residual(lam, s):
    from pb_bss_tpu_torch.ops.bingham import grad_cascade
    return (grad_cascade(lam.cpu())[0] - s.cpu()).abs().max(-1).values


@pytest.mark.parametrize('D', list(range(2, 9)))
def test_bingham_chord_kernel_matches_plain(cuda, D):
    """K8 against its twin, at every D its wrapper takes: the same fixed
    point grad log Z = s, so the residual is the criterion (the
    finite-difference Jacobians differ by ulps under FMA contraction);
    structure exact."""
    from pb_bss_tpu_torch.ops.bingham import (
        bingham_chord_solve, bingham_chord_solve_reference)
    s, x0 = _bingham_problems(777, D, cuda, seed=D)
    bounds = dict(lower=-32768. / (D - 1), upper=-1e-3)
    before = bingham_chord_solve.launches
    out = bingham_chord_solve(s, x0, iterations=16, **bounds)
    torch.cuda.synchronize()
    assert bingham_chord_solve.launches == before + 1
    ref = bingham_chord_solve_reference(s, x0, iterations=16, **bounds)
    r_k, r_p = _residual(out, s), _residual(ref, s)
    assert torch.isfinite(out).all()
    assert r_k.median() < 2 * max(r_p.median().item(), 1e-5)
    assert r_k.max() < 3 * max(r_p.max().item(), 1e-3)
    assert (torch.diff(out, dim=-1) >= 0).all()
    assert (out[:, -1] == 0).all()
    well = ref.abs().max(-1).values < 300
    rel = ((out - ref).abs() / (1 + ref.abs())).max(-1).values
    assert rel[well].median() < 1e-3


def _cbmm_mixture(N, D, K, T, device, seed=0):
    """Unit-norm observations around K axes per bin (Bingham data is
    axially symmetric) and a random initial affiliation."""
    g = torch.Generator(device).manual_seed(seed)
    modes = torch.randn((N, K, D), dtype=torch.complex64, device=device,
                        generator=g)
    lab = torch.arange(T, device=device) % K
    y = modes[:, lab].transpose(-1, -2) + 0.3 * torch.randn(
        (N, D, T), dtype=torch.complex64, device=device, generator=g)
    y = y / torch.linalg.vector_norm(y, dim=-2, keepdim=True)
    aff = torch.rand((N, K, T), device=device, generator=g)
    return y, aff / aff.sum(-2, keepdim=True)


@pytest.mark.parametrize('D,K,T,extras', [
    (6, 3, 304, False), (6, 3, 304, True), (3, 2, 777, False),
    (8, 4, 150, False)])
def test_bingham_whole_fit_kernel_matches_plain(cuda, D, K, T, extras):
    """K9 against its twin: one cold iteration tightly (weights; the
    eigenvalues through the same chord rounds), eigenvectors phase-aligned;
    5 iterations by the argmax of the posteriors, and the kernel's fifth
    (warm) iteration against the twin's warm step from the kernel's state
    after four: the weights to 1e-5, the posteriors on average to 2.5e-3
    plus four times what an ulp-level change of y moves that step.
    ``extras``: saliency, a class silenced in 8 bins and a finite
    max_concentration."""
    from pb_bss_tpu_torch.ops.cbmm_loop import (
        cbmm_em_full, cbmm_em_full_reference, cbmm_em_step_reference)
    y, aff = _cbmm_mixture(33, D, K, T, cuda)
    kw = {}
    if extras:
        g = torch.Generator(cuda).manual_seed(14)
        kw = dict(saliency=0.2 + 0.8 * torch.rand((33, T), device=cuda,
                                                   generator=g),
                  max_concentration=50.)
        aff[3:11, 1] = 0
        aff = aff / aff.sum(-2, keepdim=True)
    before = cbmm_em_full.launches
    out = cbmm_em_full(y, aff, iterations=1, **kw)
    torch.cuda.synchronize()
    assert cbmm_em_full.launches == before + 1
    ref = cbmm_em_full_reference(y, aff, iterations=1, **kw)
    torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(out[1], ref[1], rtol=5e-2, atol=0.5)
    inner = torch.einsum('...dk,...dk->...k', out[2].conj(), ref[2]).abs()
    assert inner.min() > 1 - 1e-3, inner.min()
    assert all(bool(torch.isfinite(x).all()) for x in out)
    out = cbmm_em_full(y, aff, iterations=5, **kw)
    ref = cbmm_em_full_reference(y, aff, iterations=5, **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in out)
    agree = (out[4].argmax(-2) == ref[4].argmax(-2)).float().mean()
    assert agree > 0.9, agree
    four = cbmm_em_full(y, aff, iterations=4, **kw)

    def step(y_):
        return cbmm_em_step_reference(y_, four[4], four[1:3], **kw)
    twin = step(y)
    torch.testing.assert_close(out[0], twin[0], atol=1e-5, rtol=0)
    parted = (out[4] - twin[4]).abs().mean().item()
    rounding = (step(y * (1 + 2 ** -22))[4] - twin[4]).abs().mean().item()
    assert parted <= 4 * rounding + 2.5e-3, (parted, rounding)


@pytest.mark.parametrize('mode', ['from_init', 'step', 'step_fc'])
def test_bingham_stream_kernel_one_pass_matches_plain(cuda, mode):
    from pb_bss_tpu_torch.ops.mm_stream import mm_stats, mm_stats_reference
    N, D, K, T = 66, 6, 3, 1777
    y, aff = _unit_norm_mixture(N, D, K, T, cuda)
    g = torch.Generator(cuda).manual_seed(15)
    sal = 0.2 + 0.8 * torch.rand((N, T), device=cuda, generator=g)
    if mode == 'from_init':
        kwargs = dict(affiliation=aff)
    else:
        vec = torch.linalg.qr(torch.randn((N, K, D, D), dtype=torch.complex64,
                                          device=cuda, generator=g))[0]
        lam = -torch.sort(30. * torch.rand((N, K, D), device=cuda,
                                           generator=g), -1,
                          descending=True).values
        lam = lam - lam[..., -1:]
        rows = 2 if mode == 'step_fc' else N
        weight = torch.rand((rows, K), device=cuda, generator=g) + 0.2
        kwargs = dict(eigenvectors=vec, eigenvalues=lam,
                      log_norm=torch.rand((N, K), device=cuda, generator=g),
                      weight=weight / weight.sum(-1, keepdim=True),
                      bins_per_weight=N // rows, affiliation_eps=1e-3)
    before = mm_stats.launches
    s_k, a_k = mm_stats(y, saliency=sal, **kwargs)
    torch.cuda.synchronize()
    assert mm_stats.launches == before + 1
    s_p, a_p = mm_stats_reference(y, saliency=sal, **kwargs)
    # f32 sums over T in two orders: 1e-4 of the largest entry
    assert (s_k - s_p).abs().max() <= 1e-4 * s_p.abs().max()
    assert torch.equal(s_k, s_k.conj().transpose(-1, -2))
    torch.testing.assert_close(a_k, a_p, rtol=1e-4, atol=0)


@pytest.mark.parametrize('saliency', [False, True], ids=['plain', 'sal'])
@pytest.mark.parametrize('family', ['watson', 'bingham'])
@pytest.mark.parametrize('D', list(range(1, 17)))
def test_mixture_stream_kernel_instantiations_match_plain(cuda, D, family,
                                                          saliency):
    """K7, one pass in each mode (from-init, step with per-bin weights,
    step with weights shared by groups of bins), at each D its gate takes,
    in both families, with and without saliency, against its twin to the
    tolerances of the one-pass tests above; and its partials repeat bit for
    bit."""
    from pb_bss_tpu_torch.ops.mm_stream import mm_stats, mm_stats_reference
    N, K, T = 34, 3, 1301
    y, aff = _unit_norm_mixture(N, D, K, T, cuda)
    g = torch.Generator(cuda).manual_seed(40 + D)
    sal = (0.2 + 0.8 * torch.rand((N, T), device=cuda, generator=g)
           if saliency else None)
    if family == 'watson':
        m = torch.randn((N, K, D), dtype=torch.complex64, device=cuda,
                        generator=g)
        model = dict(mode=m / torch.linalg.vector_norm(m, dim=-1,
                                                       keepdim=True),
                     concentration=1. + 30. * torch.rand(
                         (N, K), device=cuda, generator=g))
    else:
        vec = torch.linalg.qr(torch.randn(
            (N, K, D, D), dtype=torch.complex64, device=cuda,
            generator=g))[0]
        lam = -torch.sort(30. * torch.rand((N, K, D), device=cuda,
                                           generator=g), -1,
                          descending=True).values
        model = dict(eigenvectors=vec, eigenvalues=lam - lam[..., -1:],
                     affiliation_eps=1e-3)
    log_norm = 5. * torch.rand((N, K), device=cuda, generator=g)
    modes = [dict(affiliation=aff)]
    for rows in (N, 2):
        weight = torch.rand((rows, K), device=cuda, generator=g) + 0.2
        modes.append(dict(model, log_norm=log_norm,
                          weight=weight / weight.sum(-1, keepdim=True),
                          bins_per_weight=N // rows))
    for kwargs in modes:
        before = mm_stats.launches
        s_k, a_k = mm_stats(y, saliency=sal, **kwargs)
        again = mm_stats(y, saliency=sal, **kwargs)
        torch.cuda.synchronize()
        assert mm_stats.launches == before + 2
        assert torch.equal(s_k, again[0]) and torch.equal(a_k, again[1])
        assert torch.equal(s_k, s_k.conj().transpose(-1, -2))
        s_p, a_p = mm_stats_reference(y, saliency=sal, **kwargs)
        assert bool(torch.isfinite(s_k).all())
        # f32 sums over T in two orders: 1e-4 of the largest entry
        assert (s_k - s_p).abs().max() <= 1e-4 * s_p.abs().max()
        torch.testing.assert_close(a_k, a_p, rtol=1e-4, atol=0)


@pytest.mark.parametrize('route', ['whole', 'fc', 'long'])
def test_cbmm_trainer_routes_to_the_bingham_kernels(cuda, route):
    """'auto' on a CUDA tensor: per-bin weights inside K9's gate launch K9
    once; frequency-constant weights, or T past the gate, launch K7 once
    per iteration, K1 in every M-step finish and K8 three times for the
    cold first solve and once per warm one."""
    from pb_bss_tpu_torch.models.cbmm import CBMMTrainer
    from pb_bss_tpu_torch.ops.bingham import bingham_chord_solve
    from pb_bss_tpu_torch.ops.cbmm_loop import cbmm_em_full
    from pb_bss_tpu_torch.ops.eigh import eigh_jacobi
    from pb_bss_tpu_torch.ops.mm_stream import mm_stats
    T = 3800 if route == 'long' else 300
    g = torch.Generator(cuda).manual_seed(16)
    Y = torch.randn((65, T, 6), dtype=torch.complex64, device=cuda,
                    generator=g)
    kwargs = dict(weight_constant_axis=(-3, -1)) if route == 'fc' else {}

    def counts():
        return (cbmm_em_full.launches, mm_stats.launches,
                eigh_jacobi.launches, bingham_chord_solve.launches)
    before = counts()
    model, posterior = CBMMTrainer().fit(
        Y, num_classes=3, iterations=5, _return_affiliation=True, **kwargs)
    torch.cuda.synchronize()
    want = (1, 0, 0, 0) if route == 'whole' else (0, 5, 5, 3 + 4)
    assert tuple(a - b for a, b in zip(counts(), before)) == want
    assert torch.isfinite(model.complex_bingham.covariance_eigenvalues).all()
    assert torch.isfinite(posterior).all()


def _integration_inputs(N, D, K, T, E, U, mode, device, saliency=False,
                        seed=0, floor=False):
    """Unit-norm two-source mixtures, a random embedding, a
    well-conditioned cACG model per bin and a spectral state per
    utterance, made on the card. With ``floor``, class 0's smallest
    eigenvalue sits at the eigenvalue floor and a third of the frames lie
    in the span of its other eigenvectors (a converged fit's regime)."""
    import math
    from pb_bss_tpu_torch.models.von_mises_fisher import VonMisesFisher
    g = torch.Generator(device).manual_seed(seed)

    def cn(*shape):
        return torch.complex(torch.randn(shape, generator=g, device=device),
                             torch.randn(shape, generator=g, device=device))
    y = torch.einsum('ndk,nkt->ndt', cn(N, D, 2), cn(N, 2, T)) \
        + 0.3 * cn(N, D, T)
    y = y / torch.linalg.vector_norm(y, dim=1, keepdim=True)
    emb = torch.randn((N, E, T), generator=g, device=device)
    a = cn(N, K, D, D)
    cov = a @ a.conj().transpose(-1, -2) / D \
        + 2 * torch.eye(D, device=device)
    eigenvalues, eigenvectors = torch.linalg.eigh(cov)
    eigenvalues = eigenvalues / eigenvalues.max(-1, keepdim=True).values
    if floor:
        eigenvalues[:, 0, 0] = 1e-10
        inside = torch.einsum('nde,net->ndt', eigenvectors[:, 0, :, 1:],
                              cn(N, D - 1, T // 3))
        y[..., :T // 3] = inside / torch.linalg.vector_norm(
            inside, dim=1, keepdim=True)
    weight = torch.rand((N, K), generator=g, device=device) + 0.5
    weight = weight / weight.sum(-1, keepdim=True)
    if mode == 'vmf':
        mu = torch.randn((U, K, E), generator=g, device=device)
        mu = mu / mu.norm(dim=-1, keepdim=True)
        kappa = 1 + 19 * torch.rand((U, K), generator=g, device=device)
        spec = (mu, kappa, VonMisesFisher(mean=mu,
                                          concentration=kappa).log_norm())
    else:
        mean = 0.3 * torch.randn((U, K, E), generator=g, device=device)
        prec = 0.5 + torch.rand((U, K, E), generator=g, device=device)
        const = 0.5 * E * math.log(2 * math.pi) \
            - 0.5 * torch.log(prec).sum(-1) + 0.5 * (mean ** 2 * prec).sum(-1)
        spec = (prec * mean, prec, const)
    sal = (torch.rand((N, T), generator=g, device=device) if saliency
           else None)
    return y, emb, eigenvalues, eigenvectors, weight, spec, sal


@pytest.mark.parametrize('mode,D,K,T,E,U,saliency,floor', [
    ('vmf', 6, 3, 300, 20, 1, False, False),
    ('gaussian', 6, 3, 300, 20, 2, True, False),
    ('vmf', 8, 4, 37, 7, 1, True, False),
    ('gaussian', 3, 2, 301, 5, 1, False, False),
    ('vmf', 6, 3, 300, 20, 1, False, True),
    ('gaussian', 8, 4, 150, 7, 2, True, True)])
def test_integration_stats_kernel_matches_plain(cuda, mode, D, K, T, E, U,
                                                saliency, floor):
    from pb_bss_tpu_torch.ops import integration_em
    N = 66
    y, emb, ev, vec, w, spec, sal = _integration_inputs(
        N, D, K, T, E, U, mode, cuda, saliency, floor=floor)
    kw = dict(eigenvalues=ev, eigenvectors=vec, weight=w, mu=spec[0],
              kappa=spec[1], log_c=spec[2], bins_per_utt=N // U,
              spectral_mode=mode, saliency=sal, spatial_weight=0.7,
              spectral_weight=1.3)
    before = integration_em.e_stats.launches
    out = integration_em.e_stats(y, emb, **kw)
    torch.cuda.synchronize()
    assert integration_em.e_stats.launches == before + 1
    ref = integration_em.e_stats_reference(y, emb, **kw)
    # f32 sums over T frames in two orders: 1e-5 of the largest entry
    for a, b in zip(out, ref):
        if b is None:
            assert a is None
            continue
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert torch.equal(out[0], out[0].conj().transpose(-1, -2))


def _integration_stats_kwargs(N, U, mode, ev, vec, w, spec, sal):
    return dict(eigenvalues=ev, eigenvectors=vec, weight=w, mu=spec[0],
                kappa=spec[1], log_c=spec[2], bins_per_utt=N // U,
                spectral_mode=mode, saliency=sal, spatial_weight=0.7,
                spectral_weight=1.3)


@pytest.mark.parametrize('mode', ['vmf', 'gaussian'])
def test_integration_stats_kernel_at_b8(cuda, mode):
    """K10 at bench config 3 folded 8 times (8 x 513 bins, T=300, E=20),
    with saliency, against its twin; two passes agree bit for bit."""
    from pb_bss_tpu_torch.ops import integration_em
    N, U = 8 * 513, 8
    y, emb, ev, vec, w, spec, sal = _integration_inputs(
        N, 6, 3, 300, 20, U, mode, cuda, saliency=True, seed=3)
    kw = _integration_stats_kwargs(N, U, mode, ev, vec, w, spec, sal)
    out = integration_em.e_stats(y, emb, **kw)
    again = integration_em.e_stats(y, emb, **kw)
    ref = integration_em.e_stats_reference(y, emb, **kw)
    torch.cuda.synchronize()
    for a, a2, b in zip(out, again, ref):
        if b is None:
            assert a is None
            continue
        assert torch.equal(a, a2)
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize('mode,T', [('vmf', 300), ('gaussian', 257),
                                    ('vmf', 1)])
def test_integration_stats_kernel_is_one_launch(cuda, mode, T):
    """One K10 call is one kernel on the card (no tail after it), counted
    once, and repeats bit for bit."""
    from pb_bss_tpu_torch.ops import integration_em
    N = 513
    y, emb, ev, vec, w, spec, sal = _integration_inputs(
        N, 6, 3, T, 20, 1, mode, cuda, saliency=True, seed=4)
    # operands that need no conversion (torch.linalg.eigh leaves the
    # eigenvectors column-major)
    kw = _integration_stats_kwargs(N, 1, mode, ev, vec.contiguous(), w, spec,
                                   sal)
    first = integration_em.e_stats(y, emb, **kw)
    torch.cuda.synchronize()
    before = integration_em.e_stats.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        again = integration_em.e_stats(y, emb, **kw)
        torch.cuda.synchronize()
    assert integration_em.e_stats.launches == before + 1
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, [e.name for e in kernels]
    assert 'integration_stats' in kernels[0].name
    for a, b in zip(first, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize('mode', ['vmf', 'gaussian'])
def test_integration_whole_fit_kernel_one_iteration_matches_plain(cuda,
                                                                  mode):
    from pb_bss_tpu_torch.ops import integration_em_loop as il
    N, D, K, T, E, U = 2 * 33, 6, 3, 150, 8, 2
    y, emb, ev, vec, w, spec, _ = _integration_inputs(N, D, K, T, E, U,
                                                      mode, cuda)
    kw = dict(iterations=1, bins_per_utt=N // U, spectral_mode=mode)
    before = il.integration_em_full.launches
    out = il.integration_em_full(y, emb, vec, ev, w, *spec, **kw)
    torch.cuda.synchronize()
    assert il.integration_em_full.launches == before + 1
    ref = il.integration_em_full_reference(y, emb, vec, ev, w, *spec, **kw)
    # one iteration: the same sums in two orders and two f32 Jacobi runs
    torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(out[2], ref[2], atol=1e-5, rtol=0)
    assert (out[3] - ref[3]).abs().max() <= 1e-5 * ref[3].abs().max()


def test_integration_whole_fit_too_large_a_grid_raises(cuda):
    from pb_bss_tpu_torch.ops import integration_em_loop as il
    y, emb, ev, vec, w, spec, _ = _integration_inputs(33, 4, 2, 40, 5, 1,
                                                      'vmf', cuda)
    # 100,000 CTAs of 256 threads cannot be co-resident on any card:
    # cudaErrorCooperativeLaunchTooLarge, never a fallback
    with pytest.raises(RuntimeError, match='CUDA error 720'):
        il.integration_em_full(y, emb, vec, ev, w, *spec, iterations=2,
                               grid=100_000)


@pytest.mark.parametrize('trainer', ['vmf', 'spherical'])
@pytest.mark.parametrize('route', ['auto', 'loop'])
def test_integration_trainers_launch_their_kernels(cuda, trainer, route):
    """'auto' runs K10 once per iteration after the first and K1 in every
    M-step; 'loop' runs K12 once and K1 in the first M-step only."""
    from pb_bss_tpu_torch.models import GCACGMMTrainer, VMFCACGMMTrainer
    from pb_bss_tpu_torch.ops import eigh, integration_em, integration_em_loop
    g = torch.Generator(cuda).manual_seed(3)
    obs = torch.randn((65, 120, 6), dtype=torch.complex64, device=cuda,
                      generator=g)
    emb = torch.randn((65, 120, 8), device=cuda, generator=g)
    fit = (VMFCACGMMTrainer().fit if trainer == 'vmf' else
           lambda *a, **k: GCACGMMTrainer().fit(
               *a, covariance_type='spherical', **k))
    counters = (integration_em.e_stats, integration_em_loop.integration_em_full,
                eigh.eigh_jacobi)
    before = [c.launches for c in counters]
    model = fit(obs, emb, num_classes=3, iterations=5, use_fused_em=route)
    torch.cuda.synchronize()
    got = [c.launches - b for c, b in zip(counters, before)]
    assert got == ([4, 0, 5] if route == 'auto' else [0, 1, 1]), got
    aff = model.predict(obs, emb)
    assert torch.isfinite(aff).all()
    torch.testing.assert_close(aff.sum(-2), torch.ones_like(aff[:, 0]))


# ---------------------------------------------------------------------
# the redesigned whole-fit (K2) and streamed (K4) kernels across their
# D instantiations, and the four cACGMM kernels at the eigenvalue floor
# ---------------------------------------------------------------------

def _extras(N, K, T, device, seed):
    """Saliency (N, T) and a 0/1 source-activity mask (N, K, T) that
    silences class 1 in every frame of the first two bins."""
    g = torch.Generator(device).manual_seed(seed)
    sal = 0.2 + 0.8 * torch.rand((N, T), device=device, generator=g)
    mask = (torch.rand((N, K, T), device=device, generator=g) > 0.2).float()
    mask[:, 0] = torch.maximum(mask[:, 0], 1 - mask.amax(1))
    if K > 1:
        mask[:2, 1] = 0
    return sal, mask


@pytest.mark.parametrize('extras', [False, True], ids=['plain', 'sal+mask'])
@pytest.mark.parametrize('K', [1, 2, 3, 4, 5, 7])
@pytest.mark.parametrize('D', list(range(1, 17)))
def test_em_kernel_instantiations_match_plain(cuda, D, K, extras):
    """K2, one iteration, at every D (every template instantiation and
    frame group of the scatter) and K (every class group: 1-4, then 4 + 1
    and 4 + 3), with and without saliency and a mask, at T that cover
    every tail of a group of four frames and the gate's longest T at D=6,
    K=3 where the gate admits them."""
    from pb_bss_tpu_torch.ops.em_loop import fits, max_frames
    N = 17
    sweeps = 6 if D <= 8 else 8
    for T in (1, 3, 31, 303, 304, 305, max_frames(6, 3)):
        if not fits(D, K, T, extras, extras):
            continue
        y, aff = _unit_norm_mixture(N, D, K, T, cuda)
        qf = torch.ones_like(aff)
        kwargs = {}
        if extras:
            sal, mask = _extras(N, K, T, cuda, seed=D)
            kwargs = dict(saliency=sal, source_activity_mask=mask,
                          affiliation_eps=0.)
        before = cacgmm_em_full.launches
        out = cacgmm_em_full(y, aff, qf, iterations=1, sweeps=sweeps,
                             warm_sweeps=2, **kwargs)
        torch.cuda.synchronize()
        assert cacgmm_em_full.launches == before + 1
        ref = cacgmm_em_full_reference(y, aff, qf, iterations=1,
                                       sweeps=sweeps, **kwargs)
        assert all(bool(torch.isfinite(x).all()) for x in out), T
        # one cold iteration: f32 rounding of two Jacobi orders, E-steps
        # and orders of the scatter's sums
        torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=0,
                                   msg=lambda m: f'T={T}: {m}')
        torch.testing.assert_close(out[1], ref[1], atol=1e-4, rtol=0,
                                   msg=lambda m: f'T={T}: {m}')
        if T < D:
            # fewer frames than channels: every class's covariance has
            # rank T < D, its other eigenvalues sit at the floor (1e-10),
            # and the E-step's quadratic form is the Jacobi's rounding off
            # the frames' span times 1e10, so the posterior is rounding in
            # both (the kernel before the grouped scatter parts from the
            # twin there by up to 0.9 too); the M-step above is
            # well-posed and held, and of the posterior its sum over the
            # classes (1, or 0 where the mask silences every class)
            torch.testing.assert_close(out[3].sum(-2), ref[3].sum(-2),
                                       atol=2e-3, rtol=0)
        else:
            torch.testing.assert_close(out[3], ref[3], atol=2e-3, rtol=0,
                                       msg=lambda m: f'T={T}: {m}')
        if extras and K > 1:
            assert bool((out[3][:2, 1] == 0).all())
    # a warm fit stays finite and its weights sum to one
    out = cacgmm_em_full(y, aff, qf, iterations=5, sweeps=sweeps,
                         warm_sweeps=2, **kwargs)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in out)
    torch.testing.assert_close(out[0].sum(-1), torch.ones(N, device=cuda))


@pytest.mark.parametrize('T', [303, 304])
@pytest.mark.parametrize('D', [2, 4, 6, 8, 16])
def test_em_kernel_repeats_bit_for_bit(cuda, D, T):
    """Two launches of K2 on one input agree bit for bit: the scatter's
    cross-warp reduction runs in a fixed order, with no atomics."""
    N, K = 65, 3
    y, aff = _unit_norm_mixture(N, D, K, T, cuda)
    qf = torch.ones_like(aff)
    sal, mask = _extras(N, K, T, cuda, seed=D)
    kwargs = dict(iterations=20, sweeps=6 if D <= 8 else 8, warm_sweeps=2,
                  saliency=sal, source_activity_mask=mask)
    first = cacgmm_em_full(y, aff, qf, **kwargs)
    second = cacgmm_em_full(y, aff, qf, **kwargs)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_em_kernel_scatter_frames_as_the_host_has_them(cuda):
    """The frame group the kernel is compiled with at each D is the one
    ops.em_loop exposes (and lays out shared memory for)."""
    from pb_bss_tpu_torch.ops import _build, em_loop
    lib = _build.load('em_loop')
    assert [lib.cacgmm_em_full_scatter_frames(D) for D in em_loop.DIMS] \
        == [em_loop.scatter_frames(D) for D in em_loop.DIMS]


@pytest.mark.parametrize('extras', [False, True], ids=['plain', 'sal+mask'])
@pytest.mark.parametrize('K', [2, 3])
@pytest.mark.parametrize('D', [2, 6, 8, 16])
def test_stream_kernel_instantiations_match_plain(cuda, D, K, extras):
    """K4, one pass in each mode, at each D the paths reach, with and
    without saliency and a mask; and its partials repeat bit for bit."""
    from pb_bss_tpu_torch.ops.em_stream import (
        cacgmm_em_long_reference, e_stats, e_stats_reference)
    N, T = 33, 1301
    y, aff = _unit_norm_mixture(N, D, K, T, cuda)
    qf = torch.ones_like(aff)
    extra = {}
    if extras:
        sal, mask = _extras(N, K, T, cuda, seed=D + 1)
        extra = dict(saliency=sal, source_activity_mask=mask)
    weight, ev, vec = cacgmm_em_long_reference(y, aff, qf, iterations=1)
    for kwargs in (dict(affiliation=aff, quadratic_form=qf),
                   dict(eigenvalues=ev, eigenvectors=vec, weight=weight,
                        affiliation_eps=1e-10)):
        before = e_stats.launches
        s_k, a_k = e_stats(y, **kwargs, **extra)
        again = e_stats(y, **kwargs, **extra)
        torch.cuda.synchronize()
        assert e_stats.launches == before + 2
        assert torch.equal(s_k, again[0]) and torch.equal(a_k, again[1])
        assert torch.equal(s_k, s_k.conj().transpose(-1, -2))
        s_p, a_p = e_stats_reference(y, **kwargs, **extra)
        assert bool(torch.isfinite(s_k).all())
        # f32 sums over T in two orders: 1e-4 of the largest entry
        assert (s_k - s_p).abs().max() <= 1e-4 * s_p.abs().max()
        torch.testing.assert_close(a_k, a_p, rtol=1e-4, atol=0)


def _floor(make, *args, device):
    return {k: torch.as_tensor(v, device=device)
            for k, v in make(*args).items()}


def test_em_kernel_at_the_floor_matches_plain(cuda):
    """K2, one iteration from affiliations under which class 0's first
    M-step is rank-deficient: an eigenvalue at the floor or within f32
    rounding of zero, where an assembled inverse cancels. The M-step is
    held against the twin's, the E-step against the twin's E-step on the
    kernel's own model (the eigenvalue at zero is rounding noise in any
    f32 eigensolver, and the posterior follows it)."""
    from pb_bss_tpu_torch.models.cacgmm import CACGMM
    from pb_bss_tpu_torch.models.complex_angular_central_gaussian import (
        ComplexAngularCentralGaussian)
    from pb_bss_tpu_torch.testing.em_floor import affiliations_at_floor
    x = _floor(affiliations_at_floor, 65, 6, 3, 304, 110, device=cuda)
    args = (x['y'], x['affiliation'], x['quadratic_form'])
    out = cacgmm_em_full(*args, iterations=1, warm_sweeps=2,
                         affiliation_eps=0.)
    ref = cacgmm_em_full_reference(*args, iterations=1, affiliation_eps=0.)
    model = CACGMM(weight=out[0][..., None], cacg=(
        ComplexAngularCentralGaussian(covariance_eigenvectors=out[2],
                                      covariance_eigenvalues=out[1])))
    e_step = model._predict(x['y'], affiliation_eps=0.)[0]
    torch.cuda.synchronize()
    assert bool((ref[1][:, 0, 0] <= 1e-6).all())
    torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(out[1], ref[1], atol=1e-4, rtol=0)
    c_k, c_p = _covariance(out[2], out[1]), _covariance(ref[2], ref[1])
    assert (c_k - c_p).abs().max() <= 1e-4 * c_p.abs().max()
    torch.testing.assert_close(out[3], e_step, atol=2e-3, rtol=0)


def test_stream_kernel_at_the_floor_matches_plain(cuda):
    from pb_bss_tpu_torch.ops.em_stream import e_stats, e_stats_reference
    from pb_bss_tpu_torch.testing.em_floor import model_at_floor
    x = _floor(model_at_floor, 65, 6, 3, 1777, 111, device=cuda)
    kw = dict(eigenvalues=x['eigenvalues'], eigenvectors=x['eigenvectors'],
              weight=x['weight'], affiliation_eps=1e-10)
    s_k, a_k = e_stats(x['y'], **kw)
    s_p, a_p = e_stats_reference(x['y'], **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(s_k).all())
    assert (s_k - s_p).abs().max() <= 1e-4 * s_p.abs().max()
    torch.testing.assert_close(a_k, a_p, rtol=1e-4, atol=0)


def test_fc_kernels_at_the_floor_match_plain(cuda):
    from pb_bss_tpu_torch.ops import em_step
    from pb_bss_tpu_torch.testing.em_floor import (
        affiliations_at_floor, model_at_floor)
    B, F, D, K, T = 2, 33, 6, 3, 304
    x = _floor(affiliations_at_floor, B * F, D, K, T, 112, device=cuda)
    args = (x['y'], x['affiliation'], x['quadratic_form'])
    init = dict(sweeps=6, eigenvalue_floor=1e-10)
    init_k = em_step.m_init(*args, **init)
    init_p = em_step.m_init_reference(*args, **init)
    x = _floor(model_at_floor, B * F, D, K, T, 113, device=cuda)
    weight = x['weight'].reshape(B, F, K).mean(1)
    step = dict(warm_sweeps=2, eigenvalue_floor=1e-10, affiliation_eps=1e-10)
    args = (x['y'], x['eigenvalues'], x['eigenvectors'], weight)
    step_k = em_step.em_step(*args, **step)
    step_p = em_step.em_step_reference(*args, **step)
    torch.cuda.synchronize()
    for (vk, ek, ak), (vp, ep, ap) in ((init_k, init_p),
                                       (step_k[:3], step_p[:3])):
        assert bool(torch.isfinite(ek).all() and torch.isfinite(vk).all())
        assert _lam_close(ek, ep, 1e-4)
        c_k, c_p = _covariance(vk, ek), _covariance(vp, ep)
        assert (c_k - c_p).abs().max() <= 1e-4 * c_p.abs().max()
        torch.testing.assert_close(ak, ap, rtol=1e-4, atol=0)


def test_e_step_kernels_at_the_floor_match_plain(cuda):
    from pb_bss_tpu_torch.ops.em_estep import (
        cacgmm_e_step, cacgmm_e_step_reference, cacgmm_em_scatter,
        cacgmm_em_scatter_reference)
    from pb_bss_tpu_torch.testing.em_floor import model_at_floor
    x = _floor(model_at_floor, 65, 6, 3, 304, 114, device=cuda)
    y, vec, ev = x['y'], x['eigenvectors'], x['eigenvalues']
    args = (y.real.contiguous(), y.imag.contiguous(), vec.real.contiguous(),
            vec.imag.contiguous(), 1. / ev, torch.log(ev).sum(-1),
            x['weight'])
    aff_k, qf_k = cacgmm_e_step(*args)
    aff_p, qf_p = cacgmm_e_step_reference(*args)
    s_k = cacgmm_em_scatter(*args)
    s_p = cacgmm_em_scatter_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(aff_k, aff_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(qf_k, qf_p, rtol=1e-4, atol=0)
    scale = max(s_p[0].abs().max(), s_p[1].abs().max())
    for i in (0, 1):
        assert (s_k[i] - s_p[i]).abs().max() <= 1e-4 * scale
    torch.testing.assert_close(s_k[2], s_p[2], rtol=1e-4, atol=0)


# ---------------------------------------------------------------------
# the redesigned frequency-constant EM (K5) and whole-fit Bingham EM
# (K9) across their D instantiations
# ---------------------------------------------------------------------

@pytest.mark.parametrize('extras', [False, True],
                         ids=['plain', 'sal+mask+posterior'])
@pytest.mark.parametrize('K', [1, 3, 5])
@pytest.mark.parametrize('D', list(range(1, 17)))
def test_fc_kernel_instantiations_match_plain(cuda, D, K, extras):
    """K5's init and one step at each D its wrapper reaches (1..16), with
    and without saliency, a source-activity mask and the emitted
    posterior, against their twins. The step runs as many sweeps as the
    init, so that the column Jacobi's round-robin order and the twin's
    cyclic one both converge to f32 rounding."""
    from pb_bss_tpu_torch.ops import em_step
    B, F, T = 2, 9, 157
    N = B * F
    y, aff = _unit_norm_mixture(N, D, K, T, cuda)
    qf = torch.ones_like(aff)
    sal = mask = None
    if extras:
        sal, mask = _extras(N, K, T, cuda, seed=D) if K > 1 else (
            _extras(N, 2, T, cuda, seed=D)[0], None)
    sweeps = 6 if D <= 8 else 8
    init = dict(sweeps=sweeps, eigenvalue_floor=1e-10, saliency=sal)
    before = (em_step.m_init.launches, em_step.em_step.launches)
    vec_k, ev_k, asum_k = em_step.m_init(y, aff, qf, **init)
    vec_p, ev_p, asum_p = em_step.m_init_reference(y, aff, qf, **init)
    weight = asum_p.reshape(B, F, K).sum(1)
    weight = weight / weight.sum(-1, keepdim=True)
    step = dict(warm_sweeps=sweeps, eigenvalue_floor=1e-10,
                affiliation_eps=0. if extras else 1e-10, saliency=sal,
                source_activity_mask=mask, emit_affiliation=extras)
    out_k = em_step.em_step(y, ev_p, vec_p, weight, **step)
    out_p = em_step.em_step_reference(y, ev_p, vec_p, weight, **step)
    torch.cuda.synchronize()
    assert (em_step.m_init.launches, em_step.em_step.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(asum_k, asum_p, rtol=1e-4, atol=0)
    torch.testing.assert_close(out_k[2], out_p[2], rtol=1e-4, atol=1e-6)
    if extras:
        torch.testing.assert_close(out_k[3], out_p[3], atol=2e-3, rtol=0)
        if mask is not None:
            assert bool((out_k[3][:2, 1] == 0).all())
    else:
        assert out_k[3] is None
    for (vk, ek), (vp, ep) in (((vec_k, ev_k), (vec_p, ev_p)),
                               ((out_k[0], out_k[1]), (out_p[0], out_p[1]))):
        assert bool(torch.isfinite(ek).all() and torch.isfinite(vk).all())
        # two f32 Jacobi orders and sums over T in two orders: 1e-4 of the
        # largest eigenvalue and covariance entry
        assert _lam_close(ek.sort(-1).values, ep.sort(-1).values, 1e-4)
        ck, cp = _covariance(vk, ek), _covariance(vp, ep)
        assert (ck - cp).abs().max() <= 1e-4 * cp.abs().max()


@pytest.mark.parametrize('extras', [False, True], ids=['plain', 'sal+mc'])
@pytest.mark.parametrize('K', [1, 3, 5])
@pytest.mark.parametrize('D', list(range(2, 9)))
def test_bingham_whole_fit_kernel_instantiations_match_plain(cuda, D, K,
                                                             extras):
    """K9, one cold iteration, at each D its wrapper reaches (2..8), with
    and without saliency and a finite max_concentration, against its twin:
    the weights to 1e-5, the eigenvalues (where |lambda| < 300: a moment
    <~ 1e-3 leaves its eigenvalue flat) to 5e-2 relative and 1e-3 at the
    median, the eigenvectors phase-aligned, the posteriors on average;
    then a 3-iteration fit stays finite with weights summing to one."""
    from pb_bss_tpu_torch.ops.cbmm_loop import (
        cbmm_em_full, cbmm_em_full_reference)
    N, T = 17, 150
    y, aff = _cbmm_mixture(N, D, K, T, cuda, seed=D)
    kw = {}
    if extras:
        g = torch.Generator(cuda).manual_seed(20 + D)
        kw = dict(saliency=0.2 + 0.8 * torch.rand((N, T), device=cuda,
                                                   generator=g),
                  max_concentration=50.)
    before = cbmm_em_full.launches
    out = cbmm_em_full(y, aff, iterations=1, **kw)
    torch.cuda.synchronize()
    assert cbmm_em_full.launches == before + 1
    ref = cbmm_em_full_reference(y, aff, iterations=1, **kw)
    assert all(bool(torch.isfinite(x).all()) for x in out)
    torch.testing.assert_close(out[0], ref[0], atol=1e-5, rtol=0)
    rel = (out[1] - ref[1]).abs() / (1 + ref[1].abs())
    well = ref[1].abs() < 300
    assert rel[well].max() < 5e-2 and rel.median() < 1e-3
    inner = torch.einsum('...dk,...dk->...k', out[2].conj(), ref[2]).abs()
    assert inner.min() > 1 - 1e-3, inner.min()
    assert (out[4] - ref[4]).abs().mean() < 5e-3
    out = cbmm_em_full(y, aff, iterations=3, **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in out)
    torch.testing.assert_close(out[0].sum(-1), torch.ones(N, device=cuda))


# ---------------------------------------------------------------------
# the redesigned whole-fit Watson (K6) and integration (K12) kernels
# across their D instantiations
# ---------------------------------------------------------------------

@pytest.mark.parametrize('extras', [False, True], ids=['plain', 'sal+silence'])
@pytest.mark.parametrize('K', [1, 3, 5])
@pytest.mark.parametrize('D', list(range(1, 17)))
def test_watson_whole_fit_kernel_instantiations_match_plain(cuda, D, K,
                                                            extras):
    """K6 at each D of its template (1..16), with and without saliency and
    a class silenced in four bins: one (cold) iteration against its twin
    at the one-iteration tolerances, and the 20-iteration fit (warm
    Jacobi) by the argmax of the posteriors."""
    from pb_bss_tpu_torch.ops.cwmm_loop import (
        cwmm_em_full, cwmm_em_full_reference)
    N, T = 17, 157
    y, aff = _cbmm_mixture(N, D, K, T, cuda, seed=30 + D)
    sal = None
    if extras:
        g = torch.Generator(cuda).manual_seed(40 + D)
        sal = 0.2 + 0.8 * torch.rand((N, T), device=cuda, generator=g)
        if K > 1:
            aff[:4, 1] = 0
            aff = aff / aff.sum(-2, keepdim=True)
    before = cwmm_em_full.launches
    out = cwmm_em_full(y, aff, iterations=1, warm_sweeps=2, saliency=sal)
    torch.cuda.synchronize()
    assert cwmm_em_full.launches == before + 1
    ref = cwmm_em_full_reference(y, aff, iterations=1, saliency=sal)
    # one cold iteration: f32 rounding of two Jacobi and E-step orderings;
    # kappa through the steep table
    _watson_close(out, ref, weight=1e-5, kappa_rtol=1e-3, overlap=1e-4,
                  aff=2e-3)
    out = cwmm_em_full(y, aff, iterations=20, warm_sweeps=2, saliency=sal)
    ref = cwmm_em_full_reference(y, aff, iterations=20, saliency=sal)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in out)
    if extras and K > 1:
        assert (out[0][:4, 1] == 0).all()
    agree = (out[3].argmax(-2) == ref[3].argmax(-2)).float().mean()
    assert agree > 0.9, agree


def _separable_integration(N, D, K, T, E, U, device, seed):
    """Observations and embeddings with one class per frame: a steering
    vector per (bin, class) and an embedding centre per (utterance,
    class), so that the integration EM is well-conditioned."""
    g = torch.Generator(device).manual_seed(seed)

    def cn(*shape):
        return torch.complex(torch.randn(shape, generator=g, device=device),
                             torch.randn(shape, generator=g, device=device))
    label = torch.randint(K, (N, T), generator=g, device=device)
    steer = torch.gather(cn(N, K, D), 1, label[..., None].expand(N, T, D))
    y = steer.transpose(1, 2) * cn(N, 1, T) + 0.1 * cn(N, D, T)
    y = y / torch.linalg.vector_norm(y, dim=1, keepdim=True)
    centres = torch.randn((U, K, E), generator=g, device=device)
    utterance = torch.arange(N, device=device)[:, None] // (N // U)
    emb = (centres[utterance, label] + 0.3 * torch.randn(
        (N, T, E), generator=g, device=device)).transpose(1, 2)
    return y, emb.contiguous()


def _integration_next_posterior(y, emb, out, mode, spherical, F):
    """The posterior of the E-step after a whole fit: its cACG state and
    weights, and the spectral model finished from its last accumulators
    as the kernel finishes it."""
    from pb_bss_tpu_torch.ops import integration_em, integration_em_loop as il
    lam, vec, weight, acc = out
    K, E = weight.shape[-1], emb.shape[-2]
    table = None
    if mode == 'vmf':
        s0, ds, values = il.vmf_log_norm_table(E, 1e-10, 500.)
        table = (s0, ds, torch.as_tensor(values, device=y.device))
    spec = [x.repeat_interleave(F, 0) for x in il.spectral_m_step_reference(
        acc, E=E, K=K, spectral_mode=mode, spherical=spherical, table=table)]
    return integration_em.e_step_reference(
        y, emb, eigenvalues=lam, eigenvectors=vec, weight=weight,
        mu=spec[0], kappa=spec[1], log_c=spec[2], spectral_mode=mode)[0]


@pytest.mark.parametrize('U', [1, 2])
@pytest.mark.parametrize('model', ['vmf', 'spherical', 'diagonal'])
@pytest.mark.parametrize('D', list(range(1, 17)))
def test_integration_whole_fit_kernel_instantiations_match_plain(cuda, D,
                                                                 model, U):
    """K12 at each D of its template (1..16), in the vMF and the Gaussian
    (spherical and diagonal) modes, one utterance and two folded: one
    iteration against its twin (weights and covariances to 1e-5, the
    accumulators to 1e-5 of their largest entry), and the 20-iteration
    fit on separable data by the argmax of the next E-step's posterior."""
    from pb_bss_tpu_torch.ops import integration_em_loop as il
    N, K, T, E = 17 * U, 3, 60, 5
    mode = 'vmf' if model == 'vmf' else 'gaussian'
    spherical = model != 'diagonal'
    _, _, ev, vec, w, spec, _ = _integration_inputs(N, D, K, T, E, U, mode,
                                                    cuda, seed=50 + D)
    y, emb = _separable_integration(N, D, K, T, E, U, cuda, seed=60 + D)
    kw = dict(bins_per_utt=N // U, spectral_mode=mode, spherical=spherical)
    before = il.integration_em_full.launches
    out = il.integration_em_full(y, emb, vec, ev, w, *spec, iterations=1,
                                 **kw)
    torch.cuda.synchronize()
    assert il.integration_em_full.launches == before + 1
    ref = il.integration_em_full_reference(y, emb, vec, ev, w, *spec,
                                           iterations=1, **kw)
    # one iteration: the same sums in two orders and two f32 Jacobi runs
    torch.testing.assert_close(out[2], ref[2], atol=1e-5, rtol=0)
    torch.testing.assert_close(_covariance(out[1], out[0]),
                               _covariance(ref[1], ref[0]), atol=1e-5,
                               rtol=0)
    assert (out[3] - ref[3]).abs().max() <= 1e-5 * ref[3].abs().max()
    out = il.integration_em_full(y, emb, vec, ev, w, *spec, iterations=20,
                                 **kw)
    ref = il.integration_em_full_reference(y, emb, vec, ev, w, *spec,
                                           iterations=20, **kw)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in out)
    p_k = _integration_next_posterior(y, emb, out, mode, spherical, N // U)
    p_p = _integration_next_posterior(y, emb, ref, mode, spherical, N // U)
    agree = (p_k.argmax(-2) == p_p.argmax(-2)).float().mean()
    assert agree > 0.9, agree


# (K3, K1) launches of one get_bf_vector call on a batch the kernels take
BF_LAUNCHES = {
    'gev+ban': (1, 0), 'mvdr_souden': (0, 1), 'mvdr_souden+ban': (0, 1),
    'wmwf': (0, 1), 'rank1_gev+mvdr_souden+ban': (1, 1),
    'scaled_gev_atf+mvdr': (1, 1), 'rank1_pca+mvdr_souden': (0, 2),
    'pca+mvdr': (0, 2), 'pca': (0, 1), 'ch0': (0, 0)}
BF_PHASE_FREE = {'gev+ban', 'scaled_gev_atf+mvdr', 'pca+mvdr', 'pca'}


def _class_psds(B, K, F, D, device, seed):
    g = torch.Generator(device).manual_seed(seed)
    a = torch.randn((B, K, F, D, 2 * D), dtype=torch.complex64,
                    device=device, generator=g)
    psds = a @ a.conj().transpose(-1, -2) / (2 * D) \
        + 0.05 * torch.eye(D, dtype=torch.complex64, device=device)
    return psds, psds.sum(1, keepdim=True) - psds


@pytest.mark.parametrize('name', sorted(BF_LAUNCHES))
def test_get_bf_vector_launches_and_matches_plain(cuda, name):
    from pb_bss_tpu_torch.extraction import get_bf_vector
    from pb_bss_tpu_torch.ops.eigh import eigh_jacobi
    psds, phi_nn = _class_psds(2, 3, 33, 6, cuda, seed=3)
    before = gev.launches, eigh_jacobi.launches
    out = get_bf_vector(name, psds, phi_nn)
    torch.cuda.synchronize()
    assert (gev.launches - before[0],
            eigh_jacobi.launches - before[1]) == BF_LAUNCHES[name]
    ref = get_bf_vector(name, psds.cpu(), phi_nn.cpu())
    out = out.cpu()
    assert torch.isfinite(out).all()
    if name in BF_PHASE_FREE:
        inner = (ref.conj() * out).sum(-1, keepdim=True)
        out = out / (inner / inner.abs())
    # f32 LU and Jacobi sweeps on the card against the CPU's
    torch.testing.assert_close(out, ref, atol=2e-3 * ref.abs().max(),
                               rtol=2e-3)


def test_stable_solve_is_one_jacobi_launch_with_no_host_sync(cuda):
    from pb_bss_tpu_torch.ops.eigh import eigh_jacobi
    from pb_bss_tpu_torch.ops.linalg import stable_solve
    g = torch.Generator(cuda).manual_seed(4)
    a = torch.randn((600, 6, 6), dtype=torch.complex64, device=cuda,
                    generator=g)
    b = torch.randn((600, 6, 2), dtype=torch.complex64, device=cuda,
                    generator=g)
    a[3] = 0
    a[5, :, 0] = a[5, :, 1]
    a[7] *= float('inf')
    stable_solve(a, b)  # build and load the kernel first
    torch.cuda.synchronize()
    before = eigh_jacobi.launches
    torch.cuda.set_sync_debug_mode('error')
    try:
        x = stable_solve(a, b)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert eigh_jacobi.launches == before + 1
    ref = stable_solve(a.cpu(), b.cpu())
    finite = torch.ones(600, dtype=torch.bool)
    finite[7] = False
    assert torch.isfinite(x.cpu()[finite]).all()
    assert not torch.isfinite(x.cpu()[7]).all()
    torch.testing.assert_close(x.cpu()[finite], ref[finite], atol=1e-3,
                               rtol=1e-3)


def test_separate_batch_fca_launches_jacobi_per_ip_row(cuda):
    from pb_bss_tpu_torch import separate_batch
    from pb_bss_tpu_torch.ops.eigh import eigh_jacobi
    g = torch.Generator(cuda).manual_seed(5)
    obs = torch.randn((2, 6, 8000), device=cuda, generator=g)
    before = eigh_jacobi.launches
    out = separate_batch(obs, iterations=3, refine='fca',
                         refine_iterations=2)
    torch.cuda.synchronize()
    # a stable solve per IP row (D=6) per iteration, and one for Q^-1
    assert eigh_jacobi.launches - before == 2 * 6 + 1
    assert out.shape == (2, 3, 8000) and torch.isfinite(out).all()


@pytest.mark.parametrize('beamformer', [None, 'gev+ban'])
def test_streaming_launches_per_mode(cuda, beamformer):
    """StreamingSeparator on the card: the warm-up fit is one K2 launch,
    each streamed block's M-step one K1 launch (inner_iterations=1), and
    in 'gev+ban' mode each synthesized block one K3 launch (the
    warm-up's catch-up blocks included)."""
    from pb_bss_tpu_torch import StreamingSeparator
    from pb_bss_tpu_torch.ops.eigh import eigh_jacobi
    g = np.random.default_rng(7)
    x = g.standard_normal((3, 2048 * 7)).astype(np.float32)
    sep = StreamingSeparator(num_classes=2, init_frames=32,
                             beamformer=beamformer)
    before = (cacgmm_em_full.launches, eigh_jacobi.launches, gev.launches)
    out = np.concatenate([sep.process(x), sep.flush()], axis=-1)
    torch.cuda.synchronize()
    after = (cacgmm_em_full.launches, eigh_jacobi.launches, gev.launches)
    warm, streamed = 2, 5  # 7 blocks, the first two the warm-up
    assert tuple(a - b for a, b in zip(after, before)) == (
        1, streamed, warm + streamed if beamformer else 0)
    assert out.shape == (2, 2048 * 7 + 384) and np.isfinite(out).all()


@pytest.mark.parametrize('beamformer', [None, 'gev+ban'])
def test_streaming_card_against_cpu_for_one_block(cuda, beamformer):
    """After warm-up the card's snapshot loads into a CPU separator and
    both take the next block: posteriors within 1e-4, outputs within
    1e-4 (mask) / 1e-3 (GEV) of their peak."""
    from pb_bss_tpu_torch import StreamingSeparator
    g = np.random.default_rng(8)
    x = g.standard_normal((4, 2048 * 3)).astype(np.float32)
    kwargs = dict(num_classes=3, init_frames=32, beamformer=beamformer)
    card = StreamingSeparator(**kwargs)
    card.process(x[:, :4096])
    cpu = StreamingSeparator(device='cpu', **kwargs).load_state_dict(
        card.state_dict())
    out_card = card.process(x[:, 4096:])
    out_cpu = cpu.process(x[:, 4096:])
    post = (card._aff_hist[..., -16:].cpu() - cpu._aff_hist[..., -16:])
    assert float(post.abs().max()) <= 1e-4
    rtol = 1e-3 if beamformer else 1e-4
    assert np.abs(out_card - out_cpu).max() <= rtol * np.abs(out_cpu).max()


# ---------------------------------------------------------------------
# the evaluation layer and the transforms (torch.fft / torch.linalg on
# the card, no kernel of their own): the card in float32 against the
# port's host float64 oracles at the JAX package's float32 bounds, and
# the transforms against the same call on the CPU
# ---------------------------------------------------------------------

def _eval_scene(samples=16000, utterances=2):
    from pb_bss_tpu_torch.testing import low_reverberation_data
    sources, estimates = [], []
    for seed in range(utterances):
        d = low_reverberation_data(seed)
        images = d['speech_image'][:, 0, :samples]
        rng = np.random.RandomState(seed)
        noise = d['noise_image'][0, :samples] + 0.3 * rng.randn(samples)
        estimates.append(np.stack([images[1] + 0.2 * images[0], noise,
                                   images[0] + 0.1 * images[1]]))
        sources.append(d['speech_source'][:, :samples])
    return np.stack(sources), np.stack(estimates)


def test_output_metrics_batch_on_the_card_matches_the_host(cuda):
    from pb_bss_tpu_torch.evaluation import OutputMetrics, OutputMetricsBatch
    sources, estimates = _eval_scene()
    card = OutputMetricsBatch(
        torch.as_tensor(estimates, dtype=torch.float32, device=cuda),
        torch.as_tensor(sources, dtype=torch.float32, device=cuda),
        sample_rate=8000, enable_si_sdr=True, device='cuda').as_dict()
    for b in range(len(sources)):
        host = OutputMetrics(
            estimates[b].astype(np.float32).astype(np.float64),
            sources[b].astype(np.float32).astype(np.float64),
            sample_rate=8000, enable_si_sdr=True, device='cpu').as_dict()
        np.testing.assert_array_equal(card['mir_eval_selection'][b],
                                      host['mir_eval_selection'])
        for key in ('mir_eval_sdr', 'mir_eval_sir', 'mir_eval_sar',
                    'si_sdr'):
            np.testing.assert_allclose(card[key][b], host[key], atol=0.05)
        np.testing.assert_allclose(card['stoi'][b], host['stoi'], atol=2e-3)
        np.testing.assert_allclose(card['srmr'][b], host['srmr'],
                                   rtol=2e-3)


def test_input_metrics_batch_on_the_card_matches_the_host(cuda):
    from pb_bss_tpu_torch.evaluation import InputMetrics, InputMetricsBatch
    sources, estimates = _eval_scene(utterances=1)
    observation = estimates[:, :2] + 0.5 * estimates[:, 2:]
    card = InputMetricsBatch(
        torch.as_tensor(observation, device=cuda, dtype=torch.float32),
        torch.as_tensor(sources, device=cuda, dtype=torch.float32),
        sample_rate=8000, device='cuda').as_dict()
    host = InputMetrics(observation[0].astype(np.float32).astype(float),
                        sources[0].astype(np.float32).astype(float),
                        sample_rate=8000, device='cpu').as_dict()
    for key in ('mir_eval_sdr', 'mir_eval_sir', 'mir_eval_sar'):
        np.testing.assert_allclose(card[key][0], host[key], atol=0.05)
    np.testing.assert_allclose(card['stoi'][0], host['stoi'], atol=2e-3)
    np.testing.assert_allclose(card['srmr'][0], host['srmr'], rtol=2e-3)


def test_metric_programs_on_the_card_match_the_cpu(cuda):
    """float64 on the card against float64 on the CPU: the same
    programs, so the gaps are rounding."""
    from pb_bss_tpu_torch.evaluation import (
        bss_eval_sources_batch, srmr_batch, stoi_batch)
    sources, estimates = _eval_scene()
    for device in ('cuda', 'cpu'):
        out = bss_eval_sources_batch(sources, estimates, device=device)
        st = stoi_batch(sources, estimates[:, [2, 0]], 8000, device=device)
        sr = srmr_batch(estimates, 8000, device=device)
        if device == 'cuda':
            card = out, st, sr
    np.testing.assert_array_equal(card[0]['selection'], out['selection'])
    for key in ('sdr', 'sir', 'sar'):
        np.testing.assert_allclose(card[0][key], out[key], atol=1e-6)
    np.testing.assert_allclose(card[1], st, atol=1e-9)
    np.testing.assert_allclose(card[2], sr, rtol=1e-9)


def test_transforms_on_the_card_match_the_cpu(cuda):
    from pb_bss_tpu_torch.transform import gammatone_filterbank, stft
    from pb_bss_tpu_torch.transform.griffin_lim_module import (
        griffin_lim, misi)
    sources, estimates = _eval_scene(utterances=1)
    x = torch.as_tensor(estimates[0, [0, 2]], dtype=torch.float32)
    for method, rtol in (('fft', 1e-5), ('scan', 1e-3)):
        card = gammatone_filterbank(x.to(cuda), 8000, method=method).cpu()
        cpu = gammatone_filterbank(x, 8000, method=method)
        assert float((card - cpu).abs().max()) <= rtol * float(
            cpu.abs().max())
    X = stft(x, fading=False)
    y = x.sum(0)
    for card, cpu in ((griffin_lim(X.to(cuda), 10).cpu(), griffin_lim(X, 10)),
                      (misi(X.to(cuda), y.to(cuda), 10).cpu(),
                       misi(X, y, 10))):
        assert float((card - cpu).abs().max()) <= 1e-4 * float(
            cpu.abs().max())


def test_metric_entry_points_raise_without_cuda(monkeypatch):
    """device='cuda' (the default) never drops to the CPU; runs on any
    machine."""
    from pb_bss_tpu_torch.evaluation import (
        InputMetrics, InputMetricsBatch, OutputMetrics, OutputMetricsBatch,
        bss_eval_sources_batch, srmr_batch, stoi_batch)
    from pb_bss_tpu_torch.transform import gammatone_filterbank
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    sources, estimates = _eval_scene(samples=4000, utterances=1)
    calls = (
        lambda: bss_eval_sources_batch(sources, estimates),
        lambda: stoi_batch(sources, sources, 8000),
        lambda: srmr_batch(sources, 8000),
        lambda: gammatone_filterbank(sources[0], 8000),
        lambda: OutputMetrics(estimates[0], sources[0]),
        lambda: InputMetrics(estimates[0], sources[0]),
        lambda: OutputMetricsBatch(estimates, sources),
        lambda: InputMetricsBatch(estimates, sources))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
