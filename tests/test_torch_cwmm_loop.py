"""The whole-fit complex Watson EM of the port (ops/cwmm_loop.py: the
plain twin of kernel K6, and the trainer's whole-fit route on the CPU)
against the JAX package on the same numpy inputs.

The twin inverts the eigenvalue ratio through the uniform 512-point
table, as the JAX kernel does, so it is held against the JAX scan path
(log-spaced table) with the JAX suite's own tolerances
(tests/test_ops/test_pallas_cwmm_loop.py), and against the JAX kernel in
interpret mode (the same table) tightly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.cwmm import CWMMTrainer as JaxTrainer
from pb_bss_tpu.ops import pallas_cwmm_loop
from pb_bss_tpu_torch.models.cwmm import CWMMTrainer
from pb_bss_tpu_torch.ops import cwmm_loop

torch.set_num_threads(2)


def _mixture(F=15, D=4, T=48, K=2, seed=0, batch=None):
    """Observations clustered around K random modes (the JAX suite's
    scenario), unit-norm (..., F, T, D) complex64, and random initial
    affiliations (..., F, K, T)."""
    rng = np.random.default_rng(seed)
    lead = (F,) if batch is None else (batch, F)
    modes = rng.standard_normal((*lead, K, D)) + 1j * rng.standard_normal(
        (*lead, K, D))
    modes /= np.linalg.norm(modes, axis=-1, keepdims=True)
    y = np.repeat(modes, T // K, axis=-2) + 0.3 * (
        rng.standard_normal((*lead, T, D))
        + 1j * rng.standard_normal((*lead, T, D)))
    y = (y / np.linalg.norm(y, axis=-1, keepdims=True)).astype(np.complex64)
    aff = rng.uniform(size=(*lead, K, T))
    aff = (aff / aff.sum(-2, keepdims=True)).astype(np.float32)
    return y, aff


def _modes_aligned(a, b, tol):
    inner = np.abs(np.einsum('...d,...d->...', np.asarray(a).conj(),
                             np.asarray(b)))
    assert inner.min() > 1 - tol, inner.min()


@pytest.mark.parametrize('case', ['plain', 'saliency', 'batched'])
def test_twin_matches_the_jax_scan_path(case):
    y, aff = _mixture(batch=2 if case == 'batched' else None, seed=1)
    saliency = None
    if case == 'saliency':
        saliency = np.random.default_rng(2).uniform(
            0.3, 1., y.shape[:-1]).astype(np.float32)
    y_dt = torch.as_tensor(y).transpose(-1, -2)
    weight, mode, kappa, posterior = cwmm_loop.cwmm_em_full(
        y_dt, torch.as_tensor(aff), iterations=4, warm_sweeps=2,
        saliency=None if saliency is None else torch.as_tensor(saliency))
    assert posterior.shape == aff.shape and mode.dtype == torch.complex64
    for b in range(y.shape[0] if case == 'batched' else 1):
        sel = (b,) if case == 'batched' else ()
        scan = JaxTrainer().fit(
            jnp.asarray(y[sel]), initialization=jnp.asarray(aff[sel]),
            iterations=4, use_fused_em=False,
            saliency=None if saliency is None else jnp.asarray(saliency))
        assert_allclose(weight[sel].numpy(), np.asarray(scan.weight[..., 0]),
                        atol=2e-3)
        assert_allclose(kappa[sel].numpy(),
                        np.asarray(scan.complex_watson.concentration),
                        rtol=2e-2, atol=0.3)
        _modes_aligned(mode[sel], scan.complex_watson.mode, 1e-3)


def test_trainer_whole_fit_route_returns_the_predict_posterior():
    """use_fused_em=True on the CPU runs the twin; its final E-step is
    the fitted model's predict, and its weights match the scan path's."""
    y, aff = _mixture(seed=3)
    Y = torch.as_tensor(y)
    before = cwmm_loop.cwmm_em_full.launches
    model, posterior = CWMMTrainer().fit(
        Y, initialization=torch.as_tensor(aff), iterations=3,
        use_fused_em=True, _return_affiliation=True)
    assert cwmm_loop.cwmm_em_full.launches == before  # CPU: no launch
    scan = CWMMTrainer().fit(Y, initialization=torch.as_tensor(aff),
                             iterations=3, use_fused_em=False)
    torch.testing.assert_close(posterior, model.predict(Y), atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(model.weight, scan.weight, atol=5e-3, rtol=0)
    assert model.weight.shape == (15, 2, 1)


def test_concentration_table_inverts_the_forward_map():
    from scipy.special import hyp1f1
    D = 6
    r0, dr, table = cwmm_loop.concentration_table(D)
    grid = r0 + dr * np.arange(table.shape[0])
    sel = (table > 1e-3) & (table < 100)
    k = table[sel]
    ratio = hyp1f1(2, D + 1, k) / (D * hyp1f1(1, D, k))
    assert_allclose(ratio, grid[sel], atol=2e-3)


@pytest.mark.parametrize('D', [3, 6])
def test_concentration_table_equals_jax(D):
    ours = cwmm_loop.concentration_table(D, 500.0)
    theirs = pallas_cwmm_loop.concentration_table(D, 500.0)
    assert ours[:2] == theirs[:2]
    assert np.array_equal(ours[2], theirs[2])


def test_table_lookup_matches_the_hat_function_sum():
    """The twin's indexed lookup equals the JAX kernel's dense hat-function
    sum over the table."""
    r0, dr, table = cwmm_loop.concentration_table(6)
    lam = np.concatenate([[0., r0, 1.], np.random.default_rng(4).uniform(
        r0, 1., 200)]).astype(np.float32)
    ours = cwmm_loop.table_concentration(
        torch.as_tensor(lam), r0, dr, torch.as_tensor(table)).numpy()
    idx = np.clip((lam - r0) / dr, 0, table.shape[0] - 1)
    hat = np.maximum(0, 1 - np.abs(idx[:, None] - np.arange(table.shape[0])))
    assert_allclose(ours, hat @ table, rtol=1e-5, atol=1e-5)


def test_kernel_gate():
    assert cwmm_loop.max_frames(6, 3) == 3827
    assert cwmm_loop.fits(6, 3, 3827) and not cwmm_loop.fits(6, 3, 3828)
    assert cwmm_loop.max_frames(6, 3, has_sal=True) == 3588
    assert not cwmm_loop.fits(6, 3, 3600, has_sal=True)
    assert cwmm_loop.fits(16, 3, 300) and not cwmm_loop.fits(17, 3, 10)
    # a minute at 8 kHz (T=3753) stays inside the whole fit
    assert cwmm_loop.fits(6, 3, 3753)


@pytest.mark.slow
def test_twin_matches_pallas_interpret():
    """The twin against the Pallas kernel itself (interpret mode, cold
    Jacobi every iteration like the twin), 4 iterations, ragged T."""
    y, aff = _mixture(T=38, seed=5)
    y_dt = np.swapaxes(y, -1, -2)
    ref = pallas_cwmm_loop.cwmm_em_full(
        jnp.asarray(y_dt.real), jnp.asarray(y_dt.imag), jnp.asarray(aff),
        iterations=4, interpret=True)
    out = cwmm_loop.cwmm_em_full_reference(
        torch.as_tensor(y_dt), torch.as_tensor(aff), iterations=4)
    assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-4)
    assert_allclose(out[2].numpy(), np.asarray(ref[2]), rtol=1e-3,
                    atol=1e-3)
    _modes_aligned(out[1], ref[1], 1e-4)
    assert_allclose(out[3].numpy(), np.asarray(ref[3]), atol=5e-3)
