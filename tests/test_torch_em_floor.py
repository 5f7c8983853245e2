"""The cACGMM EM at its eigenvalue floor (pb_bss_tpu_torch.testing.em_floor):
the inputs on which chip_smoke.py holds the whole-fit, streamed,
frequency-constant and opt-in E-step kernels against their twins, checked
here on the CPU against the JAX package's XLA scan path on the same numpy
inputs (complex64 and float32 fed explicitly: the shared conftest turns
on JAX x64).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_em_floor.py -q
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.cacgmm import CACGMM as JaxCACGMM
from pb_bss_tpu.models.complex_angular_central_gaussian import (
    ComplexAngularCentralGaussian as JaxCACG,
)
from pb_bss_tpu.ops import pallas_em_loop
from pb_bss_tpu_torch.ops import em_loop, em_stream
from pb_bss_tpu_torch.testing.em_floor import (
    FLOOR, affiliations_at_floor, model_at_floor)

torch.set_num_threads(2)

TINY = float(np.finfo(np.float32).tiny)


def _assembled_weights(y, eigenvalues, eigenvectors):
    """a / max(q, 10 tiny) for a = 1, with q taken in float32 through the
    assembled inverse V diag(1 / lambda) V^H, as the JAX package's Pallas
    kernels take it: what the floor does to that form."""
    inverse = (eigenvectors * (1 / eigenvalues)[..., None, :]
               .to(eigenvectors.dtype)) @ eigenvectors.conj().transpose(-1, -2)
    q = torch.einsum('ndt,nkde,net->nkt', y.conj(), inverse, y).real
    return 1 / torch.clamp(q, min=10 * TINY)


def test_affiliation_input_leaves_an_eigenvalue_at_the_floor():
    """On the whole-fit kernel's floor input the twin's first M-step
    leaves class 0 with one max-normalized eigenvalue at or below 1e-6
    (within f32 rounding of zero, the floor 1e-10 included) in every bin,
    the regime where 1 / lambda >= 1e6 makes an assembled inverse cancel;
    the other classes stay well-conditioned."""
    x = affiliations_at_floor(17, 6, 3, 304, seed=110)
    y, aff, qf = (torch.as_tensor(x[k]) for k in
                  ('y', 'affiliation', 'quadratic_form'))
    assert (aff[:, 0, 304 // 3:] == 0).all() and (aff[:, 0, :304 // 3] > 0).all()
    torch.testing.assert_close(aff.sum(1), torch.ones(17, 304))
    _, ev, vec, _ = em_loop.cacgmm_em_full_reference(
        y, aff, qf, iterations=1, affiliation_eps=0.)
    assert (ev[:, 0].min(-1).values <= 1e-6).all()
    assert (ev[:, 0].min(-1).values >= FLOOR).all()
    assert (ev[:, 1:].min(-1).values > 1e-3).all()
    # an assembled inverse on the twin's own model weighs some frame ~1e37
    assert _assembled_weights(y, ev, vec).max() > 1e30


def test_model_input_sits_at_the_floor():
    """The model input: class 0's eigenvalue 0 exactly at the floor, the
    first third of the frames orthogonal to its eigenvector up to f32
    rounding, unit-norm frames and a unitary basis."""
    x = model_at_floor(9, 6, 3, 300, seed=111)
    assert (x['eigenvalues'][:, 0, 0] == np.float32(FLOOR)).all()
    assert (x['eigenvalues'].max(-1) == 1).all()
    vec = x['eigenvectors']
    assert_allclose(np.einsum('nkde,nkdf->nkef', vec.conj(), vec),
                    np.broadcast_to(np.eye(6), (9, 3, 6, 6)), atol=1e-5)
    assert_allclose(np.linalg.norm(x['y'], axis=1), 1, rtol=1e-5)
    inside = np.abs(np.einsum('nd,ndt->nt', vec[:, 0, :, 0].conj(),
                              x['y'][..., :100]))
    assert inside.max() < 1e-6
    y = torch.as_tensor(x['y'])
    w = _assembled_weights(y, torch.as_tensor(x['eigenvalues']),
                           torch.as_tensor(vec))
    assert w.max() > 1e30


def test_whole_fit_twin_at_the_floor_matches_jax_scan():
    """One iteration of the whole-fit kernel's twin from the floor input
    against the JAX package's XLA reference of the same loop (the scan
    path's M-step and E-step)."""
    x = affiliations_at_floor(17, 6, 3, 304, seed=110)
    y = x['y']
    ref = pallas_em_loop.cacgmm_em_full_reference(
        jnp.asarray(y.real, jnp.float32), jnp.asarray(y.imag, jnp.float32),
        jnp.asarray(x['affiliation']), jnp.asarray(x['quadratic_form']),
        iterations=1, sweeps=6, affiliation_eps=0.)
    out = em_loop.cacgmm_em_full_reference(
        torch.as_tensor(y), torch.as_tensor(x['affiliation']),
        torch.as_tensor(x['quadratic_form']), iterations=1, sweeps=6,
        affiliation_eps=0.)
    ref = [np.asarray(r) for r in ref]
    # weights: means of the same affiliations (summation order only)
    assert_allclose(out[0].numpy(), ref[0], atol=1e-6)
    # eigenvalues: two f32 Jacobi runs of the same algorithm; the one at
    # the floor is within f32 rounding of zero in both
    assert_allclose(out[1].numpy(), ref[1], atol=2e-5)
    # affiliations: the projection in both and the same Jacobi order, so
    # rounding alone parts them, as off the floor (test_torch_em_loop.py)
    assert_allclose(out[3].numpy(), ref[3], atol=1e-4)
    assert np.isfinite(out[3].numpy()).all()


def test_streamed_twin_at_the_floor_matches_jax_scan():
    """One streamed statistics pass of the twin from the model at the
    floor against the JAX scan path's E-step (model._predict, the
    projection) and the same sums."""
    x = model_at_floor(9, 6, 3, 600, seed=111)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    scatter, asum = em_stream.e_stats_reference(
        t['y'], eigenvalues=t['eigenvalues'], eigenvectors=t['eigenvectors'],
        weight=t['weight'], affiliation_eps=1e-10)
    y = jnp.asarray(x['y'])
    model = JaxCACGMM(
        weight=jnp.asarray(x['weight'])[..., None],
        cacg=JaxCACG(covariance_eigenvectors=jnp.asarray(x['eigenvectors']),
                     covariance_eigenvalues=jnp.asarray(x['eigenvalues'])))
    aff, qf, _ = model._predict(y, affiliation_eps=1e-10)
    assert aff.dtype == jnp.float32 and qf.dtype == jnp.float32
    w = aff / jnp.maximum(qf, 10 * TINY)
    ref = np.asarray(jnp.einsum('...kt,...dt,...et->...kde', w.astype(y.dtype),
                                y, y.conj(),
                                precision=jax.lax.Precision.HIGHEST))
    ref_asum = np.asarray(jnp.sum(aff, axis=-1))
    # the quadratic form of a frame in the subspace carries the f32
    # rounding of v_0^H y (~1e-7) squared over 1e-10, ~1e-4 on a q of
    # O(1), in another order of summation in each package: 1e-4 of the
    # largest entry
    assert np.abs(scatter.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    assert_allclose(asum.numpy(), ref_asum, rtol=1e-5)
    assert np.isfinite(scatter.numpy()).all()


@pytest.mark.parametrize('D', [2, 6, 16])
def test_floor_inputs_are_seeded(D):
    a = model_at_floor(3, D, 2, 50, seed=5)
    b = model_at_floor(3, D, 2, 50, seed=5)
    for k in a:
        assert np.array_equal(a[k], b[k])
    a = affiliations_at_floor(3, D, 2, 50, seed=5)
    b = affiliations_at_floor(3, D, 2, 50, seed=5)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert a['y'].dtype == np.complex64 and a['y'].shape == (3, D, 50)


@pytest.mark.slow
def test_pallas_whole_fit_kernel_at_the_floor():
    """The JAX package's whole-fit Pallas kernel in interpret mode against
    its XLA reference at the floor: printed, not held (the reference's
    kernel takes the quadratic form through the assembled inverse, a fault
    the port's kernels do not share; the port's twin is held in the fast
    tier)."""
    x = affiliations_at_floor(5, 6, 3, 40, seed=110)
    y = x['y']
    args = (jnp.asarray(y.real, jnp.float32), jnp.asarray(y.imag, jnp.float32),
            jnp.asarray(x['affiliation']), jnp.asarray(x['quadratic_form']))
    ref = pallas_em_loop.cacgmm_em_full_reference(
        *args, iterations=1, sweeps=6, affiliation_eps=0.)
    out = pallas_em_loop.cacgmm_em_full(
        *args, iterations=1, sweeps=6, affiliation_eps=0., interpret=True)
    ours = em_loop.cacgmm_em_full_reference(
        torch.as_tensor(y), torch.as_tensor(x['affiliation']),
        torch.as_tensor(x['quadratic_form']), iterations=1, sweeps=6,
        affiliation_eps=0.)
    pallas = np.abs(np.asarray(out[3]) - np.asarray(ref[3])).max()
    port = np.abs(ours[3].numpy() - np.asarray(ref[3])).max()
    print(f'max |posterior - XLA posterior| at the eigenvalue floor: JAX '
          f'Pallas kernel {pallas:.3g}, the port\'s twin {port:.3g}')
    assert port <= 1e-4
