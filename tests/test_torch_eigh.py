"""The batched Jacobi eigendecomposition of the port
(pb_bss_tpu_torch.ops.eigh, kernel K1; its plain twin on the CPU)
against the JAX package's ``ops.linalg.eigh_jacobi`` on the same numpy
inputs, and the routing of ``ops.linalg.eigh`` to it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_bss_tpu.ops.linalg import eigh_jacobi as jax_eigh_jacobi
from pb_bss_tpu_torch.ops import eigh as eigh_op
from pb_bss_tpu_torch.ops.eigh import eigh_jacobi
from pb_bss_tpu_torch.ops.linalg import eigh

torch.set_num_threads(2)

B = 70  # not a multiple of the kernel's matrices per block or a tile


def _hermitian(D, dtype, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, D, D))
    if dtype == np.complex64:
        x = x + 1j * rng.standard_normal((batch, D, D))
    return (x @ x.conj().swapaxes(-1, -2) / D).astype(dtype)


def _check_factorization(a, w, v):
    """V diag(w) V^H = A and V^H V = I, within 1e-4 (f32 rounding of
    the sweeps' rotations)."""
    a = a.astype(np.complex128)
    v = v.astype(np.complex128)
    recon = np.einsum('bde,be,bfe->bdf', v, w, v.conj())
    assert np.abs(recon - a).max() <= 1e-4 * max(1., np.abs(a).max())
    orth = np.einsum('bde,bdf->bef', v.conj(), v)
    assert np.abs(orth - np.eye(a.shape[-1])).max() <= 1e-4


@pytest.mark.parametrize('scale', [1., 1e-20])
@pytest.mark.parametrize('dtype', [np.complex64, np.float32])
@pytest.mark.parametrize('D', [2, 3, 6, 16])
def test_matches_jax(D, dtype, scale):
    """At 1e-20 the rotations are the same as at 1 (no entry counts as
    zero, none underflows): 1e-20 times the eigenvalues, the same
    vectors."""
    a = (_hermitian(D, dtype, seed=D) * scale).astype(dtype)
    w_ref, _ = jax_eigh_jacobi(jnp.asarray(a))
    w, v = eigh_jacobi(torch.as_tensor(a))
    assert w.dtype == torch.float32 and w.shape == (B, D)
    assert v.dtype == torch.as_tensor(a).dtype and v.shape == (B, D, D)
    w, v = w.numpy(), v.numpy()
    w_ref = np.asarray(w_ref)
    # two f32 Jacobi runs of the same rotations: eigenvalues within
    # 2e-5 of each matrix's largest
    lam_max = np.abs(w_ref).max(-1, keepdims=True)
    assert (np.abs(w - w_ref) <= 2e-5 * lam_max).all()
    assert (np.diff(w, axis=-1) >= 0).all()  # ascending
    _check_factorization(a / scale, w / scale, v)
    if scale != 1:
        w1, v1 = eigh_jacobi(torch.as_tensor(_hermitian(D, dtype, seed=D)))
        assert (np.abs(w / scale - w1.numpy())
                <= 2e-5 * np.abs(w1.numpy()).max(-1, keepdims=True)).all()
        overlap = np.abs(np.einsum('bde,bde->be', v.conj(), v1.numpy()))
        assert overlap.min() > 1 - 1e-4


@pytest.mark.parametrize('dtype', [np.complex64, np.float32])
def test_nan_matrix_sorts_last(dtype):
    """A NaN matrix in the batch: its NaN eigenvalues sort after every
    number, NaNs in index order (the stable torch.sort that the CUDA
    kernel's rank order follows; the JAX package's rank sort gives NaN
    no rank), and the other matrices come out as without it, as in the
    JAX package."""
    D = 6
    a = _hermitian(D, dtype, seed=4)
    bad = a.copy()
    bad[5] = np.nan  # every entry
    bad[9, 0, 0] = np.nan  # one diagonal entry
    bad[9, 3, 3] = 7.
    w, v = eigh_jacobi(torch.as_tensor(bad))
    w_clean, v_clean = eigh_jacobi(torch.as_tensor(a))
    keep = np.ones(B, bool)
    keep[[5, 9]] = False
    assert torch.equal(w[keep], w_clean[keep])
    assert torch.equal(v[keep], v_clean[keep])
    w_ref, _ = jax_eigh_jacobi(jnp.asarray(bad))
    lam_max = np.abs(np.asarray(w_ref)[keep]).max(-1, keepdims=True)
    assert (np.abs(w[keep].numpy() - np.asarray(w_ref)[keep])
            <= 2e-5 * lam_max).all()
    for row in (5, 9):
        nan = torch.isnan(w[row])
        assert nan.any()
        assert (nan.int().diff() >= 0).all()  # NaN after every number
        finite = w[row][~nan]
        assert (finite.diff() >= 0).all()
    # the NaN matrix is left unrotated: its NaNs in index order, V = I
    assert torch.equal(v[5], torch.eye(D, dtype=v.dtype))


@pytest.mark.parametrize('dtype', [np.complex64, np.float32])
def test_identity_and_repeated_eigenvalues_stay_exact(dtype):
    """Zero off-diagonal entries are skipped as identity rotations, so
    diagonal input comes out exactly, with ties in index order (the
    stable sort of both packages)."""
    D = 6
    diag = np.array([2., 1., 2., 1., 3., 1.], np.float32)
    a = np.stack([np.eye(D), np.diag(diag)]).astype(dtype)
    w, v = eigh_jacobi(torch.as_tensor(a))
    w_ref, v_ref = jax_eigh_jacobi(jnp.asarray(a))
    order = np.argsort(diag, kind='stable')
    assert np.array_equal(w.numpy(), np.stack([np.ones(D), diag[order]]))
    assert np.array_equal(v.numpy(), np.stack([np.eye(D),
                                               np.eye(D)[:, order]]))
    assert np.array_equal(w.numpy(), np.asarray(w_ref))
    assert np.array_equal(v.numpy(), np.asarray(v_ref))


def test_linalg_eigh_routes_to_the_kernel_wrapper(monkeypatch):
    """method='pallas' runs the K1 wrapper (its twin on the CPU);
    'auto' on the CPU runs the plain Jacobi and launches nothing."""
    a = torch.as_tensor(_hermitian(6, np.complex64, seed=1))
    calls = []

    def spy(x, **kwargs):
        calls.append(x.shape)
        return eigh_op.eigh_jacobi_reference(x, **kwargs)

    monkeypatch.setattr(eigh_op, 'eigh_jacobi', spy)
    w_kernel, _ = eigh(a, method='pallas')
    assert calls == [a.shape]
    w_auto, _ = eigh(a)
    assert calls == [a.shape]
    torch.testing.assert_close(w_kernel, w_auto, atol=0, rtol=0)


@pytest.mark.slow
def test_twin_matches_pallas_interpret():
    from pb_bss_tpu.ops.pallas_eigh import eigh_jacobi_pallas
    a = _hermitian(6, np.complex64, seed=3, batch=20)
    w_ref, v_ref = eigh_jacobi_pallas(jnp.asarray(a), interpret=True,
                                      tile_b=8)
    w, v = eigh_jacobi(torch.as_tensor(a))
    lam_max = np.abs(np.asarray(w_ref)).max(-1, keepdims=True)
    assert (np.abs(w.numpy() - np.asarray(w_ref)) <= 2e-5 * lam_max).all()
    overlap = np.abs(np.einsum('bde,bde->be', v.numpy().conj(),
                               np.asarray(v_ref)))
    assert overlap.min() > 1 - 1e-4
