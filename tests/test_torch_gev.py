"""The fused GEV kernel's plain twin (pb_bss_tpu_torch.ops.gev) against
the JAX package's GEV on the same pencils. A generalized eigenvector is
defined up to a phase per bin, so vectors are compared after removing
it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.extraction.beamformer import get_gev_vector as jax_get_gev
from pb_bss_tpu.ops.linalg import gev_max_eigvec as jax_gev
from pb_bss_tpu.ops.pallas_gev import gev_pallas
from pb_bss_tpu_torch.extraction.beamformer import get_gev_vector
from pb_bss_tpu_torch.ops.gev import gev, gev_reference
from pb_bss_tpu_torch.ops.linalg import gev_max_eigvec

torch.set_num_threads(2)


def _pencils(B=24, D=6, seed=0):
    rng = np.random.default_rng(seed)

    def herm_pd(scale):
        a = (rng.standard_normal((B, D, D))
             + 1j * rng.standard_normal((B, D, D)))
        return (a @ a.conj().swapaxes(-1, -2)
                + scale * np.eye(D)).astype(np.complex64)

    return herm_pd(0.1), herm_pd(0.5)


def _phase_free_error(a, b):
    """Max |a - b e^{i phi}| with phi the per-vector phase of <b, a>."""
    inner = np.einsum('...d,...d->...', b.conj(), a)
    return np.abs(a / (inner / np.abs(inner))[..., None] - b).max()


def _b_norm(beam, phi_nn):
    return np.einsum('...d,...de,...e->...', beam.conj(), phi_nn, beam)


@pytest.mark.parametrize('D', [2, 3, 6, 8])
def test_plain_twin_matches_jax(D):
    phi_xx, phi_nn = _pencils(D=D, seed=D)
    ref = np.asarray(jax_gev(jnp.asarray(phi_xx), jnp.asarray(phi_nn),
                             method='xla'))
    out = gev(torch.as_tensor(phi_xx), torch.as_tensor(phi_nn)).numpy()
    assert out.dtype == np.complex64 and out.shape == (24, D)
    # same staged algorithm, f32 rounding of two implementations
    assert _phase_free_error(out, ref) < 1e-4
    # B-normalization (zhegvd convention): w^H phi_nn w = 1
    assert_allclose(_b_norm(out, phi_nn), 1.0, atol=1e-4)


def test_wrapper_routes_and_batch_dims():
    phi_xx, phi_nn = _pencils(B=12, D=3, seed=3)
    flat = gev_reference(torch.as_tensor(phi_xx), torch.as_tensor(phi_nn))
    shaped = gev_max_eigvec(
        torch.as_tensor(phi_xx.reshape(3, 4, 3, 3)),
        torch.as_tensor(phi_nn.reshape(3, 4, 3, 3)), method='pallas')
    np.testing.assert_array_equal(shaped.reshape(12, 3).numpy(),
                                  flat.numpy())
    staged = gev_max_eigvec(torch.as_tensor(phi_xx),
                            torch.as_tensor(phi_nn), method='xla')
    assert _phase_free_error(staged.numpy(), flat.numpy()) < 1e-5


def test_non_pd_bins_are_non_finite_and_loading_retries():
    """A singular noise PSD (zero pivot) gives a non-finite vector in
    both packages; get_gev_vector's diagonal-loading retry then gives a
    finite one in both. An all-zero PSD stays non-finite (loading scales
    with the trace)."""
    phi_xx, phi_nn = _pencils(B=8, D=6, seed=2)
    phi_nn[3] = np.diag([1, 1, 1, 1, 1, 0]).astype(np.complex64)
    phi_nn[5] = 0
    ref = np.asarray(jax_gev(jnp.asarray(phi_xx), jnp.asarray(phi_nn),
                             method='xla'))
    out = gev(torch.as_tensor(phi_xx), torch.as_tensor(phi_nn)).numpy()
    ok = np.isfinite(out).all(-1)
    np.testing.assert_array_equal(ok, np.isfinite(ref).all(-1))
    np.testing.assert_array_equal(ok, [1, 1, 1, 0, 1, 0, 1, 1])

    retried = get_gev_vector(
        torch.as_tensor(phi_xx), torch.as_tensor(phi_nn)).numpy()
    jax_retried = np.asarray(jax_get_gev(
        jnp.asarray(phi_xx), jnp.asarray(phi_nn)))
    np.testing.assert_array_equal(np.isfinite(retried).all(-1),
                                  np.isfinite(jax_retried).all(-1))
    assert np.isfinite(retried[3]).all()
    keep = [0, 1, 2, 4, 6, 7]
    np.testing.assert_array_equal(retried[keep], out[keep])


@pytest.mark.slow
def test_plain_twin_matches_pallas_interpret():
    phi_xx, phi_nn = _pencils(B=13, D=6, seed=1)
    ref = np.asarray(gev_pallas(phi_xx, phi_nn, interpret=True, tile_b=8))
    out = gev_reference(torch.as_tensor(phi_xx),
                        torch.as_tensor(phi_nn)).numpy()
    assert _phase_free_error(out, ref) < 1e-4
    assert_allclose(_b_norm(out, phi_nn).real,
                    _b_norm(ref, phi_nn).real, atol=1e-4)


def test_loading_retry_lifts_a_rounded_rank_deficient_noise_psd():
    """A noise PSD of rank 2 at D=6 whose zero eigenvalues f32 rounding
    left a few ulps below zero (a noise class that covers about one frame
    in a bin, as a CBMM fit from a random start can leave after the
    alignment): the JAX package's 1e-10 loading leaves the vector
    non-finite, the port's retry gives a finite, B-normalized one; the
    other bins keep the vector without loading."""
    phi_xx, phi_nn = _pencils(B=4, D=6, seed=3)
    phi_nn[2] = (np.diag([1., 1., 0., 0., 0., 0.])
                 - 1e-6 * np.eye(6)).astype(np.complex64)
    jax_retried = np.asarray(jax_get_gev(jnp.asarray(phi_xx),
                                         jnp.asarray(phi_nn)))
    assert not np.isfinite(jax_retried[2]).all()
    retried = get_gev_vector(torch.as_tensor(phi_xx),
                             torch.as_tensor(phi_nn)).numpy()
    assert np.isfinite(retried).all()
    plain = gev(torch.as_tensor(phi_xx), torch.as_tensor(phi_nn)).numpy()
    np.testing.assert_array_equal(retried[[0, 1, 3]], plain[[0, 1, 3]])
    loaded = phi_nn[2] + 1e-5 * np.trace(phi_nn[2]).real / 6 * np.eye(6)
    b_norm = np.einsum('d,de,e->', retried[2].conj(), loaded / (1 + 1e-5),
                       retried[2])
    assert abs(b_norm - 1) < 1e-3
