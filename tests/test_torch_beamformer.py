"""Beamformers of the port against the JAX package on the same
inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.extraction import beamformer as jbf
from pb_bss_tpu.extraction.beamformer_wrapper import (
    get_bf_vector as jax_get_bf_vector,
)
from pb_bss_tpu_torch.extraction import beamformer as bf
from pb_bss_tpu_torch.extraction.beamformer_wrapper import get_bf_vector

torch.set_num_threads(2)


def _cn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _psds(F=11, K=3, D=4, T=50, seed=0):
    rng = np.random.default_rng(seed)
    Y = _cn(rng, F, D, T)
    mask = rng.uniform(size=(F, K, T)).astype(np.float32)
    return Y, mask


@pytest.mark.parametrize('kind', ['none', 'time', 'classes', 'bool'])
def test_psd_matches_jax(kind):
    Y, mask = _psds()
    m = {'none': None, 'time': mask[:, 0], 'classes': mask,
         'bool': mask > 0.5}[kind]
    ref = np.asarray(jbf.get_power_spectral_density_matrix(
        jnp.asarray(Y), None if m is None else jnp.asarray(m)))
    out = bf.get_power_spectral_density_matrix(
        torch.as_tensor(Y), None if m is None else torch.as_tensor(m))
    assert out.dtype == torch.complex64
    assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def _pd(rng, *shape):
    a = _cn(rng, *shape)
    return a @ a.conj().swapaxes(-1, -2) + 0.1 * np.eye(shape[-1],
                                                       dtype=np.complex64)


def test_ban_matches_jax_including_zero_psd():
    rng = np.random.default_rng(1)
    w = _cn(rng, 9, 4)
    noise = _pd(rng, 9, 4, 4)
    noise[2] = 0  # zero PSD: zero gain, not NaN
    ref = np.asarray(jbf.blind_analytic_normalization(
        jnp.asarray(w), jnp.asarray(noise)))
    out = bf.blind_analytic_normalization(
        torch.as_tensor(w), torch.as_tensor(noise)).numpy()
    assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert np.all(out[2] == 0)


def test_phase_correction_matches_jax():
    w = _cn(np.random.default_rng(2), 2, 17, 4)
    ref = np.asarray(jbf.phase_correction(jnp.asarray(w)))
    out = bf.phase_correction(torch.as_tensor(w)).numpy()
    assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_apply_beamforming_vector_matches_jax():
    rng = np.random.default_rng(3)
    w, Y = _cn(rng, 7, 4), _cn(rng, 7, 4, 30)
    ref = np.asarray(jbf.apply_beamforming_vector(
        jnp.asarray(w), jnp.asarray(Y)))
    out = bf.apply_beamforming_vector(
        torch.as_tensor(w), torch.as_tensor(Y)).numpy()
    assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('name', ['gev', 'gev+ban'])
def test_get_bf_vector_matches_jax(name):
    """The pipeline's call: per class, the other classes as noise.
    Compared after removing each bin's arbitrary phase."""
    Y, mask = _psds(F=13, D=6, T=80, seed=4)
    psds = np.array(jbf.get_power_spectral_density_matrix(
        jnp.asarray(Y), jnp.asarray(mask)))  # (F, K, D, D)
    phi_nn = psds.sum(1, keepdims=True) - psds
    ref = np.asarray(jax_get_bf_vector(
        name, jnp.asarray(psds), jnp.asarray(phi_nn)))
    out = get_bf_vector(
        name, torch.as_tensor(psds), torch.as_tensor(phi_nn)).numpy()
    inner = np.einsum('...d,...d->...', ref.conj(), out)
    aligned = out / (inner / np.abs(inner))[..., None]
    # staged GEV in two f32 implementations; BAN rescales by |.| only
    assert_allclose(aligned, ref, rtol=1e-4, atol=1e-4)


def test_unported_beamformer_raises():
    psd = torch.eye(3, dtype=torch.complex64)[None]
    with pytest.raises(NotImplementedError, match='mvdr_souden'):
        get_bf_vector('mvdr_souden', psd, psd)
