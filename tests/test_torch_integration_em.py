"""The plain twin of the integration statistics kernel K10
(pb_bss_tpu_torch.ops.integration_em) against the JAX package's XLA
statistics on the same numpy inputs, as the JAX suite holds its Pallas
kernel (tests/test_ops/test_pallas_integration_em.py:
test_e_stats_parity_with_xla): the E-step of the scan path, then the
scatter sum_t a / max(q, 10 tiny) y y^H, sum_t a, the resultants
sum_t a e and, for the Gaussian, sum_t a e^2, at T in {40, 37}, in both
spectral modes, with and without saliency. Tolerances are the JAX
suite's (f32 sums over T and F T frames in two orders). The JAX Pallas
kernel in interpret mode is held in the slow tier."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.complex_angular_central_gaussian import (
    ComplexAngularCentralGaussian,
)
from pb_bss_tpu.models.gaussian import DiagonalGaussian
from pb_bss_tpu.models.gcacgmm import GCACGMM
from pb_bss_tpu.models.vmfcacgmm import VMFCACGMM
from pb_bss_tpu.models.von_mises_fisher import VonMisesFisher
from pb_bss_tpu_torch.ops import integration_em

torch.set_num_threads(2)


def _problem(F=17, T=40, D=4, E=8, K=3, seed=0):
    rng = np.random.default_rng(seed)
    atf = rng.standard_normal((F, D, K)) + 1j * rng.standard_normal(
        (F, D, K))
    s = rng.standard_normal((F, K, T)) + 1j * rng.standard_normal((F, K, T))
    y = np.einsum('fdk,fkt->fdt', atf, s) + 0.2 * (
        rng.standard_normal((F, D, T)) + 1j * rng.standard_normal((F, D, T)))
    obs = np.swapaxes(y, 1, 2).astype(np.complex64)  # (F, T, D)
    obs /= np.linalg.norm(obs, axis=-1, keepdims=True)
    emb = rng.standard_normal((F, T, E)).astype(np.float32)
    return obs, emb


def _model(F, D, E, K, mode, seed=1):
    """A well-conditioned JAX model (tight parity expected) and the
    kernel's spectral state of it (mu, kappa, log_c) as numpy."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((F, K, D, D)) + 1j * rng.standard_normal(
        (F, K, D, D))
    cov = np.einsum('fkde,fkce->fkdc', a, a.conj()) / D + 2 * np.eye(D)
    eigval, eigvec = np.linalg.eigh(cov)
    eigval /= eigval.max(-1, keepdims=True)
    weight = rng.uniform(0.5, 1.0, (F, K))
    weight /= weight.sum(-1, keepdims=True)
    cacg = ComplexAngularCentralGaussian(
        covariance_eigenvalues=jnp.asarray(eigval, jnp.float32),
        covariance_eigenvectors=jnp.asarray(eigvec, jnp.complex64))
    if mode == 'vmf':
        mu = rng.standard_normal((K, E))
        mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
        vmf = VonMisesFisher(
            mean=jnp.asarray(mu, jnp.float32),
            concentration=jnp.asarray(rng.uniform(1.0, 20.0, K), jnp.float32))
        model = VMFCACGMM(weight=jnp.asarray(weight, jnp.float32), vmf=vmf,
                          cacg=cacg)
        spec = (np.asarray(vmf.mean), np.asarray(vmf.concentration),
                np.asarray(vmf.log_norm()))
    else:
        mean = 0.3 * rng.standard_normal((K, E))
        var = rng.uniform(0.5, 2.0, (K, E))
        g = DiagonalGaussian(mean=jnp.asarray(mean, jnp.float32),
                             covariance=jnp.asarray(var, jnp.float32))
        model = GCACGMM(weight=jnp.asarray(weight, jnp.float32), gaussian=g,
                        cacg=cacg)
        prec = 1 / var
        const = 0.5 * E * math.log(2 * math.pi) + 0.5 * np.log(var).sum(-1) \
            + 0.5 * (mean ** 2 * prec).sum(-1)
        spec = (prec * mean, prec, const)
    return model, eigval, eigvec, weight, [np.array(x, np.float32)[None]
                                           for x in spec]


def _xla_stats(model, obs, emb, eps, saliency):
    """The JAX scan path's E-step and the M-step statistics."""
    aff, qf = model._predict(jnp.asarray(obs), jnp.asarray(emb),
                             affiliation_eps=eps)
    if saliency is not None:
        aff = aff * jnp.asarray(saliency)[:, None, :]
    qf = jnp.maximum(qf, 10 * jnp.finfo(jnp.float32).tiny)
    y_tl = jnp.swapaxes(jnp.asarray(obs), -1, -2)
    hi = jax.lax.Precision.HIGHEST
    scatter = jnp.einsum('fkt,fdt,fet->fkde', aff / qf, y_tl, y_tl.conj(),
                         precision=hi)
    res = jnp.einsum('fkt,fte->fke', aff, jnp.asarray(emb), precision=hi)
    m2 = jnp.einsum('fkt,fte->fke', aff, jnp.asarray(emb) ** 2, precision=hi)
    return [np.asarray(x) for x in (scatter, aff.sum(-1), res, m2)]


def _port_stats(obs, emb, eigval, eigvec, weight, spec, mode, saliency,
                **kwargs):
    t = torch.as_tensor
    return integration_em.e_stats(
        t(np.swapaxes(obs, 1, 2).copy()), t(np.swapaxes(emb, 1, 2).copy()),
        eigenvalues=t(eigval.astype(np.float32)),
        eigenvectors=t(eigvec.astype(np.complex64)),
        weight=t(weight.astype(np.float32)), mu=t(spec[0]), kappa=t(spec[1]),
        log_c=t(spec[2]), spectral_mode=mode,
        saliency=None if saliency is None else t(saliency), **kwargs)


@pytest.mark.parametrize('mode', ['vmf', 'gaussian'])
@pytest.mark.parametrize('T', [40, 37])
@pytest.mark.parametrize('saliency', [False, True])
def test_twin_matches_the_xla_statistics(mode, T, saliency):
    F, D, E, K = 17, 4, 8, 3
    obs, emb = _problem(F=F, T=T, D=D, E=E, K=K)
    model, eigval, eigvec, weight, spec = _model(F, D, E, K, mode)
    sal = (np.random.default_rng(8).uniform(0.3, 1.0, (F, T)).astype(
        np.float32) if saliency else None)
    eps = 1e-10
    scatter_r, asum_r, res_r, m2_r = _xla_stats(model, obs, emb, eps, sal)
    before = integration_em.e_stats.launches
    scatter, asum, res, m2 = _port_stats(obs, emb, eigval, eigvec, weight,
                                         spec, mode, sal,
                                         affiliation_eps=eps)
    assert integration_em.e_stats.launches == before  # the twin on the CPU
    assert_allclose(asum.numpy(), asum_r, rtol=0, atol=T * 2e-5)
    assert_allclose(res.numpy(), res_r, rtol=0, atol=T * 2e-5)
    assert_allclose(res.sum(0).numpy(), res_r.sum(0), rtol=0,
                    atol=F * T * 2e-5)
    assert_allclose(scatter.numpy(), scatter_r, rtol=0, atol=T * 2e-5)
    s = scatter.numpy()
    assert_allclose(s, np.conj(np.swapaxes(s, -1, -2)), atol=1e-6)
    if mode == 'gaussian':
        assert_allclose(m2.numpy(), m2_r, rtol=0, atol=T * 5e-5)
    else:
        assert m2 is None


def _at_the_floor(obs, model, eigval, eigvec):
    """A converged fit's regime: class 0's smallest eigenvalue at the
    eigenvalue floor (1e-10) and the first third of the frames in the span
    of its other eigenvectors, where the quadratic form through the
    assembled inverse covariance (entries ~1e10) cancels."""
    F, T, D = obs.shape
    eigval = eigval.copy()
    eigval[:, 0, 0] = 1e-10
    rng = np.random.default_rng(9)
    c = rng.standard_normal((F, D - 1, T // 3)) \
        + 1j * rng.standard_normal((F, D - 1, T // 3))
    inside = np.einsum('fde,fet->ftd', eigvec[:, 0, :, 1:], c)
    obs = obs.copy()
    obs[:, :T // 3] = inside / np.linalg.norm(inside, axis=-1, keepdims=True)
    cacg = ComplexAngularCentralGaussian(
        covariance_eigenvalues=jnp.asarray(eigval, jnp.float32),
        covariance_eigenvectors=jnp.asarray(eigvec, jnp.complex64))
    return obs, model.replace(cacg=cacg), eigval


@pytest.mark.parametrize('mode', ['vmf', 'gaussian'])
def test_twin_matches_the_xla_statistics_at_the_eigenvalue_floor(mode):
    """The kernels take the quadratic form as the JAX scan path does,
    through the eigenvectors (z = V^H y, sum |z_i|^2 / lam_i): at the
    floor the statistics still agree, where the assembled inverse of the
    JAX package's Pallas kernel cancels (q <= 0 floored at tiny weighs a
    frame ~1e37 in the scatter; test_pallas_kernel_at_the_floor)."""
    F, T, D, E, K = 17, 40, 4, 8, 3
    obs, emb = _problem(F=F, T=T, D=D, E=E, K=K, seed=10)
    model, eigval, eigvec, weight, spec = _model(F, D, E, K, mode)
    obs, model, eigval = _at_the_floor(obs, model, eigval, eigvec)
    scatter_r, asum_r, res_r, _ = _xla_stats(model, obs, emb, 1e-10, None)
    scatter, asum, res, _ = _port_stats(obs, emb, eigval, eigvec, weight,
                                        spec, mode, None, affiliation_eps=1e-10)
    assert_allclose(asum.numpy(), asum_r, rtol=0, atol=T * 2e-5)
    assert_allclose(res.numpy(), res_r, rtol=0, atol=T * 2e-5)
    cov = D * scatter.numpy() / np.maximum(asum.numpy(), 1e-30)[..., None,
                                                                 None]
    cov_r = D * scatter_r / np.maximum(asum_r, 1e-30)[..., None, None]
    assert_allclose(cov, cov_r, rtol=0, atol=1e-4 * np.abs(cov_r).max())


@pytest.mark.parametrize('weights', [(1., 1.), (0.5, 2.)])
def test_spatial_and_spectral_weights(weights):
    """spatial_weight / spectral_weight scale the two log-pdfs as the
    JAX model's exponents do."""
    F, T, D, E, K = 9, 32, 3, 5, 2
    obs, emb = _problem(F=F, T=T, D=D, E=E, K=K, seed=3)
    model, eigval, eigvec, weight, spec = _model(F, D, E, K, 'vmf', seed=4)
    model = model.replace(spatial_weight=weights[0],
                          spectral_weight=weights[1])
    _, asum_r, res_r, _ = _xla_stats(model, obs, emb, 1e-10, None)
    _, asum, res, _ = _port_stats(obs, emb, eigval, eigvec, weight, spec,
                                  'vmf', None, spatial_weight=weights[0],
                                  spectral_weight=weights[1])
    assert_allclose(asum.numpy(), asum_r, atol=T * 2e-5)
    assert_allclose(res.numpy(), res_r, atol=T * 2e-5)


def test_utterances_fold_into_the_bins():
    """Two utterances folded into the bin axis each read their own
    spectral state: the pass equals two single-utterance passes."""
    F, T, D, E, K = 9, 33, 3, 5, 2
    parts = [_problem(F=F, T=T, D=D, E=E, K=K, seed=s) for s in (5, 6)]
    models = [_model(F, D, E, K, 'vmf', seed=s) for s in (7, 8)]
    singles = [_port_stats(o, e, *m[1:], 'vmf', None)
               for (o, e), m in zip(parts, models)]
    cat = [np.concatenate(x) for x in zip(*(p for p in parts))]
    state = [np.concatenate([m[i] for m in models]) for i in (1, 2, 3)]
    spec = [np.concatenate([m[4][i] for m in models]) for i in range(3)]
    folded = _port_stats(*cat, *state, spec, 'vmf', None, bins_per_utt=F)
    for i in range(3):
        assert torch.equal(folded[i][:F], singles[0][i])
        assert torch.equal(folded[i][F:], singles[1][i])


def test_gate_and_arguments():
    assert integration_em.fits(6, 3, 20) and integration_em.fits(16, 4, 64)
    assert not integration_em.fits(17, 3, 20)
    assert not integration_em.fits(6, 3, 5000)  # the tile of E rows
    assert integration_em._chunking(513, 300) == (2, 256)
    assert integration_em._chunking(8 * 513, 300) == (1, 512)
    obs, emb = _problem(F=3, T=10)
    _, eigval, eigvec, weight, spec = _model(3, 4, 8, 3, 'vmf')
    with pytest.raises(ValueError, match='spectral_mode'):
        _port_stats(obs, emb, eigval, eigvec, weight, spec, 'gmm', None)


@pytest.mark.slow
@pytest.mark.parametrize('mode', ['vmf', 'gaussian'])
@pytest.mark.parametrize('saliency', [False, True])
def test_twin_matches_the_pallas_kernel_in_interpret_mode(mode, saliency):
    from pb_bss_tpu.ops.pallas_integration_em import (
        choose_tile_f, e_stats_staged, stage_observation, stage_saliency)
    F, T, D, E, K = 17, 37, 4, 8, 3
    obs, emb = _problem(F=F, T=T, D=D, E=E, K=K)
    _, eigval, eigvec, weight, spec = _model(F, D, E, K, mode)
    sal = (np.random.default_rng(8).uniform(0.3, 1.0, (F, T)).astype(
        np.float32) if saliency else None)
    y_tl = np.swapaxes(obs, 1, 2)
    tile_f = choose_tile_f(D, E, K, 40, has_sal=saliency)
    staged = stage_observation(jnp.asarray(y_tl.real), jnp.asarray(y_tl.imag),
                               jnp.asarray(np.swapaxes(emb, 1, 2)),
                               tile_f=tile_f)
    out = e_stats_staged(
        *staged, jnp.asarray(eigvec.real, jnp.float32),
        jnp.asarray(eigvec.imag, jnp.float32),
        jnp.asarray(1 / eigval, jnp.float32),
        jnp.asarray(np.log(eigval).sum(-1), jnp.float32),
        jnp.asarray(weight, jnp.float32),
        *[jnp.asarray(np.broadcast_to(x, (F,) + x.shape[1:])) for x in spec],
        None if sal is None else stage_saliency(jnp.asarray(sal),
                                                tile_f=tile_f),
        f_real=F, t_real=T, tile_f=tile_f, interpret=True,
        spectral_mode=mode)
    ours = _port_stats(obs, emb, eigval, eigvec, weight, spec, mode, sal)
    for a, b in zip(ours, out):
        assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=T * 2e-5)


@pytest.mark.slow
def test_pallas_kernel_at_the_floor():
    """The JAX package's Pallas kernel in interpret mode against the XLA
    statistics at the eigenvalue floor: printed, not held (a fault of the
    reference's kernel, which the port's kernels do not share; the port's
    twin is held in the fast tier)."""
    from pb_bss_tpu.ops.pallas_integration_em import vmfcacgmm_e_stats
    F, T, D, E, K = 17, 40, 4, 8, 3
    obs, emb = _problem(F=F, T=T, D=D, E=E, K=K, seed=10)
    model, eigval, eigvec, weight, spec = _model(F, D, E, K, 'vmf')
    obs, model, eigval = _at_the_floor(obs, model, eigval, eigvec)
    scatter_r, asum_r, _, _ = _xla_stats(model, obs, emb, 1e-10, None)
    y_tl = np.swapaxes(obs, 1, 2)
    f32 = jnp.float32
    scatter, asum = vmfcacgmm_e_stats(
        jnp.asarray(y_tl.real), jnp.asarray(y_tl.imag),
        jnp.asarray(np.swapaxes(emb, 1, 2)), jnp.asarray(eigvec.real, f32),
        jnp.asarray(eigvec.imag, f32), jnp.asarray(1 / eigval, f32),
        jnp.asarray(np.log(eigval).sum(-1), f32), jnp.asarray(weight, f32),
        *[jnp.asarray(x[0]) for x in spec], interpret=True)[:2]
    cov = D * np.asarray(scatter) / np.maximum(np.asarray(asum), 1e-30)[
        ..., None, None]
    cov_r = D * scatter_r / np.maximum(asum_r, 1e-30)[..., None, None]
    ours = _port_stats(obs, emb, eigval, eigvec, weight, spec, 'vmf', None,
                       affiliation_eps=1e-10)
    cov_p = D * ours[0].numpy() / np.maximum(ours[1].numpy(), 1e-30)[
        ..., None, None]
    print(f'max |cov - cov_xla| at the eigenvalue floor (max |cov_xla| '
          f'{np.abs(cov_r).max():.3g}): JAX Pallas kernel '
          f'{np.abs(cov - cov_r).max():.3g}, the port\'s twin '
          f'{np.abs(cov_p - cov_r).max():.3g}')
    assert np.abs(cov_p - cov_r).max() <= 1e-4 * np.abs(cov_r).max()
