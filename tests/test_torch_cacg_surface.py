"""The rest of the port's cACG and cACGMM surface against the JAX
package's on the same seeded numpy inputs: ComplexAngularCentralGaussian
.covariance / .log_pdf, ComplexAngularCentralGaussianTrainer.fit, the
cACG and cACGMM samplers held by their moments, CACGMM.log_likelihood,
the Dirichlet prior of estimate_mixture_weight at several
concentrations, and the EM matmul-precision knob."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models import (
    CACGMM as JaxCACGMM,
    ComplexAngularCentralGaussian as JaxCACG,
    ComplexAngularCentralGaussianTrainer as JaxCACGTrainer,
    estimate_mixture_weight as jax_estimate_mixture_weight,
    sample_cacgmm as jax_sample_cacgmm,
)
from pb_bss_tpu_torch.models import (
    CACGMM,
    CACGMMTrainer,
    ComplexAngularCentralGaussian,
    ComplexAngularCentralGaussianTrainer,
    estimate_mixture_weight,
    sample_cacgmm,
    sample_complex_angular_central_gaussian,
)
from pb_bss_tpu_torch.models import _precision

torch.set_num_threads(2)


def _hermitian(rng, *batch, D=3, load=0.3):
    a = rng.standard_normal((*batch, D, D)) + 1j * rng.standard_normal(
        (*batch, D, D))
    return a @ np.conj(np.swapaxes(a, -1, -2)) + load * np.eye(D)


def _observations(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _cacg_dict(rng, *batch, D=3):
    w, v = np.linalg.eigh(_hermitian(rng, *batch, D=D))
    return {'covariance_eigenvectors': v,
            'covariance_eigenvalues': w / w.max(-1, keepdims=True)}


def _normalized(cov):
    return cov / np.trace(cov, axis1=-2, axis2=-1)[..., None, None].real


def test_covariance_and_log_pdf_match_jax():
    rng = np.random.default_rng(0)
    d = _cacg_dict(rng, 4)
    y = _observations(rng, 4, 60, 3)
    ours = ComplexAngularCentralGaussian.from_dict(d)
    theirs = JaxCACG.from_dict({k: jnp.asarray(v) for k, v in d.items()})
    assert_allclose(ours.covariance.numpy(), np.asarray(theirs.covariance),
                    atol=1e-12)
    assert_allclose(ours.log_pdf(torch.as_tensor(y)).numpy(),
                    np.asarray(theirs.log_pdf(jnp.asarray(y))), atol=1e-10)


@pytest.mark.parametrize('dtype,atol', [(np.complex128, 1e-9),
                                        (np.complex64, 5e-4)])
@pytest.mark.parametrize('saliency', [False, True])
def test_trainer_fit_matches_jax(dtype, atol, saliency):
    """The fixed-point iteration from the same data: the covariances
    agree (complex64: 10 iterations of f32 Jacobi and scatter on each
    side)."""
    rng = np.random.default_rng(1)
    y = _observations(rng, 3, 200, 3) * np.array([1.0, 0.5, 2.0])
    y = y.astype(dtype)
    sal = rng.random((3, 200)).astype(np.float64 if dtype == np.complex128
                                      else np.float32) if saliency else None
    ours = ComplexAngularCentralGaussianTrainer().fit(
        torch.as_tensor(y),
        saliency=None if sal is None else torch.as_tensor(sal))
    theirs = JaxCACGTrainer().fit(jnp.asarray(y), saliency=sal)
    assert_allclose(ours.covariance.numpy(), np.asarray(theirs.covariance),
                    atol=atol)
    assert_allclose(ours.covariance_eigenvalues.numpy(),
                    np.asarray(theirs.covariance_eigenvalues), atol=atol)


def test_trainer_fit_asserts():
    with pytest.raises(AssertionError):
        ComplexAngularCentralGaussianTrainer().fit(torch.ones(3, 10, 2))
    with pytest.raises(AssertionError):
        ComplexAngularCentralGaussianTrainer().fit(
            torch.ones(3, 10, 2, dtype=torch.complex64), iterations=0)


def test_cacg_sampler_moments():
    """30,000 cACG draws are unit-norm, and the trainer's fit on them
    returns the sampled covariance up to scale (trace-normalized,
    within 0.03); the JAX sampler's draws have the same second moment."""
    rng = np.random.default_rng(2)
    cov = _hermitian(rng, load=0.5)
    x = sample_complex_angular_central_gaussian(
        30000, torch.as_tensor(cov),
        generator=torch.Generator().manual_seed(4))
    assert x.shape == (30000, 3)
    assert_allclose(torch.linalg.vector_norm(x, dim=-1).numpy(), 1.0)
    fitted = ComplexAngularCentralGaussianTrainer().fit(x, iterations=30)
    assert_allclose(_normalized(fitted.covariance.numpy()),
                    _normalized(cov), atol=0.03)
    model = ComplexAngularCentralGaussian.from_covariance(
        torch.as_tensor(cov))
    y = model.sample(30000, generator=torch.Generator().manual_seed(5))
    jax_y = np.asarray(JaxCACG.from_covariance(jnp.asarray(cov)).sample(
        30000, key=jax.random.key(5)))
    second = (y.T @ y.conj()).numpy() / len(y)
    assert_allclose(jax_y.T @ np.conj(jax_y) / len(jax_y), second,
                    atol=0.02)


def test_sample_cacgmm_moments_and_labels():
    """Labels follow the weights, and each class's draws have that
    class's second moment (the JAX sampler's draws alike)."""
    rng = np.random.default_rng(3)
    weight = np.array([0.2, 0.3, 0.5])
    cov = np.stack([_hermitian(rng, load=0.5) for _ in range(3)])
    x, labels = sample_cacgmm(
        30000, weight, torch.as_tensor(cov), return_label=True,
        generator=torch.Generator().manual_seed(6))
    assert x.shape == (30000, 3) and labels.shape == (30000,)
    assert_allclose(np.bincount(labels.numpy(), minlength=3) / 30000,
                    weight, atol=0.015)
    jax_x, jax_labels = jax_sample_cacgmm(
        30000, weight, cov, return_label=True, key=jax.random.key(6))
    jax_x, jax_labels = np.asarray(jax_x), np.asarray(jax_labels)
    for k in range(3):
        ours = x[labels == k].numpy()
        theirs = jax_x[jax_labels == k]
        assert_allclose(ours.T @ np.conj(ours) / len(ours),
                        theirs.T @ np.conj(theirs) / len(theirs), atol=0.03)
    only_x = sample_cacgmm(100, weight, torch.as_tensor(cov))
    assert only_x.shape == (100, 3)
    with pytest.raises(AssertionError):
        sample_cacgmm(100, weight[:2], torch.as_tensor(cov))


@pytest.mark.parametrize('dtype,atol', [(np.complex128, 1e-9),
                                        (np.complex64, 2e-2)])
def test_log_likelihood_matches_jax(dtype, atol):
    """The summed log-likelihood of the same model (complex64: a sum of
    ~1,000 f32 log-pdfs of magnitude ~10)."""
    rng = np.random.default_rng(4)
    d = _cacg_dict(rng, 5, 2)
    weight = rng.random((5, 2, 1))
    y = _observations(rng, 5, 100, 3).astype(dtype)
    rdtype = np.float32 if dtype == np.complex64 else np.float64
    d = {'covariance_eigenvectors': d['covariance_eigenvectors'].astype(
        dtype), 'covariance_eigenvalues': d['covariance_eigenvalues'].astype(
        rdtype)}
    ours = CACGMM.from_dict({'weight': weight.astype(rdtype), 'cacg': d})
    theirs = JaxCACGMM.from_dict({'weight': jnp.asarray(weight, rdtype),
                                  'cacg': {k: jnp.asarray(v)
                                           for k, v in d.items()}})
    assert_allclose(float(ours.log_likelihood(torch.as_tensor(y))),
                    float(theirs.log_likelihood(jnp.asarray(y))),
                    atol=atol, rtol=1e-6)


@pytest.mark.parametrize('concentration', [1, 1.5, 3, 20, np.inf])
def test_dirichlet_prior_matches_jax(concentration):
    rng = np.random.default_rng(5)
    aff = rng.random((4, 3, 50))
    aff /= aff.sum(-2, keepdims=True)
    ours = estimate_mixture_weight(
        torch.as_tensor(aff), dirichlet_prior_concentration=concentration)
    theirs = jax_estimate_mixture_weight(
        jnp.asarray(aff), dirichlet_prior_concentration=concentration)
    assert ours.shape == tuple(theirs.shape) == (4, 3, 1)
    assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-14)
    assert_allclose(ours.numpy().sum(-2), 1.0)


def test_dirichlet_prior_default_is_the_plain_mean():
    rng = np.random.default_rng(6)
    aff = torch.as_tensor(rng.random((4, 3, 50)))
    for axis in ((-1,), (-3, -1)):
        assert torch.equal(
            estimate_mixture_weight(aff, weight_constant_axis=axis),
            aff.mean(dim=axis, keepdim=True))
    with pytest.raises(AssertionError):
        estimate_mixture_weight(aff, dirichlet_prior_concentration=0.5)
    with pytest.raises(AssertionError):
        estimate_mixture_weight(aff, weight_constant_axis=(-3, -1),
                                dirichlet_prior_concentration=2)


def test_em_matmul_precision_knob():
    """The JAX package's names map onto PyTorch's float32 matmul
    precision inside full_fp32, the caller's setting comes back after
    the block, the default is full fp32, and an unknown name raises."""
    assert _precision.em_matmul_precision() == 'highest'
    caller = torch.get_float32_matmul_precision()
    try:
        for name, torch_name in (('high', 'high'), ('bf16', 'medium'),
                                 ('DEFAULT', 'medium'),
                                 ('highest', 'highest')):
            _precision.set_em_matmul_precision(name)
            with _precision.full_fp32():
                assert torch.get_float32_matmul_precision() == torch_name
            assert torch.get_float32_matmul_precision() == caller
        torch.set_float32_matmul_precision('high')
        with _precision.full_fp32():
            assert torch.get_float32_matmul_precision() == 'highest'
        assert torch.get_float32_matmul_precision() == 'high'
        previous = _precision.set_em_matmul_precision('high')
        assert previous == 'highest'
        assert _precision.set_em_matmul_precision('highest') == 'high'
        with pytest.raises(ValueError, match='unknown'):
            _precision.set_em_matmul_precision('fp8')
    finally:
        _precision.set_em_matmul_precision('highest')
        torch.set_float32_matmul_precision(caller)


def test_fit_is_unchanged_by_the_precision_default_on_the_cpu():
    """A CPU fit at the default and at 'high' is the same (PyTorch's CPU
    matmuls take no TF32): the knob reaches only CUDA matmuls."""
    rng = np.random.default_rng(7)
    y = torch.as_tensor(_observations(rng, 4, 40, 3).astype(np.complex64))
    a = CACGMMTrainer().fit(y, num_classes=2, iterations=3)
    try:
        _precision.set_em_matmul_precision('high')
        b = CACGMMTrainer().fit(y, num_classes=2, iterations=3)
    finally:
        _precision.set_em_matmul_precision('highest')
    assert torch.equal(a.cacg.covariance_eigenvalues,
                       b.cacg.covariance_eigenvalues)
