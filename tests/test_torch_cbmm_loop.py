"""The plain twin of the whole-fit Bingham kernel K9 (pb_bss_tpu_torch.ops.
cbmm_loop) against the port's scan path and the JAX package's scan path
on the same numpy inputs, held as the JAX suite holds its kernel against
its scan path (tests/test_ops/test_pallas_cbmm_loop.py): the twin solves
the moment equations by chord rounds with a finite-difference Jacobian,
the scan path by damped Gauss-Newton with the exact one, so the weights
agree to 5e-3, the eigenvalues to rtol 5e-2 / atol 0.5, and the
posteriors loosely elementwise and tightly on average."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models.cbmm import CBMMTrainer as JaxTrainer
from pb_bss_tpu_torch.models.cbmm import CBMMTrainer
from pb_bss_tpu_torch.ops import cbmm_loop

torch.set_num_threads(2)


def _mixture(F, D, T, K, seed=0, noise=0.2):
    """Unit-norm (F, T, D) observations around K planted axes per bin and
    a random (F, K, T) initial affiliation; the planted labels."""
    rng = np.random.default_rng(seed)
    modes = rng.standard_normal((F, K, D)) + 1j * rng.standard_normal(
        (F, K, D))
    modes /= np.linalg.norm(modes, axis=-1, keepdims=True)
    lab = np.arange(T) % K
    y = modes[:, lab] + noise * (rng.standard_normal((F, T, D))
                                 + 1j * rng.standard_normal((F, T, D)))
    y *= np.exp(2j * np.pi * rng.uniform(size=(F, T, 1)))
    y /= np.linalg.norm(y, axis=-1, keepdims=True)
    aff = rng.uniform(size=(F, K, T))
    aff /= aff.sum(1, keepdims=True)
    return y.astype(np.complex64), aff.astype(np.float32), lab


def _accuracy(aff, lab):
    pred = np.asarray(aff).argmax(1)
    K = np.asarray(aff).shape[1]
    return max(np.mean(np.asarray(p)[pred] == lab[None])
               for p in itertools.permutations(range(K)))


def _twin(y, aff, iterations, **kwargs):
    """The twin through the trainer's forced whole-fit route (no launch on
    the CPU)."""
    before = cbmm_loop.cbmm_em_full.launches
    model, posterior = CBMMTrainer(eigenvalue_eps=1e-3, **kwargs.pop(
        'trainer', {})).fit(
        torch.as_tensor(y), initialization=torch.as_tensor(aff),
        iterations=iterations, use_fused_em=True, _return_affiliation=True,
        **kwargs)
    assert cbmm_loop.cbmm_em_full.launches == before
    return model, posterior.numpy()


def _assert_close(model, posterior, weight, eigenvalues, reference_posterior):
    assert_allclose(model.weight.numpy(), weight, atol=5e-3)
    assert_allclose(model.complex_bingham.covariance_eigenvalues.numpy(),
                    eigenvalues, rtol=5e-2, atol=0.5)
    d = np.abs(posterior - reference_posterior)
    assert d.mean() < 5e-3 and d.max() < 0.2, (d.mean(), d.max())


@pytest.mark.parametrize('F,D,T,K', [(4, 3, 24, 2), (3, 5, 37, 3)])
def test_twin_matches_the_jax_scan_path(F, D, T, K):
    y, aff, lab = _mixture(F, D, T, K)
    model, posterior = _twin(y, aff, 2)
    scan = JaxTrainer(eigenvalue_eps=1e-3).fit(
        jnp.asarray(y), initialization=jnp.asarray(aff), iterations=2,
        use_fused_em=False)
    _assert_close(model, posterior, np.asarray(scan.weight),
                  np.asarray(scan.complex_bingham.covariance_eigenvalues),
                  np.asarray(scan.predict(jnp.asarray(y))))
    assert _accuracy(posterior, lab) > _accuracy(
        scan.predict(jnp.asarray(y)), lab) - 0.05
    # the final unclipped E-step is the model's predict
    assert_allclose(posterior, model.predict(torch.as_tensor(y)).numpy(),
                    atol=1e-5)


def test_twin_with_saliency_matches_the_port_scan_path():
    """Saliency weights the statistics and L1-normalizes the weight; the
    posterior clip runs in every E-step but the last."""
    y, aff, _ = _mixture(4, 3, 24, 2, seed=6)
    sal = np.random.default_rng(6).uniform(0.3, 1., (4, 24)).astype(
        np.float32)
    model, posterior = _twin(y, aff, 3, saliency=torch.as_tensor(sal),
                             affiliation_eps=1e-3)
    scan, scan_posterior = CBMMTrainer(eigenvalue_eps=1e-3).fit(
        torch.as_tensor(y), initialization=torch.as_tensor(aff),
        iterations=3, saliency=torch.as_tensor(sal), affiliation_eps=1e-3,
        use_fused_em=False, _return_affiliation=True)
    _assert_close(model, posterior, scan.weight.numpy(),
                  scan.complex_bingham.covariance_eigenvalues.numpy(),
                  scan_posterior.numpy())


def test_twin_with_max_concentration_matches_the_jax_scan_path():
    """A finite max_concentration bounds the diffs, floors the
    eigenvalues at -mc and spaces them again."""
    y, aff, _ = _mixture(4, 3, 24, 2, seed=7, noise=0.02)
    mc = 20.
    model, _ = _twin(y, aff, 2, trainer=dict(max_concentration=mc))
    scan = JaxTrainer(max_concentration=mc, eigenvalue_eps=1e-3).fit(
        jnp.asarray(y), initialization=jnp.asarray(aff), iterations=2,
        use_fused_em=False)
    ev = model.complex_bingham.covariance_eigenvalues.numpy()
    assert ev.min() >= -mc - 1e-2
    assert_allclose(ev, np.asarray(scan.complex_bingham
                                   .covariance_eigenvalues),
                    rtol=5e-2, atol=0.5)


def test_batched_twin_matches_per_utterance():
    """A leading batch axis folds into the bins."""
    y, aff, _ = _mixture(6, 3, 20, 2, seed=8)
    yb = torch.as_tensor(y).reshape(2, 3, 20, 3).transpose(-1, -2)
    ab = torch.as_tensor(aff).reshape(2, 3, 2, 20)
    out = cbmm_loop.cbmm_em_full(yb, ab, iterations=2)
    for b in range(2):
        one = cbmm_loop.cbmm_em_full(yb[b], ab[b], iterations=2)
        for x, z in zip(out, one):
            torch.testing.assert_close(x[b], z, atol=1e-5, rtol=1e-5)


def test_twin_warm_step_diagonalizes_the_new_scatter():
    """The twin's warm M-step is the kernel's: the scatter of the new
    posteriors rotated into the previous eigenbasis and 2 Jacobi sweeps
    give that scatter's eigenvectors, ascending by moment (held against
    float64 ``torch.linalg.eigh`` to |v^H v_ref| > 1 - 1e-4, on moments
    well apart). With no sweep (the control) the previous eigenvectors
    stay and miss them."""
    y, aff, _ = _mixture(4, 3, 40, 2, seed=9)
    yt = torch.as_tensor(y).transpose(-1, -2)
    first = cbmm_loop.cbmm_em_step_reference(yt, torch.as_tensor(aff))
    a = first[4].to(torch.complex128)
    y64 = yt.to(torch.complex128)
    scatter = torch.einsum('fkt,fdt,fet->fkde', a, y64, y64.conj()) \
        / a.real.sum(-1)[..., None, None]
    _, reference = torch.linalg.eigh(scatter)

    def align(vectors):
        return torch.einsum('fkdj,fkdj->fkj', vectors.to(torch.complex128)
                            .conj(), reference).abs()
    warm = cbmm_loop.cbmm_em_step_reference(yt, first[4], first[1:3])
    frozen = cbmm_loop.cbmm_em_step_reference(yt, first[4], first[1:3],
                                              warm_sweeps=0)
    assert (align(warm[2]) > 1 - 1e-4).all(), align(warm[2]).min()
    assert (align(frozen[2]) < 1 - 1e-3).any()
    # the loop of steps is the twin
    both = cbmm_loop.cbmm_em_full_reference(yt, torch.as_tensor(aff),
                                            iterations=2)
    for x, z in zip(both, warm):
        torch.testing.assert_close(x, z, atol=0, rtol=0)


def test_kernel_gate():
    assert cbmm_loop.fits(6, 3, 3750) and not cbmm_loop.fits(6, 3, 3751)
    assert cbmm_loop.fits(6, 3, 3515, True)
    assert not cbmm_loop.fits(6, 3, 3516, True)
    assert cbmm_loop.max_frames(6, 3) == 3750
    assert not cbmm_loop.fits(9, 3, 100) and not cbmm_loop.fits(1, 3, 100)
    assert cbmm_loop.fits(2, 2, 100) and cbmm_loop.fits(8, 4, 150)


@pytest.mark.slow
def test_twin_matches_the_pallas_kernel_in_interpret_mode():
    """The twin against the JAX package's whole-fit kernel (interpret
    mode) on the JAX suite's tiny configuration, with saliency."""
    from pb_bss_tpu.ops.pallas_cbmm_loop import cbmm_em_full
    y, aff, _ = _mixture(4, 3, 24, 2)
    sal = np.random.default_rng(6).uniform(0.3, 1., (4, 24)).astype(
        np.float32)
    y_t = np.swapaxes(y, -1, -2)
    ref = cbmm_em_full(jnp.asarray(y_t.real), jnp.asarray(y_t.imag),
                       jnp.asarray(aff), iterations=2, interpret=True,
                       saliency=jnp.asarray(sal))
    ours = cbmm_loop.cbmm_em_full(torch.as_tensor(y_t), torch.as_tensor(aff),
                                  iterations=2,
                                  saliency=torch.as_tensor(sal))
    assert_allclose(ours[0].numpy(), np.asarray(ref[0]), atol=1e-4)
    assert_allclose(ours[1].numpy(), np.asarray(ref[1]), rtol=5e-2,
                    atol=0.5)
    d = np.abs(ours[4].numpy() - np.asarray(ref[4]))
    assert d.mean() < 5e-3 and d.max() < 0.2


@pytest.mark.parametrize('D', [2, 6, 8, 16])
def test_kernel_shared_memory_matches_the_gate(D):
    """The kernel's shared memory (cbmm_smem_bytes in csrc/cbmm_loop.cu)
    for the CTA the host picks stays within the card's limit at the gate's
    largest T, and at one warp within the gate's formula; D=16 is past the
    gate."""
    from pb_bss_tpu_torch.ops._build import SMEM_LIMIT
    if D > 8:
        assert not cbmm_loop.fits(D, 3, 10)
        return
    for K, has_sal in itertools.product((1, 3, 5), (False, True)):
        T = cbmm_loop.max_frames(D, K, has_sal)
        assert cbmm_loop.fits(D, K, T, has_sal)
        warps = cbmm_loop._threads(D, K, T, has_sal) // 32
        assert cbmm_loop.kernel_smem_bytes(D, K, T, has_sal, warps) \
            <= SMEM_LIMIT
        assert cbmm_loop.kernel_smem_bytes(D, K, T, has_sal, 1) \
            <= cbmm_loop.smem_bytes(D, K, T, has_sal)
    # the slice shape: 8 CTAs an SM, 4 warps each
    assert cbmm_loop._threads(6, 3, 304) == 128


def test_threads_give_a_warp_per_class():
    """The CTA: whole warps, at most 8, at least one per class (the chord
    steps run a warp per class) up to 8 wherever they fit, and the Jacobi's
    column lanes of every class (floor(32 / D) classes a warp)."""
    from pb_bss_tpu_torch.ops._build import SMEM_LIMIT
    for D, K, has_sal in itertools.product(range(2, 9), (1, 2, 3, 5, 8),
                                           (False, True)):
        for T in (1, 32, 150, 304, cbmm_loop.max_frames(D, K, has_sal)):
            threads = cbmm_loop._threads(D, K, T, has_sal)
            warps = threads // 32
            assert threads % 32 == 0 and 1 <= warps <= 8
            if cbmm_loop.kernel_smem_bytes(D, K, T, has_sal, min(K, 8)) \
                    <= SMEM_LIMIT:
                assert warps >= min(K, 8)
                assert warps * (32 // D) >= min(K, 8 * (32 // D))
