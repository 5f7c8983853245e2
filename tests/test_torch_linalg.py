"""The port's stable solve, pseudo-inverse solve, PCA and unit norm
against the JAX package's on the same seeded inputs (complex64 unless
noted), and the namespace aliases (``ops``, ``math.solve``)."""
import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.ops import linalg as jl
from pb_bss_tpu_torch.ops import linalg as tl

torch.set_num_threads(2)


def _cn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _systems(seed=0, batch=12, D=5, N=2):
    """Regular systems with a zero, two rank-deficient and an inf
    matrix planted."""
    rng = np.random.default_rng(seed)
    a = _cn(rng, batch, D, D)
    b = _cn(rng, batch, D, N)
    a[1] = 0
    a[3, :, 0] = a[3, :, 1]  # two equal columns
    u = _cn(rng, D, 2)
    a[5] = u @ u.conj().T  # rank 2
    a[7] *= np.inf  # every entry infinite
    return a, b


def test_stable_solve_matches_jax_and_never_raises():
    a, b = _systems()
    ref = np.asarray(jl.stable_solve(jnp.asarray(a), jnp.asarray(b)))
    out = tl.stable_solve(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert out.dtype == np.complex64
    finite = [i for i in range(len(a)) if i != 7]
    assert np.isfinite(out[finite]).all()
    # the inf system is non-finite in both packages
    assert not np.isfinite(out[7]).all() and not np.isfinite(ref[7]).all()
    # f32 LU in two libraries; the pinv route the same Jacobi
    assert_allclose(out[finite], ref[finite], rtol=1e-4, atol=1e-4)
    assert np.all(out[1] == 0)  # zero matrix: zero solution
    regular = [i for i in finite if i not in (1, 3, 5)]
    assert_allclose(out[regular], np.linalg.solve(a[regular], b[regular]),
                    rtol=1e-4, atol=1e-4)


def test_stable_solve_singular_batch_float64_matches_lstsq():
    """float64: the rank-deficient systems take the minimum-norm
    least-squares solution (numpy's lstsq), as in the JAX package."""
    a, b = _systems(seed=1)
    a, b = a[:7].astype(np.complex128), b[:7].astype(np.complex128)
    out = tl.stable_solve(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    for i in (3, 5):
        x_ref = np.linalg.lstsq(a[i], b[i], rcond=None)[0]
        assert_allclose(out[i], x_ref, rtol=1e-6, atol=1e-8)
    ref = np.asarray(jl.stable_solve(jnp.asarray(a), jnp.asarray(b)))
    assert_allclose(out, ref, rtol=1e-7, atol=1e-7 * np.abs(ref).max())


def _straddling_systems(seed=48, count=256, D=6):
    """``count`` copies of one Hermitian system of condition 2e4 (the
    condition of the noise PSDs of the low bins where the MVDR drift was
    found), each entry of ``a`` moved by up to 6e-8 relative (an ulp of
    float32), and one right-hand side (a rank-2 target PSD)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(_cn(rng, D, D).astype(np.complex128))
    a = (q * np.logspace(0, -4.3, D)) @ q.conj().T
    v = _cn(rng, D, 2).astype(np.complex128)
    noise = rng.uniform(-1, 1, (count, D, D)) * 6e-8
    a = a[None] * (1 + noise)
    a = (a + np.swapaxes(a.conj(), -1, -2)) / 2
    b = np.broadcast_to(v @ v.conj().T, (count, D, D))
    return a.astype(np.complex64), np.ascontiguousarray(b, np.complex64)


def test_stable_solve_residual_gate_flips_on_last_bits():
    """A fault of the reference (ROADMAP queue 3), kept by the port:
    stable_solve takes the pseudo-inverse solution where the LU
    solution's relative residual exceeds sqrt(eps), and for a system
    of condition ~2e4 that residual is f32 rounding noise of the order
    of the gate itself. Inputs one ulp apart then land on both sides of
    the gate, in both packages, and the two solutions differ wholesale:
    the amplifier of separate_batch(beamformer='mvdr_souden+ban')'s
    drift on the CPU (the MVDR-Souden solve of a near-singular noise
    PSD; measured 0.54-1.47 of the gate over one-ulp perturbations of
    one such bin of the parallel pipeline test's speech)."""
    a, b = _straddling_systems()
    lu = torch.linalg.solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    for name, x, direct in (
            ('port', tl.stable_solve(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy(), lu),
            ('jax', np.asarray(jl.stable_solve(jnp.asarray(a),
                                               jnp.asarray(b))),
             np.asarray(jnp.linalg.solve(jnp.asarray(a),
                                         jnp.asarray(b))))):
        pinv = np.abs(x - direct).max((-2, -1)) > 0
        # both branches are taken on inputs one ulp apart ...
        assert 0 < pinv.mean() < 1, (name, pinv.mean())
        # ... and they part by the whole solution
        jump = np.abs(x[pinv] - direct[pinv]).max() / np.abs(direct).max()
        assert jump > 0.5, (name, jump)


@pytest.mark.parametrize('hermitian', [False, True])
def test_solve_pinv_matches_jax(hermitian):
    rng = np.random.default_rng(2)
    a = _cn(rng, 9, 4, 4)
    if hermitian:
        a = a @ a.conj().swapaxes(-1, -2)
    a[2] = 0
    u = _cn(rng, 4, 1)
    a[4] = u @ u.conj().T  # rank 1, Hermitian
    b = _cn(rng, 9, 4, 3)
    ref = np.asarray(jl.solve_pinv(jnp.asarray(a), jnp.asarray(b),
                                   hermitian=hermitian))
    out = tl.solve_pinv(torch.as_tensor(a), torch.as_tensor(b),
                        hermitian=hermitian).numpy()
    scale = np.abs(ref).max()
    # the same cyclic Jacobi in two f32 implementations
    assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * scale)
    assert np.all(out[2] == 0)


def test_get_pca_matches_jax():
    rng = np.random.default_rng(3)
    a = _cn(rng, 7, 3, 5, 5)
    psd = a @ a.conj().swapaxes(-1, -2)
    ref_v, ref_w = (np.asarray(x) for x in jl.get_pca(jnp.asarray(psd)))
    out_v, out_w = (x.numpy() for x in tl.get_pca(torch.as_tensor(psd)))
    assert_allclose(out_w, ref_w, rtol=1e-5)
    inner = np.einsum('...d,...d->...', ref_v.conj(), out_v)
    # eigenvectors up to a phase per matrix
    assert_allclose(np.abs(inner), 1, atol=1e-5)
    assert_allclose(out_v / (inner / np.abs(inner))[..., None], ref_v,
                    atol=1e-5)
    all_v, all_w = tl.get_pca(torch.as_tensor(psd), return_all_vecs=True)
    assert all_v.shape == psd.shape and all_w.shape == psd.shape[:-1]
    assert_allclose(all_w.numpy(), np.asarray(
        jl.get_pca(jnp.asarray(psd), return_all_vecs=True)[1]), rtol=1e-5,
        atol=1e-5 * np.abs(ref_w).max())


@pytest.mark.parametrize('eps_style', ['plus', 'max', 'where'])
@pytest.mark.parametrize('ord', [None, 1])
def test_unit_norm_matches_jax(eps_style, ord):
    rng = np.random.default_rng(4)
    signal = _cn(rng, 6, 4)
    signal[2] = 0
    signal[4] *= 1e-6
    ref = np.asarray(jl.unit_norm(jnp.asarray(signal), eps=1e-4,
                                  eps_style=eps_style, ord=ord))
    out = tl.unit_norm(torch.as_tensor(signal), eps=1e-4,
                       eps_style=eps_style, ord=ord).numpy()
    assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    assert np.all(out[2] == 0)


def test_unit_norm_rejects_unknown_options():
    x = torch.ones(3, 2)
    with pytest.raises(ValueError):
        tl.unit_norm(x, eps_style='min')
    with pytest.raises(NotImplementedError):
        tl.unit_norm(x, ord=3)


def test_namespace_aliases():
    """``ops`` re-exports the JAX package's ``ops`` names; ``ops.eigh``
    is the Jacobi kernel's module, the function is ``ops.linalg.eigh``."""
    from pb_bss_tpu_torch import ops
    from pb_bss_tpu_torch.math import solve
    import pb_bss_tpu.ops as jops
    for name in ('eigh_jacobi', 'force_hermitian', 'unit_norm',
                 'stable_solve', 'solve_pinv', 'get_pca', 'gev_max_eigvec',
                 'condition_hermitian'):
        assert hasattr(jops, name)
        assert getattr(ops, name) is getattr(tl, name)
    import pb_bss_tpu_torch.ops.eigh as eigh_kernel
    assert ops.eigh is eigh_kernel and callable(ops.linalg.eigh)
    assert solve.stable_solve is tl.stable_solve
    assert solve.solve_pinv is tl.solve_pinv


@pytest.mark.parametrize('module_name', [
    'pb_bss_tpu_torch.utils', 'pb_bss_tpu_torch.ops.linalg'])
def test_port_doctests(module_name):
    import importlib
    module = importlib.import_module(module_name)
    with np.printoptions(legacy=False):
        result = doctest.testmod(module, optionflags=doctest.ELLIPSIS)
    assert result.failed == 0, result


def test_utils_match_jax():
    from pb_bss_tpu import utils as ju
    from pb_bss_tpu_torch import utils as tu
    rng = np.random.default_rng(5)
    x = _cn(rng, 3, 4)
    assert_allclose(tu.abs_square(torch.as_tensor(x)).numpy(),
                    np.asarray(ju.abs_square(jnp.asarray(x))), rtol=1e-6)
    assert_allclose(tu.abs_square(torch.as_tensor(x.real)).numpy(),
                    x.real ** 2, rtol=1e-6)
    for kwargs in (dict(), dict(axis=-1), dict(axis=1, dtype=np.float64)):
        labels = [[0, 2], [1, 1]]
        np.testing.assert_array_equal(
            tu.labels_to_one_hot(labels, 3, **kwargs),
            ju.labels_to_one_hot(labels, 3, **kwargs))
    np.testing.assert_array_equal(
        tu.labels_to_one_hot([[2], [0]], 4, axis=-1, keepdims=True),
        ju.labels_to_one_hot([[2], [0]], 4, axis=-1, keepdims=True))
    np.testing.assert_array_equal(tu.get_stft_center_frequencies(512, 8000),
                                  ju.get_stft_center_frequencies(512, 8000))
