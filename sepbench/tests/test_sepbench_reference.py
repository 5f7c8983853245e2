"""The reference against small NumPy computations written from the
definitions."""
from __future__ import annotations

import numpy as np
import pytest
import scipy.linalg
import torch

import small  # noqa: F401  (puts the repository on the path)
from sepbench import reference
from sepbench.reference import beamformer, dhtv, precision


def _signal(rng, *shape):
    return rng.standard_normal(shape)


def test_stft_against_numpy_frames():
    rng = np.random.default_rng(0)
    x = _signal(rng, 2, 1000)
    size, shift = 64, 16
    got = reference.stft(torch.as_tensor(x), size, shift).numpy()
    padded = np.pad(x, ((0, 0), (size - shift, size - shift)))
    frames = reference.stft_frames(1000, size, shift)
    padded = np.pad(padded, ((0, 0), (0, size + (frames - 1) * shift
                                      - padded.shape[-1])))
    window = np.blackman(size + 1)[:-1]  # the periodic window
    want = np.stack([np.fft.rfft(padded[:, t * shift:t * shift + size]
                                 * window) for t in range(frames)], 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_istft_inverts_stft():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(_signal(rng, 3, 777))
    back = reference.istft(reference.stft(x, 64, 16), 64, 16, 777)
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -12, -3.0, 0.0])
    got = precision.round_tf32(x)
    assert got.tolist() == [1 + 2 ** -10, 1 + 2 ** -10, -3.0, 0.0]
    a, b = torch.rand(8, 8), torch.rand(8, 8)
    exact = (a.double() @ b.double())
    rel = ((precision.mm(a, b, 'tf32') - exact).abs().max() / exact.abs().max())
    assert 1e-5 < rel < 2e-3


def _numpy_em(y, init, iterations, eps=1e-10, floor=1e-10):
    """The cACGMM EM of one bin by loops: y (T, D) unit vectors, init
    (K, T)."""
    T, D = y.shape
    K = init.shape[0]
    gamma = init.astype(float)
    q = np.ones((K, T))
    for it in range(iterations + 1):
        if it:
            logp = np.empty((K, T))
            for k in range(K):
                w, v = lam[k], vec[k]
                for t in range(T):
                    q[k, t] = max(np.sum(np.abs(v.conj().T @ y[t]) ** 2 / w),
                                  np.finfo(float).tiny)
                    logp[k, t] = -D * np.log(q[k, t]) - np.log(w).sum()
            a = np.exp(logp - logp.max(0)) * weight[:, None]
            gamma = a / a.sum(0)
            if it < iterations:
                gamma = np.clip(gamma, eps, 1 - eps)
            else:
                return gamma
        weight = gamma.mean(1)
        lam, vec = [], []
        for k in range(K):
            c = sum(gamma[k, t] / q[k, t] * np.outer(y[t], y[t].conj())
                    for t in range(T)) * D / gamma[k].sum()
            c = (c + c.conj().T) / 2
            w, v = np.linalg.eigh(c)
            lam.append(np.maximum(w / w.max(), floor))
            vec.append(v)


def test_em_against_numpy():
    rng = np.random.default_rng(2)
    B, D, T, F, K = 1, 3, 12, 2, 2
    spectrum = rng.standard_normal((B, D, T, F)) \
        + 1j * rng.standard_normal((B, D, T, F))
    init = rng.uniform(size=(B, F, K, T))
    init /= init.sum(2, keepdims=True)
    got = reference.cacgmm_em(torch.as_tensor(spectrum), torch.as_tensor(
        init, dtype=torch.float32), 3).numpy()
    for f in range(F):
        y = spectrum[0, :, :, f].T
        y = y / np.linalg.norm(y, axis=1, keepdims=True)
        want = _numpy_em(y, init[0, f].astype(np.float32).astype(float), 3)
        np.testing.assert_allclose(got[0, f], want, atol=1e-9)


def test_initialization_is_the_programs():
    from pb_bss_tpu_torch import pipeline
    got = reference.initialization(7, 3, 5, 2, 4, 'cpu')
    g = torch.Generator('cpu').manual_seed(7)
    want = torch.stack([pipeline._random_affiliation(
        u, (5, 2, 4), torch.float32, 'cpu')
        for u in pipeline.utterance_generators(g, 3, 'cpu')])
    assert torch.equal(got, want)
    # the rows a check compares are those rows of the whole batch's draw
    rows = reference.initialization(7, 3, 5, 2, 4, 'cpu', rows=[0, 2])
    assert torch.equal(rows, want[[0, 2]])


def test_dhtv_plan_and_greedy():
    assert dhtv.plan(257) == [
        [20, 70, 170], [2, 90, 190], [2, 50, 150], [2, 110, 210],
        [2, 30, 130], [2, 130, 230], [2, 0, 110], [2, 150, 257]]
    score = torch.tensor([[11., 10, 0], [4, 5, 10], [6, 0, 5]])
    # the largest first: (0, 0) = 11, then (1, 2) = 10, then (2, 1)
    assert dhtv._greedy(score).tolist() == [0, 2, 1]


def test_dhtv_undoes_a_known_permutation():
    rng = np.random.default_rng(3)
    K, F, T = 3, 257, 40
    base = rng.uniform(size=(K, T)) ** 4  # three distinct activity shapes
    mask = np.repeat(base[:, None], F, 1) + 0.05 * rng.uniform(
        size=(K, F, T))
    perms = [rng.permutation(K) for _ in range(F)]
    shuffled = np.stack([mask[perms[f], f] for f in range(F)], 1)
    m = torch.as_tensor(shuffled[None])
    aligned = reference.apply_mapping(m, reference.dhtv_mapping(m))[0]
    # one permutation for all bins is left, as DHTV leaves it
    ref = aligned[:, 0].numpy()
    order = [int(np.argmin(((mask[:, 0] - r) ** 2).sum(-1))) for r in ref]
    np.testing.assert_allclose(aligned.numpy(), mask[order], atol=0)


def test_gev_ban_against_scipy():
    rng = np.random.default_rng(4)
    D = 4

    def herm(scale):
        a = rng.standard_normal((D, D)) + 1j * rng.standard_normal((D, D))
        return a @ a.conj().T + scale * np.eye(D)
    xx, nn = herm(0.1), herm(0.5)
    w = beamformer.gev_ban(torch.as_tensor(xx[None]),
                           torch.as_tensor(nn[None]))[0].numpy()
    values, vectors = scipy.linalg.eigh(xx, nn)
    v = vectors[:, -1]
    v = v / np.sqrt(v.conj() @ nn @ v)  # w^H nn w = 1
    v = v * np.linalg.norm(nn @ v) / abs(v.conj() @ nn @ v)
    np.testing.assert_allclose(abs(np.vdot(v, w)),
                               np.linalg.norm(v) * np.linalg.norm(w),
                               rtol=1e-10)
    np.testing.assert_allclose(np.linalg.norm(w), np.linalg.norm(v),
                               rtol=1e-10)


def test_gev_retries_a_singular_noise_psd():
    xx = torch.eye(3, dtype=torch.complex128)[None] * 2
    nn = torch.diag(torch.tensor([1.0, 1.0, 0.0])).to(torch.complex128)[None]
    w = beamformer.gev_ban(xx, nn)
    assert torch.isfinite(w.abs()).all()


def test_chained_phases_make_neighbours_real():
    rng = np.random.default_rng(5)
    w = torch.as_tensor(rng.standard_normal((6, 3))
                        + 1j * rng.standard_normal((6, 3)))
    chained = beamformer.chain_phases(w)
    inner = (chained[1:].conj() * chained[:-1]).sum(-1)
    assert torch.allclose(inner.imag, torch.zeros(5, dtype=torch.float64),
                          atol=1e-12)
    assert (inner.real > 0).all()


@pytest.mark.parametrize('name', ['float64', 'float32', 'tf32'])
def test_precisions(name):
    assert precision.real_dtype(name) in (torch.float32, torch.float64)
