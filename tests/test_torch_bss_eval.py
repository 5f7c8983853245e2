"""The port's BSS-Eval (host float64 oracle, device program) and invasive
SXR against pb_bss_tpu.evaluation's on the same numpy signals (x64 JAX
on the CPU, so the JAX device programs run in float64 too)."""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from pb_bss_tpu.evaluation import module_bss_eval_device as jdev
from pb_bss_tpu.evaluation import sxr_module as jsxr
from pb_bss_tpu.evaluation import bss_eval_sources as jbss_eval_sources
from pb_bss_tpu.evaluation import mir_eval_sources as jmir_eval_sources
from pb_bss_tpu_torch.evaluation import (
    bss_eval_sources,
    bss_eval_sources_batch,
    bss_eval_sources_device,
    get_snr,
    input_sxr,
    mir_eval_sources,
    mir_eval_sources_batch,
    output_sxr,
)
from pb_bss_tpu_torch.evaluation import module_bss_eval_device as dev
from pb_bss_tpu_torch.evaluation import sxr_module

torch.set_num_threads(2)


def _scenario(seed, k=2, t=3000, m=None):
    """Convolutive toy mixture: estimates = filtered refs + leakage."""
    rng = np.random.RandomState(seed)
    refs = rng.randn(k, t)
    m = k if m is None else m
    ests = np.zeros((m, t))
    for i in range(m):
        j = i % k
        h = rng.randn(16) * 0.5 ** np.arange(16)
        ests[i] = np.convolve(refs[j], h)[:t]
        ests[i] += 0.1 * refs[(j + 1) % k] + 0.05 * rng.randn(t)
    return refs, ests


def _k_plus_one(seed, t=2500):
    refs, ests = _scenario(seed, k=2, t=t, m=3)
    rng = np.random.RandomState(seed + 100)
    ests[2] = 0.9 * rng.randn(t) + 0.05 * ests[2]
    return refs, ests[[2, 0, 1]]


def _close(got, expected, atol):
    for g, e in zip(got[:3], expected[:3]):
        assert_allclose(g, e, atol=atol)
    if len(expected) > 3:
        assert_array_equal(got[3], expected[3])


# ---------------------------------------------------------------------
# host oracle: the port's copy against the JAX package's
# ---------------------------------------------------------------------

@pytest.mark.parametrize('seed,k,permutation', [(0, 2, True), (1, 3, True),
                                                 (2, 3, False)])
def test_host_oracle_matches_jax(seed, k, permutation):
    refs, ests = _scenario(seed, k=k)
    ests = ests[np.roll(np.arange(k), 1)]
    got = bss_eval_sources(refs, ests, compute_permutation=permutation,
                           filter_length=128)
    expected = jbss_eval_sources(refs, ests,
                                 compute_permutation=permutation,
                                 filter_length=128)
    _close(got, expected, 1e-12)


def test_host_mir_eval_k_plus_one_and_channels_match_jax():
    refs, ests = _k_plus_one(3)
    got = mir_eval_sources(refs, ests, return_dict=True)
    expected = jmir_eval_sources(refs, ests, return_dict=True)
    assert set(got) == set(expected)
    for key in expected:
        assert_allclose(got[key], expected[key], atol=1e-12)
    # a channel axis: (K, D, T) recursion
    stacked_refs = np.stack([refs, 1.1 * refs], 1)
    stacked_ests = np.stack([ests[1:], ests[:2]], 1)
    got = mir_eval_sources(stacked_refs, stacked_ests)
    expected = jmir_eval_sources(stacked_refs, stacked_ests)
    for g, e in zip(got, expected):
        assert_allclose(g, e, atol=1e-12)


# ---------------------------------------------------------------------
# device program
# ---------------------------------------------------------------------

def test_toeplitz_index_map_equals_jax():
    ssf = np.random.default_rng(0).standard_normal((2, 3, 40))
    got = dev._toeplitz_last(torch.as_tensor(ssf), 8).numpy()
    assert_array_equal(got, np.asarray(jdev._toeplitz_last(ssf, 8)))


@pytest.mark.parametrize('seed,k', [(0, 2), (1, 3)])
def test_device_float64_matches_jax_and_host(seed, k):
    refs, ests = _scenario(seed, k=k)
    ests = ests[np.roll(np.arange(k), 1)]
    got = bss_eval_sources_device(refs, ests, filter_length=128,
                                  device='cpu')
    _close(got, jdev.bss_eval_sources_device(refs, ests,
                                             filter_length=128), 1e-8)
    _close(got, bss_eval_sources(refs, ests, filter_length=128), 1e-8)


def test_device_float64_512_taps():
    refs, ests = _scenario(3, k=2, t=4000)
    got = bss_eval_sources_device(refs, ests, device='cpu')
    _close(got, bss_eval_sources(refs, ests), 1e-7)


def test_device_diagonal_pairing():
    refs, ests = _scenario(4, k=3)
    got = bss_eval_sources_device(refs, ests, compute_permutation=False,
                                  filter_length=64, device='cpu')
    _close(got, jbss_eval_sources(refs, ests, compute_permutation=False,
                                  filter_length=64), 1e-8)
    assert_array_equal(got[3], [0, 1, 2])


def test_device_float32_against_the_float64_oracle():
    """The loaded Cholesky with two refinement steps holds 0.05 dB on a
    correlated (ill-conditioned) speech-like Gram at float32."""
    rng = np.random.RandomState(5)
    common = np.convolve(rng.randn(4000), np.ones(8) / 8, 'same')
    refs = 0.7 * common + 0.3 * rng.randn(2, 4000)
    ests = refs + 0.05 * rng.randn(2, 4000)
    got = bss_eval_sources_device(refs.astype(np.float32),
                                  ests.astype(np.float32),
                                  filter_length=128, device='cpu')
    assert got[0].dtype == np.float32
    _close(got, bss_eval_sources(refs, ests, filter_length=128), 0.05)


def test_k_plus_one_routing_matches_jax_and_host():
    refs, ests = _k_plus_one(9)
    expected = mir_eval_sources(refs, ests, return_dict=True)
    got = mir_eval_sources_batch(refs, ests, device='cpu')
    ref = jdev.mir_eval_sources_batch(refs, ests)
    assert_array_equal(got['selection'], expected['selection'])
    assert_array_equal(got['selection'], ref['selection'])
    assert 0 not in got['selection']
    for key in ('sdr', 'sir', 'sar'):
        assert_allclose(got[key], expected[key], atol=1e-8)
        assert_allclose(got[key], ref[key], atol=1e-8)
    got32 = mir_eval_sources_batch(refs.astype(np.float32),
                                   ests.astype(np.float32), device='cpu')
    assert_array_equal(got32['selection'], expected['selection'])
    for key in ('sdr', 'sir', 'sar'):
        assert_allclose(got32[key], expected[key], atol=0.05)


def test_batch_with_leading_dims_matches_the_loop():
    pairs = [_scenario(s, k=2, t=2000) for s in (6, 7, 8, 9)]
    refs = np.stack([p[0] for p in pairs]).reshape(2, 2, 2, 2000)
    ests = np.stack([p[1][::-1] for p in pairs]).reshape(2, 2, 2, 2000)
    out = bss_eval_sources_batch(torch.as_tensor(refs), ests,
                                 filter_length=64, device='cpu')
    assert out['sdr'].shape == out['selection'].shape == (2, 2, 2)
    for i in range(2):
        for j in range(2):
            e = bss_eval_sources(refs[i, j], ests[i, j], filter_length=64)
            for n, key in enumerate(('sdr', 'sir', 'sar', 'selection')):
                assert_allclose(out[key][i, j], e[n], atol=1e-8)


def test_return_forms_and_guards():
    refs, ests = _scenario(10, k=2, t=1500)
    sdr, sir, sar, sel = mir_eval_sources_batch(
        refs, ests, return_dict=False, device='cpu')
    assert sdr.shape == sel.shape == (2,)
    out = mir_eval_sources_batch(refs, ests, compute_permutation=False,
                                 device='cpu')
    assert set(out) == {'sdr', 'sir', 'sar'}
    assert len(mir_eval_sources_batch(refs, ests, return_dict=False,
                                      compute_permutation=False,
                                      device='cpu')) == 3
    refs3, ests3 = _k_plus_one(11, t=1500)
    with pytest.raises(NotImplementedError):
        bss_eval_sources_batch(refs3, ests3, compute_permutation=False,
                               device='cpu')
    with pytest.raises(AssertionError):
        bss_eval_sources_batch(refs, ests[:, :1000], device='cpu')


def test_device_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    refs, ests = _scenario(12, k=2, t=1500)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bss_eval_sources_batch(refs, ests)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bss_eval_sources_device(refs, ests)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mir_eval_sources_batch(refs, ests)


# ---------------------------------------------------------------------
# invasive SXR (host)
# ---------------------------------------------------------------------

def test_sxr_matches_jax():
    rng = np.random.RandomState(13)
    images = rng.randn(2, 3, 1000) * np.array([[[1.0]], [[0.4]]])
    noise = 0.1 * rng.randn(3, 1000)
    for kwargs in (dict(), dict(average_sources=False),
                   dict(average_sources=False, average_channels=False,
                        return_dict=True),
                   dict(return_dict='input_')):
        got = input_sxr(images, noise, **kwargs)
        expected = jsxr.input_sxr(images, noise, **kwargs)
        if isinstance(expected, dict):
            assert set(got) == set(expected)
            got, expected = got.values(), expected.values()
        for g, e in zip(got, expected):
            assert_allclose(g, e, rtol=1e-12)
    contribution = rng.randn(2, 3, 1000) * np.array(
        [[[1.0], [0.1], [0.05]], [[0.2], [0.02], [1.3]]])
    noise3 = 0.1 * rng.randn(3, 1000)
    got = output_sxr(contribution, noise3, average_sources=False)
    expected = jsxr.output_sxr(contribution, noise3,
                               average_sources=False)
    for g, e in zip(got, expected):
        assert_allclose(g, e, rtol=1e-12)
    assert float(get_snr(images[0], noise)) == float(
        jsxr.get_snr(images[0], noise))
    x, n = rng.randn(500), rng.randn(500)
    _, scaled = sxr_module.set_snr(x, n, 12.0, inplace=False)
    assert_allclose(get_snr(x, scaled), 12.0, atol=1e-12)
    n2 = n.copy()
    jsxr.set_snr(x, n2, 12.0)
    assert_allclose(scaled, n2, rtol=1e-15)
