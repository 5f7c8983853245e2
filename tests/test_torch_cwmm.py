"""The complex Watson mixture model of the port (pb_bss_tpu_torch.models.
cwmm, scan path) against the JAX package on the same numpy inputs.

Single steps are held tightly; fits in complex64 by oracle-mask quality
(rule a of ROADMAP queue 3), in complex128 tightly."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models import complex_watson as jcw
from pb_bss_tpu.models.cwmm import CWMM as JaxCWMM
from pb_bss_tpu.models.cwmm import CWMMTrainer as JaxTrainer
from pb_bss_tpu.permutation_alignment import (
    DHTVPermutationAlignment as JaxDHTV,
    GreedyPermutationAlignment as JaxGreedy,
)
from pb_bss_tpu.testing.dummy_data import low_reverberation_data
from pb_bss_tpu.transform import stft as jstft
from pb_bss_tpu_torch.models.complex_watson import ComplexWatson
from pb_bss_tpu_torch.models.cwmm import CWMM, CWMMTrainer
from pb_bss_tpu_torch.permutation_alignment import (
    DHTVPermutationAlignment,
    GreedyPermutationAlignment,
)

torch.set_num_threads(2)


def _mixture(F=9, T=100, D=4, K=2, seed=0, dtype=np.complex64):
    """(F, T, D) unit-norm two-source mixture and a random (F, K, T)
    initial affiliation."""
    rng = np.random.default_rng(seed)
    atf = rng.standard_normal((F, D, 2)) + 1j * rng.standard_normal(
        (F, D, 2))
    s = rng.standard_normal((F, 2, T)) + 1j * rng.standard_normal((F, 2, T))
    y = np.einsum('fdk,fkt->ftd', atf, s) + 0.3 * (
        rng.standard_normal((F, T, D)) + 1j * rng.standard_normal((F, T, D)))
    y = y / np.linalg.norm(y, axis=-1, keepdims=True)
    aff = rng.uniform(size=(F, K, T))
    aff /= aff.sum(1, keepdims=True)
    real = np.float32 if dtype == np.complex64 else np.float64
    return y.astype(dtype), aff.astype(real)


def _fit_both(y, aff, iterations, **kwargs):
    jax_kwargs = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                  for k, v in kwargs.items()}
    ours_kwargs = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray)
                       else v) for k, v in kwargs.items()}
    theirs = JaxTrainer().fit(jnp.asarray(y), initialization=jnp.asarray(aff),
                              iterations=iterations, use_fused_em=False,
                              **jax_kwargs)
    ours = CWMMTrainer().fit(torch.as_tensor(y),
                             initialization=torch.as_tensor(aff),
                             iterations=iterations, use_fused_em=False,
                             **ours_kwargs)
    return ours, theirs


def _assert_models_close(ours, theirs, *, weight, kappa_rtol, overlap):
    assert_allclose(ours.weight.numpy(), np.asarray(theirs.weight),
                    atol=weight)
    assert_allclose(ours.complex_watson.concentration.numpy(),
                    np.asarray(theirs.complex_watson.concentration),
                    rtol=kappa_rtol)
    # modes carry an arbitrary phase per (bin, class)
    inner = np.abs(np.einsum('...d,...d->...',
                             ours.complex_watson.mode.numpy().conj(),
                             np.asarray(theirs.complex_watson.mode)))
    assert inner.min() > 1 - overlap


@pytest.mark.parametrize('knobs', [
    dict(), dict(weight_constant_axis=(-3, -1)), dict(saliency=True)],
    ids=['per_bin', 'fc', 'saliency'])
def test_one_m_step_matches_jax(knobs):
    knobs = dict(knobs)
    y, aff = _mixture(seed=1)
    if knobs.pop('saliency', False):
        knobs['saliency'] = np.random.default_rng(2).uniform(
            0.2, 1., y.shape[:-1]).astype(np.float32)
    ours, theirs = _fit_both(y, aff, 1, **knobs)
    # one M-step from the same affiliations: sums in another order and
    # two f32 Jacobi runs of the same algorithm
    _assert_models_close(ours, theirs, weight=1e-6, kappa_rtol=1e-5,
                         overlap=1e-5)


def test_one_e_step_on_a_fixed_model_matches_jax():
    """CWMM.predict of the same model: kappa in [5, 40] at D=4, where the
    two packages evaluate the log-norm with the same formula."""
    y, _ = _mixture(seed=3)
    rng = np.random.default_rng(4)
    mode = rng.standard_normal((9, 2, 4)) + 1j * rng.standard_normal(
        (9, 2, 4))
    mode = (mode / np.linalg.norm(mode, axis=-1, keepdims=True)
            ).astype(np.complex64)
    kappa = rng.uniform(5., 40., (9, 2)).astype(np.float32)
    weight = rng.uniform(0.2, 1., (9, 2, 1)).astype(np.float32)
    weight /= weight.sum(1, keepdims=True)
    ours = CWMM(weight=torch.as_tensor(weight), complex_watson=ComplexWatson(
        mode=torch.as_tensor(mode), concentration=torch.as_tensor(kappa)))
    theirs = JaxCWMM(weight=jnp.asarray(weight),
                     complex_watson=jcw.ComplexWatson(
                         mode=jnp.asarray(mode),
                         concentration=jnp.asarray(kappa)))
    out = ours.predict(torch.as_tensor(y))
    assert out.shape == (9, 2, 100) and out.dtype == torch.float32
    assert_allclose(out.numpy(), np.asarray(theirs.predict(jnp.asarray(y))),
                    atol=1e-5)


def test_five_iterations_in_c128_match_jax():
    y, aff = _mixture(seed=5, dtype=np.complex128)
    ours, theirs = _fit_both(y, aff, 5)
    assert ours.complex_watson.mode.dtype == torch.complex128
    _assert_models_close(ours, theirs, weight=1e-8, kappa_rtol=1e-8,
                         overlap=1e-8)
    assert_allclose(ours.predict(torch.as_tensor(y)).numpy(),
                    np.asarray(theirs.predict(jnp.asarray(y))), atol=1e-8)


@pytest.mark.parametrize('knobs', [
    dict(weight_constant_axis=(-3, -1)), dict(saliency=True),
    dict(weight_constant_axis=(-3, -1), aligner='dhtv'),
    dict(weight_constant_axis=(-3, -1), aligner='greedy')],
    ids=['fc', 'saliency', 'dhtv', 'greedy'])
def test_fits_with_weights_and_inline_aligners_match_jax(knobs):
    """Three iterations in complex128 under the knobs of the scan path:
    frequency-constant weights, saliency, and the inline DHTV and Greedy
    aligners (whose mappings must agree for the fits to)."""
    knobs = dict(knobs)
    y, aff = _mixture(F=13, T=80, seed=6, dtype=np.complex128)
    if knobs.pop('saliency', False):
        knobs['saliency'] = np.random.default_rng(7).uniform(
            0.2, 1., y.shape[:-1])
    aligner = knobs.pop('aligner', None)
    jax_kwargs = dict(knobs)
    if aligner == 'dhtv':
        plan = dict(stft_size=24, segment_start=4, segment_width=6,
                    segment_shift=2, main_iterations=5, sub_iterations=2)
        knobs['inline_permutation_aligner'] = DHTVPermutationAlignment(
            **plan)
        jax_kwargs['inline_permutation_aligner'] = JaxDHTV(**plan)
    elif aligner == 'greedy':
        knobs['inline_permutation_aligner'] = GreedyPermutationAlignment(
            'cos')
        jax_kwargs['inline_permutation_aligner'] = JaxGreedy('cos')
    theirs = JaxTrainer().fit(
        jnp.asarray(y), initialization=jnp.asarray(aff), iterations=3,
        use_fused_em=False, **{k: (jnp.asarray(v) if isinstance(
            v, np.ndarray) else v) for k, v in jax_kwargs.items()})
    ours = CWMMTrainer().fit(
        torch.as_tensor(y), initialization=torch.as_tensor(aff),
        iterations=3, use_fused_em=False, **{k: (torch.as_tensor(v) if
            isinstance(v, np.ndarray) else v) for k, v in knobs.items()})
    _assert_models_close(ours, theirs, weight=1e-8, kappa_rtol=1e-7,
                         overlap=1e-8)


@pytest.mark.parametrize('use_fused_em', [False, True])
def test_fit_predict_returns_the_fitted_models_prediction(use_fused_em):
    y, aff = _mixture(seed=8)
    Y = torch.as_tensor(y)
    kwargs = dict(initialization=torch.as_tensor(aff), iterations=3,
                  use_fused_em=use_fused_em)
    model, posterior = CWMMTrainer().fit(Y, _return_affiliation=True,
                                         **kwargs)
    torch.testing.assert_close(CWMMTrainer().fit_predict(Y, **kwargs),
                               posterior, atol=0, rtol=0)
    # the whole-fit twin's last E-step is the model's predict
    torch.testing.assert_close(posterior, model.predict(Y), atol=1e-6,
                               rtol=0)


def test_random_init_draws_from_the_generator():
    y, _ = _mixture(F=3, T=20)
    Y = torch.as_tensor(y)
    a = CWMMTrainer().fit(Y, num_classes=2, iterations=2)
    b = CWMMTrainer().fit(Y, num_classes=2, iterations=2,
                          generator=torch.Generator().manual_seed(0))
    c = CWMMTrainer().fit(Y, num_classes=2, iterations=2,
                          generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.weight, b.weight)
    assert not torch.equal(a.weight, c.weight)
    assert a.weight.shape == (3, 2, 1)
    assert a.complex_watson.mode.shape == (3, 2, 4)


def test_two_directions_are_separated():
    """Two well-separated directional clusters on the complex sphere are
    recovered."""
    rng = np.random.RandomState(2)
    D = 3
    modes = np.eye(D, dtype=complex)[:2]
    x = np.concatenate([
        np.tile(modes[k], (2000, 1))
        + 0.15 * (rng.randn(2000, D) + 1j * rng.randn(2000, D))
        for k in range(2)])
    model = CWMMTrainer().fit(torch.as_tensor(x), num_classes=2,
                              iterations=30)
    est = model.complex_watson.mode.numpy()
    scores = np.abs(est.conj() @ modes.T)
    if scores[0, 0] + scores[1, 1] < scores[0, 1] + scores[1, 0]:
        est = est[::-1]
    for k in range(2):
        cos = np.abs(est[k].conj() @ modes[k]) / np.linalg.norm(est[k])
        assert cos > 0.97, (k, cos)


def _scenario(F_step=16, T=300):
    """A dummy-data STFT (every 16th bin, 300 frames) with its oracle
    labels and the speech-dominated points where they are scored."""
    data = low_reverberation_data(0)

    def spec(x):
        return np.asarray(jstft(jnp.asarray(x, jnp.float32)))[
            ..., :T, ::F_step]

    Y = spec(data['observation']).transpose(2, 1, 0)  # (F, T, D)
    energies = np.stack([
        np.abs(spec(data['speech_image'][0, 0])) ** 2,
        np.abs(spec(data['speech_image'][1, 0])) ** 2,
        np.abs(spec(data['noise_image'][0])) ** 2]).transpose(0, 2, 1)
    oracle = energies.argmax(0)
    scored = (oracle != 2) & (energies[:2].max(0) > 4 * energies[2])
    return np.ascontiguousarray(Y, np.complex64), oracle, scored


def _oracle_accuracy(affiliation, oracle, scored):
    labels = affiliation.argmax(1)
    accs = []
    for f in range(labels.shape[0]):
        if scored[f].any():
            accs.append(max(
                np.mean(np.asarray(perm)[labels[f]][scored[f]]
                        == oracle[f][scored[f]])
                for perm in itertools.permutations(range(3))))
    return float(np.mean(accs))


def test_twenty_iterations_in_c64_hold_jax_quality():
    Y, oracle, scored = _scenario()
    F, T, _ = Y.shape
    rng = np.random.default_rng(9)
    init = rng.uniform(size=(F, 3, T)).astype(np.float32)
    init /= init.sum(1, keepdims=True)
    acc_j = _oracle_accuracy(np.asarray(JaxTrainer().fit_predict(
        jnp.asarray(Y), initialization=jnp.asarray(init), iterations=20,
        use_fused_em=False)), oracle, scored)
    acc_t = _oracle_accuracy(CWMMTrainer().fit_predict(
        torch.as_tensor(Y), initialization=torch.as_tensor(init),
        iterations=20, use_fused_em=False).numpy(), oracle, scored)
    assert acc_j > 0.6, acc_j
    assert abs(acc_t - acc_j) < 0.03, (acc_t, acc_j)
