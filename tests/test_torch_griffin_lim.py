"""pb_bss_tpu_torch.transform's Griffin-Lim / MISI against
pb_bss_tpu.transform's on the same numpy STFTs (x64 JAX on the CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.transform import griffin_lim_module as jgl
from pb_bss_tpu.transform import stft as jstft
from pb_bss_tpu_torch.transform import MISI, GriffinLim, stft
from pb_bss_tpu_torch.transform.griffin_lim_module import griffin_lim, misi

torch.set_num_threads(2)

SIZE, SHIFT = 256, 64


@pytest.fixture(scope='module')
def scene():
    rng = np.random.default_rng(0)
    sources = rng.standard_normal((2, 3000))
    sources[1] *= np.linspace(0.2, 1.5, 3000)
    y = sources.sum(0)
    X = np.array(jstft(jnp.asarray(sources), SIZE, SHIFT, fading=False))
    return sources, y, X


def _kwargs():
    return dict(size=SIZE, shift=SHIFT)


def test_stfts_agree(scene):
    sources, _, X = scene
    ours = stft(torch.as_tensor(sources), SIZE, SHIFT, fading=False)
    assert_allclose(ours.numpy(), X, atol=1e-10)


@pytest.mark.parametrize('cls,jcls,first_guess', [
    (GriffinLim, jgl.GriffinLim, 'istft'),
    (GriffinLim, jgl.GriffinLim, 'y'),
    (MISI, jgl.MISI, 'y')])
def test_class_steps_match_jax(scene, cls, jcls, first_guess):
    _, y, X = scene
    ours = cls(torch.as_tensor(X), y=torch.as_tensor(y),
               first_guess=first_guess, **_kwargs())
    ref = jcls(X, y=y, first_guess=first_guess, **_kwargs())
    assert_allclose(ours.x_hat.numpy(), np.asarray(ref.x_hat), atol=1e-10)
    for _ in range(3):
        ours.step()
        ref.step()
    assert_allclose(ours.x_hat.numpy(), np.asarray(ref.x_hat), atol=1e-9)
    assert_allclose(ours.X_dash.numpy(), np.asarray(ref.X_dash),
                    atol=1e-8)


@pytest.mark.parametrize('iterations', [0, 1, 6])
def test_functional_forms_match_jax(scene, iterations):
    _, y, X = scene
    out = griffin_lim(torch.as_tensor(X), iterations, **_kwargs())
    ref = jgl.griffin_lim(X, iterations, **_kwargs())
    assert_allclose(out.numpy(), np.asarray(ref), atol=1e-9)
    out = misi(torch.as_tensor(X), torch.as_tensor(y), iterations,
               **_kwargs())
    ref = jgl.misi(X, y, iterations, **_kwargs())
    assert_allclose(out.numpy(), np.asarray(ref), atol=1e-9)


def test_iterations_raise_consistency(scene):
    """Each Griffin-Lim step can only lower the inconsistency of the
    projected STFT."""
    sources, y, X = scene
    gl = GriffinLim(torch.as_tensor(X), **_kwargs())
    gaps = []
    for _ in range(5):
        gl.step()
        redone = gl.stft(gl.istft(gl.X_dash))
        gaps.append(float((gl.X_dash - redone).abs().pow(2).mean()))
    assert all(b <= a * (1 + 1e-9) for a, b in zip(gaps, gaps[1:]))


def test_white_noise_first_guess_follows_the_generator(scene):
    _, _, X = scene
    X = torch.as_tensor(X)
    draw = [GriffinLim(X, first_guess='white_gaussian_noise',
                       generator=torch.Generator().manual_seed(s),
                       **_kwargs()).x_hat for s in (3, 3, 4)]
    assert draw[0].shape == GriffinLim(X, **_kwargs()).x_hat.shape
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    with pytest.raises(ValueError):
        GriffinLim(X, first_guess='random_phase', **_kwargs())


def test_evaluate_matches_jax(scene):
    sources, y, X = scene
    ours = MISI(torch.as_tensor(X), y=torch.as_tensor(y), first_guess='y',
                **_kwargs())
    ref = jgl.MISI(X, y=y, first_guess='y', **_kwargs())
    for _ in range(2):
        ours.step()
        ref.step()
    n = sources.shape[-1]
    ours.x_hat = ours.x_hat[:, :n]
    ref.x_hat = ref.x_hat[:, :n]
    got = ours.evaluate(sources)
    expected = ref.evaluate(sources)
    assert set(got) == set(expected)
    for key in expected:
        assert_allclose(got[key], expected[key], rtol=1e-7)
