"""pb_bss_tpu_torch.initializer.deterministic.flag and
.deflation.deflationSeed against the JAX package's on the same numpy
inputs.

``flag`` is exact (a one-hot and one floor). ``deflationSeed`` runs a
PSD, a principal eigenvector and a squared projection in float32 in both
packages; the posteriors are held at atol 5e-5 (measured: 2.5e-6 with
one peak for every bin, 9.4e-6 with a peak per bin).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_bss_tpu.initializer.deflation import deflationSeed as jax_deflation
from pb_bss_tpu.initializer.deterministic import flag as jax_flag
from pb_bss_tpu_torch.initializer import deflation, deterministic
from pb_bss_tpu_torch.initializer.deflation import deflationSeed
from pb_bss_tpu_torch.initializer.deterministic import flag

torch.set_num_threads(2)


def _observation(F, T, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((F, T, D))
            + 1j * rng.standard_normal((F, T, D))).astype(np.complex64)


@pytest.mark.parametrize('shape', [(40, 4), (5, 41, 3)])
@pytest.mark.parametrize('minimum', [0, 0.1])
def test_flag_matches_jax(shape, minimum):
    Y = _observation(1, *shape[-2:], 0)[0]
    Y = np.array(np.broadcast_to(Y, shape))
    ours = flag(torch.from_numpy(Y), 3,
                permutation_free=True, minimum=minimum)
    theirs = np.asarray(jax_flag(jnp.asarray(Y), 3, permutation_free=True,
                                 minimum=minimum))
    assert ours.dtype == torch.float32
    assert ours.shape == theirs.shape == (*shape[:-2], 3, shape[-2])
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ours.sum(-2).numpy(), 1, rtol=1e-6)


def test_flag_raises_without_permutation_free():
    Y = _observation(1, 10, 2, 0)[0]
    with pytest.raises(NotImplementedError):
        flag(torch.from_numpy(Y), 2)
    with pytest.raises(NotImplementedError):
        jax_flag(jnp.asarray(Y), 2)


@pytest.mark.parametrize('options', [
    dict(),
    dict(permutation_free=False),
    dict(eps=1e-3),
    dict(neighbors=3, similarity_transform='square'),
], ids=['permutation_free', 'per_frequency', 'eps', 'transform'])
def test_deflation_seed_matches_jax(options):
    F, T, D, K = 257, 60, 4, 3
    Y = _observation(F, T, D, 1)
    options = dict(options)
    jax_options = dict(options)
    if options.get('similarity_transform') == 'square':
        options['similarity_transform'] = \
            lambda s, sal: s ** 2 * (sal > 0)
        jax_options['similarity_transform'] = \
            lambda s, sal: s ** 2 * (sal > 0)
    ours = deflationSeed(torch.from_numpy(Y), K, **options)
    theirs = np.asarray(jax_deflation(jnp.asarray(Y), K, **jax_options))
    assert ours.shape == theirs.shape == (K, F, T)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), theirs, atol=5e-5)
    np.testing.assert_allclose(ours.sum(0).numpy(), 1, rtol=1e-5)


@pytest.mark.parametrize('permutation_free', [True, False])
def test_deflation_seed_takes_the_first_of_tied_peaks(permutation_free):
    """Saliencies with two equal maxima (frames 20 and 45): both
    packages' argmax takes the first, so the windows and posteriors
    agree."""
    F, T, D, K = 257, 60, 4, 3
    Y = _observation(F, T, D, 2)
    saliencies = np.ones((F, T), np.float32)
    saliencies[:, 20] = saliencies[:, 45] = 5.0
    ours = deflationSeed(torch.from_numpy(Y), K,
                         saliencies=torch.from_numpy(saliencies),
                         permutation_free=permutation_free)
    theirs = np.asarray(jax_deflation(
        jnp.asarray(Y), K, saliencies=jnp.asarray(saliencies),
        permutation_free=permutation_free))
    np.testing.assert_allclose(ours.numpy(), theirs, atol=5e-5)
    # the first deflation step's window is centred on frame 20: with
    # that frame's peak alone the first class is the same
    first = saliencies.copy()
    first[:, 45] = 1.0
    alone = deflationSeed(torch.from_numpy(Y), 2,
                          saliencies=torch.from_numpy(first),
                          permutation_free=permutation_free)
    tied = deflationSeed(torch.from_numpy(Y), 2,
                         saliencies=torch.from_numpy(saliencies),
                         permutation_free=permutation_free)
    np.testing.assert_array_equal(alone.numpy(), tied.numpy())


def test_deflation_seed_asserts_the_stft_size():
    Y = torch.from_numpy(_observation(17, 30, 3, 0))
    with pytest.raises(AssertionError):
        deflationSeed(Y, 2)


def test_initializer_modules_are_exported():
    assert deflation.__all__ == ['deflationSeed']
    assert deterministic.__all__ == ['flag']
