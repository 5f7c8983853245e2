"""The port's FCA (``models.fca``) against the JAX package's on the same
seeded inputs (complex64): a fit from the same masks, a model carried
over by ``from_dict``, the monotone likelihood, the blind fit's warning
and the input checks. Small sizes (F=8, T=160, D=3, K=2)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.models import FCATrainer as JaxFCATrainer
from pb_bss_tpu_torch.models import FCA, FCATrainer

torch.set_num_threads(2)


def _scenario(seed=0, F=8, T=160, D=3, K=2, snr_scale=0.01):
    """A random full-rank instantaneous mixture of two sources with
    partly disjoint activity, (F, T, D) complex64, and its activity
    masks (F, K, T) float32."""
    rng = np.random.default_rng(seed)
    mixing = rng.standard_normal((F, D, K)) + 1j * rng.standard_normal(
        (F, D, K))
    activity = np.zeros((K, T))
    activity[0, :2 * T // 3] = 1.0
    activity[1, T // 3:] = 1.0
    s = (rng.standard_normal((F, K, T))
         + 1j * rng.standard_normal((F, K, T))) * activity[None]
    images = mixing.transpose(0, 2, 1)[:, :, None, :] * s[..., None]
    noise = snr_scale * (rng.standard_normal((F, T, D))
                         + 1j * rng.standard_normal((F, T, D)))
    y = (images.sum(axis=1) + noise).astype(np.complex64)
    masks = np.broadcast_to(activity[None], (F, K, T)) + 1e-3
    masks = (masks / masks.sum(1, keepdims=True)).astype(np.float32)
    return y, masks


@pytest.fixture(scope='module')
def fits():
    y, masks = _scenario()
    ours = FCATrainer().fit(torch.as_tensor(y),
                            initialization=torch.as_tensor(masks),
                            iterations=5)
    theirs = JaxFCATrainer().fit(jnp.asarray(y),
                                 initialization=jnp.asarray(masks),
                                 iterations=5)
    return y, masks, ours, theirs


def test_fit_from_masks_matches_jax(fits):
    """Five iterations in complex128, every field; one in complex64, the
    fields of the multiplicative updates. In f32 the packages part in
    the diagonalizer of a bin where an IP row's system has a condition
    number of ~2e4: f32 LU leaves a relative residual at the stable
    solve's gate (sqrt(eps) = 3.5e-4; 2.9e-4 in the JAX package, 6.8e-4
    in the port's LAPACK), so one package keeps the LU solution and the
    other takes the pseudo-inverse, and the later iterations follow."""
    y, masks, _, _ = fits
    for dtype, rdtype, iterations, tol, fields in (
            (np.complex64, np.float32, 1, 1e-5, ('eigenvalue', 'power')),
            (np.complex128, np.float64, 5, 1e-10,
             ('diagonalizer', 'eigenvalue', 'power'))):
        y_, m_ = y.astype(dtype), masks.astype(rdtype)
        ours = FCATrainer().fit(torch.as_tensor(y_),
                                initialization=torch.as_tensor(m_),
                                iterations=iterations)
        theirs = JaxFCATrainer().fit(jnp.asarray(y_),
                                     initialization=jnp.asarray(m_),
                                     iterations=iterations)
        assert ours.diagonalizer.dtype == torch.from_numpy(y_).dtype
        assert_allclose(ours.predict().numpy(),
                        np.asarray(theirs.predict()), atol=tol)
        for name in fields:
            ref = np.asarray(getattr(theirs, name))
            assert_allclose(getattr(ours, name).numpy(), ref, rtol=tol,
                            atol=tol * np.abs(ref).max())
        if 'diagonalizer' in fields:
            ref = np.asarray(theirs.separate(jnp.asarray(y_)))
            assert_allclose(ours.separate(torch.as_tensor(y_)).numpy(), ref,
                            rtol=tol, atol=tol * np.abs(ref).max())
            assert_allclose(
                float(ours.log_likelihood(torch.as_tensor(y_))),
                float(theirs.log_likelihood(jnp.asarray(y_))), rtol=tol)


def test_from_dict_of_a_jax_model_equals_jax(fits):
    y, _, _, theirs = fits
    model = FCA.from_dict({k: np.asarray(v)
                           for k, v in theirs.to_dict().items()})
    assert isinstance(model.diagonalizer, torch.Tensor)
    assert model.diagonalizer.dtype == torch.complex64
    assert_allclose(model.predict().numpy(), np.asarray(theirs.predict()),
                    rtol=1e-5, atol=1e-6)
    ref = np.asarray(theirs.separate(jnp.asarray(y)))
    assert_allclose(model.separate(torch.as_tensor(y)).numpy(), ref,
                    rtol=1e-4, atol=1e-5 * np.abs(ref).max())
    assert_allclose(float(model.log_likelihood(torch.as_tensor(y))),
                    float(theirs.log_likelihood(jnp.asarray(y))), rtol=1e-5)
    assert set(model.to_dict()) == set(theirs.to_dict())


def test_partitions_and_warm_start(fits):
    y, masks, ours, _ = fits
    y_t = torch.as_tensor(y)
    assert_allclose(ours.predict().sum(-2).numpy(), 1.0, atol=1e-5)
    assert (ours.predict() >= 0).all()
    assert_allclose(ours.separate(y_t).sum(1).numpy(), y, atol=1e-4)
    warm = FCATrainer().fit(y_t, initialization=ours, iterations=3)
    assert float(warm.log_likelihood(y_t)) >= float(
        ours.log_likelihood(y_t)) - 1e-4
    assert FCATrainer().fit_predict(
        y_t, initialization=torch.as_tensor(masks),
        iterations=1).shape == masks.shape


def test_log_likelihood_monotone():
    """float64 (complex128), as the JAX package's monotonicity test runs
    under x64: the MU / IP updates do not lower the likelihood beyond
    the floor's and epsilon's O(1e-8)."""
    y, _ = _scenario(seed=1)
    y = torch.as_tensor(y.astype(np.complex128))
    lls = [float(FCATrainer().fit(
        y, num_classes=2, iterations=it,
        generator=torch.Generator().manual_seed(0)).log_likelihood(y))
        for it in (1, 3, 8, 20)]
    assert (np.diff(lls) > -1e-8).all(), lls
    assert lls[-1] > lls[0] + 1.0, lls


def test_blind_fit_warns():
    y, _ = _scenario(seed=2, F=2, T=32)
    y = torch.as_tensor(y)
    with pytest.warns(UserWarning, match='Blind FCA fit'):
        FCATrainer().fit(y, num_classes=2, iterations=1,
                         generator=torch.Generator().manual_seed(0))
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        FCATrainer().fit(y, initialization=torch.full((2, 2, 32), 0.5),
                         iterations=1)


def test_input_validation():
    y = torch.ones((4, 10, 3), dtype=torch.complex64)
    with pytest.raises(AssertionError):  # both initialization and K
        FCATrainer().fit(y, num_classes=2, initialization=torch.ones(3))
    with pytest.raises(AssertionError):  # real observations
        FCATrainer().fit(torch.ones((4, 10, 3)), num_classes=2,
                         generator=torch.Generator())
    with pytest.raises(AssertionError):  # a blind fit needs a generator
        FCATrainer().fit(y, num_classes=2)
    with pytest.raises(AssertionError):  # masks of another F
        FCATrainer().fit(y, initialization=torch.ones((3, 2, 10)))
    with pytest.raises(AssertionError):
        FCATrainer().fit(y, num_classes=2, iterations=0,
                         generator=torch.Generator())
    # the JAX package refuses the same calls
    with pytest.raises(AssertionError):
        JaxFCATrainer().fit(jnp.ones((4, 10, 3)), num_classes=2,
                            key=jax.random.PRNGKey(0))


def test_folded_batch_equals_per_utterance_fits():
    """Every bin is independent: two utterances folded into the bin axis
    fit as each alone (the pipeline's batched refinement)."""
    (y0, m0), (y1, m1) = _scenario(seed=3, F=4), _scenario(seed=4, F=4)
    folded = FCATrainer().fit(
        torch.as_tensor(np.concatenate([y0, y1])),
        initialization=torch.as_tensor(np.concatenate([m0, m1])),
        iterations=3)
    for i, (y, m) in enumerate(((y0, m0), (y1, m1))):
        alone = FCATrainer().fit(torch.as_tensor(y),
                                 initialization=torch.as_tensor(m),
                                 iterations=3)
        torch.testing.assert_close(folded.predict()[4 * i:4 * i + 4],
                                   alone.predict(), atol=1e-5, rtol=1e-4)
