"""Beamformers of the port against the JAX package on the same
inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pb_bss_tpu.extraction import beamformer as jbf
from pb_bss_tpu.extraction.beamformer_wrapper import (
    get_bf_vector as jax_get_bf_vector,
)
from pb_bss_tpu_torch.extraction import beamformer as bf
from pb_bss_tpu_torch.extraction.beamformer_wrapper import get_bf_vector

torch.set_num_threads(2)


def _cn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _psds(F=11, K=3, D=4, T=50, seed=0):
    rng = np.random.default_rng(seed)
    Y = _cn(rng, F, D, T)
    mask = rng.uniform(size=(F, K, T)).astype(np.float32)
    return Y, mask


@pytest.mark.parametrize('kind', ['none', 'time', 'classes', 'bool'])
def test_psd_matches_jax(kind):
    Y, mask = _psds()
    m = {'none': None, 'time': mask[:, 0], 'classes': mask,
         'bool': mask > 0.5}[kind]
    ref = np.asarray(jbf.get_power_spectral_density_matrix(
        jnp.asarray(Y), None if m is None else jnp.asarray(m)))
    out = bf.get_power_spectral_density_matrix(
        torch.as_tensor(Y), None if m is None else torch.as_tensor(m))
    assert out.dtype == torch.complex64
    assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def _pd(rng, *shape):
    a = _cn(rng, *shape)
    return a @ a.conj().swapaxes(-1, -2) + 0.1 * np.eye(shape[-1],
                                                       dtype=np.complex64)


def test_ban_matches_jax_including_zero_psd():
    rng = np.random.default_rng(1)
    w = _cn(rng, 9, 4)
    noise = _pd(rng, 9, 4, 4)
    noise[2] = 0  # zero PSD: zero gain, not NaN
    ref = np.asarray(jbf.blind_analytic_normalization(
        jnp.asarray(w), jnp.asarray(noise)))
    out = bf.blind_analytic_normalization(
        torch.as_tensor(w), torch.as_tensor(noise)).numpy()
    assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert np.all(out[2] == 0)


def test_phase_correction_matches_jax():
    w = _cn(np.random.default_rng(2), 2, 17, 4)
    ref = np.asarray(jbf.phase_correction(jnp.asarray(w)))
    out = bf.phase_correction(torch.as_tensor(w)).numpy()
    assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_apply_beamforming_vector_matches_jax():
    rng = np.random.default_rng(3)
    w, Y = _cn(rng, 7, 4), _cn(rng, 7, 4, 30)
    ref = np.asarray(jbf.apply_beamforming_vector(
        jnp.asarray(w), jnp.asarray(Y)))
    out = bf.apply_beamforming_vector(
        torch.as_tensor(w), torch.as_tensor(Y)).numpy()
    assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('name', ['gev', 'gev+ban'])
def test_get_bf_vector_matches_jax(name):
    """The pipeline's call: per class, the other classes as noise.
    Compared after removing each bin's arbitrary phase."""
    Y, mask = _psds(F=13, D=6, T=80, seed=4)
    psds = np.array(jbf.get_power_spectral_density_matrix(
        jnp.asarray(Y), jnp.asarray(mask)))  # (F, K, D, D)
    phi_nn = psds.sum(1, keepdims=True) - psds
    ref = np.asarray(jax_get_bf_vector(
        name, jnp.asarray(psds), jnp.asarray(phi_nn)))
    out = get_bf_vector(
        name, torch.as_tensor(psds), torch.as_tensor(phi_nn)).numpy()
    inner = np.einsum('...d,...d->...', ref.conj(), out)
    aligned = out / (inner / np.abs(inner))[..., None]
    # staged GEV in two f32 implementations; BAN rescales by |.| only
    assert_allclose(aligned, ref, rtol=1e-4, atol=1e-4)


def test_unported_beamformer_raises():
    """Every JAX name is ported: an unknown name raises ValueError and
    LCMV fails its assert, as in the JAX package."""
    psd = torch.eye(3, dtype=torch.complex64)[None]
    with pytest.raises(ValueError, match='mvdr_soudem'):
        get_bf_vector('mvdr_soudem', psd, psd)
    with pytest.raises(ValueError):
        jax_get_bf_vector('mvdr_soudem', jnp.asarray(psd.numpy()),
                          jnp.asarray(psd.numpy()))
    for name in ('lcmv', 'lcmv+ban'):
        with pytest.raises(AssertionError, match='LCMV'):
            get_bf_vector(name, psd, psd)


DSL_NAMES = [
    'pca', 'pca+ban', 'pca+mvdr', 'scaled_gev_atf+mvdr',
    'mvdr_souden', 'mvdr_souden+ban', 'rank1_pca+mvdr_souden',
    'rank1_gev+mvdr_souden+ban', 'gev', 'rank1_pca+gev',
    'rank1_gev+gev+ban', 'wmwf', 'rank1_pca+wmwf', 'rank1_gev+wmwf+ban',
    'ch0', 'ch3+ban',
]
# names whose vector carries an eigenvector's arbitrary phase per bin
PHASE_FREE = {'pca', 'pca+ban', 'pca+mvdr', 'scaled_gev_atf+mvdr', 'gev',
              'rank1_pca+gev', 'rank1_gev+gev+ban'}


def _class_psds(F=9, K=3, D=5, T=60, seed=7):
    Y, mask = _psds(F=F, K=K, D=D, T=T, seed=seed)
    psds = np.array(jbf.get_power_spectral_density_matrix(
        jnp.asarray(Y), jnp.asarray(mask)))  # (F, K, D, D)
    return psds, psds.sum(1, keepdims=True) - psds


@pytest.mark.parametrize('name', DSL_NAMES)
def test_get_bf_vector_dsl_matches_jax(name):
    """Every name of the JAX package's DSL on one class's (F, D, D)
    PSDs, the other classes as noise."""
    psds, phi_nn = _class_psds()
    target, noise = psds[:, 0], phi_nn[:, 0]
    ref = np.asarray(jax_get_bf_vector(
        name, jnp.asarray(target), jnp.asarray(noise)))
    out = get_bf_vector(name, torch.as_tensor(target),
                        torch.as_tensor(noise)).numpy()
    assert out.shape == ref.shape == target.shape[:-1]
    assert out.dtype == np.complex64
    if name in PHASE_FREE:
        inner = np.einsum('...d,...d->...', ref.conj(), out)
        out = out / (inner / np.abs(inner))[..., None]
    # f32 solves and Jacobi sweeps in two implementations
    assert_allclose(out, ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize('name', ['mvdr_souden', 'mvdr_souden+ban', 'wmwf',
                                  'rank1_gev+mvdr_souden+ban'])
def test_batched_reference_channel_equals_jax_per_call(name):
    """The pipeline's one call on (B, K, F, D, D) picks the reference
    channel per (utterance, class) over the bins: it equals the JAX
    package's per-(b, k) calls on (F, D, D)."""
    B, K = 2, 3
    stacks = [_class_psds(seed=20 + b) for b in range(B)]
    psds = np.stack([p for p, _ in stacks]).swapaxes(1, 2)  # (B, K, F..)
    phi_nn = np.stack([n for _, n in stacks]).swapaxes(1, 2)
    out = get_bf_vector(name, torch.as_tensor(psds),
                        torch.as_tensor(phi_nn)).numpy()
    for b in range(B):
        for k in range(K):
            ref = np.asarray(jax_get_bf_vector(
                name, jnp.asarray(psds[b, k]), jnp.asarray(phi_nn[b, k])))
            assert_allclose(out[b, k], ref, rtol=1e-3,
                            atol=1e-4 * np.abs(ref).max())
    # the reference channels themselves, exactly
    for b in range(B):
        for k in range(K):
            _, ref_channel = jbf.get_mvdr_vector_souden(
                jnp.asarray(psds[b, k]), jnp.asarray(phi_nn[b, k]),
                return_ref_channel=True)
            _, channels = bf.get_mvdr_vector_souden(
                torch.as_tensor(psds), torch.as_tensor(phi_nn),
                return_ref_channel=True)
            assert int(channels[b, k]) == int(ref_channel)


class TestMvdrSoudenPathologies:
    """The zero / inf / eps semantics of the JAX package's
    tests/test_extraction/test_beamformer.py (TestMvdrSoudenPathologies)
    on the port, float64."""

    def setup_method(self):
        obs = np.array([[0, 0, 1], [0, 0.1, 1], [0.1, 0, 1]])
        self.PhiXX = obs.T.conj() @ obs
        self.PhiNN = np.eye(3)

    @staticmethod
    def souden(*args, **kwargs):
        return bf.get_mvdr_vector_souden(
            *(torch.as_tensor(a) for a in args), **kwargs)

    def get_w_well_behaviour(self):
        w, = self.souden(self.PhiXX[None], self.PhiNN[None]).numpy()
        return w

    def test_well_behaviour(self):
        w = self.get_w_well_behaviour()
        assert_allclose(w, [0.03311258, 0.03311258, 0.99337748], rtol=1e-6)
        w3 = self.souden(np.asarray([self.PhiXX] * 3),
                         np.asarray([self.PhiNN] * 3)).numpy()
        assert_allclose([w] * 3, w3)

    def test_zero_matrices_yield_zero_beamformer(self):
        for args in [
            (self.PhiXX[None] * 0, self.PhiNN[None]),
            (self.PhiXX[None], self.PhiNN[None] * 0),
            (self.PhiXX[None] * 0, self.PhiNN[None] * 0),
        ]:
            assert_allclose(self.souden(*args).numpy(), [[0., 0., 0.]],
                            atol=1e-12)

    def test_inf_matrices_raise(self):
        for args in [
            (self.PhiXX[None] * np.inf, self.PhiNN[None]),
            (self.PhiXX[None], self.PhiNN[None] * np.inf),
            (self.PhiXX[None] * np.inf, self.PhiNN[None] * np.inf),
        ]:
            with pytest.raises(AssertionError):
                self.souden(*args)

    def test_difficulties_without_eps_single(self):
        for args in [
            (self.PhiXX[None] * 0, self.PhiNN[None]),
            (self.PhiXX[None], self.PhiNN[None] * 0),
            (self.PhiXX[None] * 0, self.PhiNN[None] * 0),
            (self.PhiXX[None] * np.inf, self.PhiNN[None]),
            (self.PhiXX[None], self.PhiNN[None] * np.inf),
            (self.PhiXX[None] * np.inf, self.PhiNN[None] * np.inf),
        ]:
            with pytest.raises(AssertionError):
                self.souden(*args, eps=0)

    def test_difficulties_eps_multi(self):
        """Zero bins damage only themselves; the reference channel comes
        from the healthy bin."""
        well_w = self.get_w_well_behaviour()
        for args in [
            (np.asarray([self.PhiXX * 0, self.PhiXX]),
             np.asarray([self.PhiNN, self.PhiNN])),
            (np.asarray([self.PhiXX, self.PhiXX]),
             np.asarray([self.PhiNN * 0, self.PhiNN])),
            (np.asarray([self.PhiXX * 0, self.PhiXX]),
             np.asarray([self.PhiNN * 0, self.PhiNN])),
        ]:
            w, ref_channel = self.souden(*args, return_ref_channel=True)
            assert int(ref_channel) == 2, ref_channel
            assert_allclose(w.numpy(), np.array([[0., 0., 0.], well_w]),
                            atol=1e-10)

    def test_difficulties_without_eps_multi(self):
        for args in [
            (np.asarray([self.PhiXX * 0, self.PhiXX]),
             np.asarray([self.PhiNN, self.PhiNN])),
            (np.asarray([self.PhiXX, self.PhiXX]),
             np.asarray([self.PhiNN * 0, self.PhiNN])),
            (np.asarray([self.PhiXX * np.inf, self.PhiXX]),
             np.asarray([self.PhiNN, self.PhiNN])),
        ]:
            with pytest.raises(AssertionError):
                self.souden(*args, eps=0)

    def test_batched_input_makes_no_assert(self):
        """On (..., F, D, D) input with leading dims (the pipeline's) a
        non-finite SNR gives NaN out, with no assert (the JAX package
        under jit)."""
        target = np.stack([self.PhiXX[None] * np.inf, self.PhiXX[None]])
        noise = np.stack([self.PhiNN[None]] * 2)
        w = self.souden(target, noise).numpy()
        assert not np.isfinite(w[0]).all()
        assert_allclose(w[1, 0], self.get_w_well_behaviour(), rtol=1e-6)


def test_other_estimators_match_jax():
    """MVDR (ATF form, MERL), LCMV, wMWF options, the postfilters and
    normalizations, PCA scalings, condition_covariance and online
    beamforming on the same inputs as the JAX package's."""
    rng = np.random.default_rng(9)
    psds, phi_nn = _class_psds()
    target, noise = psds[:, 0], phi_nn[:, 0]
    F, D = target.shape[:2]
    atf = _cn(rng, F, D)
    t = {k: torch.as_tensor(v) for k, v in
         dict(target=target, noise=noise, atf=atf).items()}
    j = {k: jnp.asarray(v) for k, v in
         dict(target=target, noise=noise, atf=atf).items()}

    def check(ours, theirs, rtol=1e-3):
        theirs = np.asarray(theirs)
        assert_allclose(ours.numpy(), theirs, rtol=rtol,
                        atol=1e-4 * np.abs(theirs).max())

    check(bf.get_mvdr_vector(t['atf'], t['noise']),
          jbf.get_mvdr_vector(j['atf'], j['noise']))
    check(bf.get_mvdr_vector_merl(t['target'], t['noise']),
          jbf.get_mvdr_vector_merl(j['target'], j['noise']))
    atfs = _cn(rng, 2, F, D)
    check(bf.get_lcmv_vector(torch.as_tensor(atfs), [1, 0], t['noise']),
          jbf.get_lcmv_vector(jnp.asarray(atfs), [1, 0], j['noise']))
    for kwargs in (dict(reference_channel=2),
                   dict(distortion_weight='frequency_dependent'),
                   dict(distortion_weight=0.5),
                   dict(channel_selection_vector=np.eye(D)[1])):
        check(bf.get_wmwf_vector(t['target'], t['noise'], **kwargs),
              jbf.get_wmwf_vector(j['target'], j['noise'], **kwargs))
    check(bf.get_mvdr_vector_souden(t['target'], t['noise'], ref_channel=1),
          jbf.get_mvdr_vector_souden(j['target'], j['noise'], ref_channel=1))
    w = bf.get_mvdr_vector(t['atf'], t['noise'])
    w_j = jnp.asarray(w.numpy())
    check(bf.distortionless_normalization(w, t['atf'], t['noise']),
          jbf.distortionless_normalization(w_j, j['atf'], j['noise']))
    check(bf.mvdr_snr_postfilter(w, t['target'], t['noise']),
          jbf.mvdr_snr_postfilter(w_j, j['target'], j['noise']))
    check(bf.zero_degree_normalization(w, 1),
          jbf.zero_degree_normalization(w_j, 1))
    check(bf.condition_covariance(t['noise'], 1e-3),
          jbf.condition_covariance(j['noise'], 1e-3))
    for scaling in ('trace', 'eigenvalue'):
        ours = bf.get_pca_vector(t['target'], scaling).numpy()
        theirs = np.asarray(jbf.get_pca_vector(j['target'], scaling))
        assert_allclose(np.abs(ours), np.abs(theirs), rtol=1e-3,
                        atol=1e-4 * np.abs(theirs).max())
    online = _cn(rng, D, F, 7)
    mix = _cn(rng, F, 7, D)
    check(bf.apply_online_beamforming_vector(torch.as_tensor(online),
                                             torch.as_tensor(mix)),
          jbf.apply_online_beamforming_vector(jnp.asarray(online),
                                              jnp.asarray(mix)))
    Y, mask = _psds(F=5, K=2, D=3, T=20, seed=11)
    for kwargs in (dict(sensor_dim=-2, time_dim=-1),
                   dict(source_dim=-3)):
        m = mask.swapaxes(0, 1) if 'source_dim' in kwargs else mask
        check(bf.get_power_spectral_density_matrix(
            torch.as_tensor(Y), torch.as_tensor(m), **kwargs),
            jbf.get_power_spectral_density_matrix(
                jnp.asarray(Y), jnp.asarray(m), **kwargs), rtol=1e-5)
    Yt = Y.transpose(2, 0, 1)  # (T, F, D)
    check(bf.get_power_spectral_density_matrix(
        torch.as_tensor(Yt), sensor_dim=-1, time_dim=0),
        jbf.get_power_spectral_density_matrix(
            jnp.asarray(Yt), sensor_dim=-1, time_dim=0), rtol=1e-5)
    with pytest.raises(NotImplementedError):
        bf.get_lcmv_vector_souden(t['target'], t['target'], t['noise'])


def test_rank_one_helpers_and_response_vector_match_jax():
    from pb_bss_tpu.extraction import beamformer_wrapper as jw
    from pb_bss_tpu_torch.extraction import beamformer_wrapper as tw
    psds, phi_nn = _class_psds()
    target, noise = psds[:, 1], phi_nn[:, 1]
    for ours, theirs in (
            (tw.get_pca_rank_one_estimate(torch.as_tensor(target)),
             jw.get_pca_rank_one_estimate(jnp.asarray(target))),
            (tw.get_gev_rank_one_estimate(torch.as_tensor(target),
                                          torch.as_tensor(noise)),
             jw.get_gev_rank_one_estimate(jnp.asarray(target),
                                          jnp.asarray(noise)))):
        theirs = np.asarray(theirs)
        assert_allclose(ours.numpy(), theirs, rtol=1e-3,
                        atol=1e-4 * np.abs(theirs).max())
    for args in ((1, 3), (0, 2, 0.1)):
        np.testing.assert_array_equal(tw._get_response_vector(*args),
                                      jw._get_response_vector(*args))


def test_extraction_namespace_matches_jax():
    import pb_bss_tpu.extraction as je
    import pb_bss_tpu_torch.extraction as te
    public = [n for n in dir(je) if not n.startswith('_')]
    missing = [n for n in public if not hasattr(te, n)]
    assert not missing, missing
    assert te.get_single_source_bf_vector is get_bf_vector
