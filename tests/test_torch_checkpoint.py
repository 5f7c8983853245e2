"""The port's checkpoints (pb_bss_tpu_torch.utils.checkpoint): ``.npz``
round trips in both directions between the packages for every model
class with nested models, restore by name, the directory checkpoint,
and a resumed fit from a restored model."""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pb_bss_tpu.models as jax_models
from pb_bss_tpu.utils import checkpoint as jax_checkpoint
import pb_bss_tpu_torch.models as models
from pb_bss_tpu_torch.utils import checkpoint

torch.set_num_threads(2)


def _leaves(d, prefix=''):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f'{prefix}{k}/'))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _cacgmm_dict(rng, F=4, K=2, D=3):
    v = np.linalg.qr(rng.standard_normal((F, K, D, D))
                     + 1j * rng.standard_normal((F, K, D, D)))[0]
    return {'weight': rng.random((F, K, 1)).astype(np.float32), 'cacg': {
        'covariance_eigenvectors': v.astype(np.complex64),
        'covariance_eigenvalues': rng.random((F, K, D)).astype(np.float32)}}


def _model_dicts():
    rng = np.random.default_rng(0)
    mean = rng.standard_normal((2, 3))
    return {
        'CACGMM': _cacgmm_dict(rng),
        'GMM': {'weight': rng.random((2, 1)), 'gaussian': {
            'mean': mean, 'covariance': np.tile(np.eye(3), (2, 1, 1))}},
        'VMFMM': {'weight': rng.random((2, 1)), 'vmf': {
            'mean': mean / np.linalg.norm(mean, axis=-1, keepdims=True),
            'concentration': rng.random(2) * 10}},
        'ComplexCircularSymmetricGaussian': {
            'covariance': np.eye(3, dtype=np.complex128)},
        'BinaryGMM': {'means': mean},
    }


@pytest.mark.parametrize('name', sorted(_model_dicts()))
def test_jax_npz_loads_in_the_port_and_back(name, tmp_path):
    d = _model_dicts()[name]
    jax_model = getattr(jax_models, name).from_dict(d)
    path = jax_checkpoint.save_model_npz(tmp_path / 'jax.npz', jax_model)
    ours = checkpoint.load_model_npz(path, name)
    assert isinstance(ours, getattr(models, name))
    mine, theirs = _leaves(ours.to_dict()), _leaves(jax_model.to_dict())
    assert mine.keys() == theirs.keys()
    for key in mine:
        assert mine[key].dtype == theirs[key].dtype, key
        assert_allclose(mine[key], theirs[key])
    # and the port's file loads in the JAX package
    back = jax_checkpoint.load_model_npz(
        checkpoint.save_model_npz(tmp_path / 'port.npz', ours), name)
    for key, value in _leaves(back.to_dict()).items():
        assert_allclose(value, theirs[key])


def test_flatten_layout_matches_jax():
    d = _model_dicts()['CACGMM']
    model = models.CACGMM.from_dict(d)
    ours = checkpoint._flatten_dict(model.to_dict())
    theirs = jax_checkpoint._flatten_dict(d)
    assert sorted(ours) == sorted(theirs) == [
        'cacg/covariance_eigenvalues', 'cacg/covariance_eigenvectors',
        'weight']
    assert checkpoint._unflatten_dict(ours).keys() == d.keys()


def test_directory_checkpoint_round_trip(tmp_path):
    model = models.CACGMM.from_dict(_model_dicts()['CACGMM'])
    path = checkpoint.save_model(tmp_path / 'ckpt', model)
    assert (path / 'model.npz').is_file()
    restored = checkpoint.load_model(path, models.CACGMM)
    assert torch.equal(restored.cacg.covariance_eigenvectors,
                       model.cacg.covariance_eigenvectors)


def test_resume_from_a_jax_checkpoint(tmp_path):
    """A JAX fit saved as .npz resumes as the initialization of the
    port's trainer."""
    rng = np.random.default_rng(1)
    y = (rng.standard_normal((4, 50, 3))
         + 1j * rng.standard_normal((4, 50, 3))).astype(np.complex64)
    model = jax_models.CACGMMTrainer().fit(y, num_classes=2, iterations=3)
    path = jax_checkpoint.save_model_npz(tmp_path / 'model.npz', model)
    restored = checkpoint.load_model_npz(path, models.CACGMM)
    resumed = models.CACGMMTrainer().fit(
        torch.as_tensor(y), initialization=restored, iterations=2)
    affiliation = resumed.predict(torch.as_tensor(y))
    assert_allclose(affiliation.sum(-2).numpy(), 1.0, rtol=1e-5)
