"""The port's utils (pb_bss_tpu_torch.utils) and model-base helpers
(pb_bss_tpu_torch.models.base) against the JAX package's: ``reshape``,
``unsqueeze``, ``is_broadcast_compatible``, ``to_numpy``, ``deprecated``,
``Model.replace``, ``static_field``, ``parameter_from_dict``,
``get_trainer_class_from_model`` and ``stack_parameters``, and the
modules' doctests."""
import dataclasses
import doctest

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pb_bss_tpu.models as jax_models
import pb_bss_tpu.utils as jax_utils
import pb_bss_tpu_torch.models as models
import pb_bss_tpu_torch.utils as utils
from pb_bss_tpu_torch.models import base

OPERATIONS = [
    ('f t d -> d (f t)', (2, 3, 4)),
    ('f t d -> d t f', (2, 3, 4)),
    ('f t d -> d f*t', (2, 3, 4)),
    ('a b c d -> (a b) (c d)', (2, 3, 4, 5)),
    ('a 1 b -> b a', (2, 1, 3)),
    ('a b -> a 1 b', (2, 3)),
    ('a b c -> c (b a)', (2, 3, 4)),
]


@pytest.mark.parametrize('operation,shape', OPERATIONS)
def test_reshape_matches_jax(operation, shape):
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    ours = utils.reshape(torch.as_tensor(x), operation)
    assert_allclose(ours.numpy(), np.asarray(jax_utils.reshape(x, operation)))


def test_reshape_refuses_unflatten():
    with pytest.raises(NotImplementedError, match='Unflatten'):
        utils.reshape(torch.zeros(6), '(a b) -> a b')


@pytest.mark.parametrize('shape,axis', [((2, 3), (-3, -1)), ((), (-2, -1)),
                                        ((4,), (0, 2)), ((2, 3), (1,))])
def test_unsqueeze_matches_jax(shape, axis):
    x = np.ones(shape)
    assert tuple(utils.unsqueeze(torch.as_tensor(x), axis).shape) == \
        jax_utils.unsqueeze(x, axis).shape


@pytest.mark.parametrize('shapes', [
    [(5, 1, 6), (5, 3, 6)], [(5, 2, 6), (5, 3, 6)], [(3,)], [(1,), ()],
    [(4, 1), (1, 5), (4, 5)], [(2, 3), (3, 2)]])
def test_is_broadcast_compatible_matches_jax(shapes):
    assert utils.is_broadcast_compatible(*shapes) == \
        jax_utils.is_broadcast_compatible(*shapes)


@pytest.mark.parametrize('dtype', [torch.float32, torch.complex64,
                                   torch.complex128, torch.int64])
def test_to_numpy(dtype):
    x = (torch.arange(6).reshape(2, 3) + 1).to(dtype)
    if dtype.is_complex:
        x = x + 2j * x
        view = x.conj()  # a lazily conjugated view
        assert_allclose(utils.to_numpy(view), np.conj(utils.to_numpy(x)))
    out = utils.to_numpy(x)
    assert isinstance(out, np.ndarray)
    assert out.dtype == torch.empty((), dtype=dtype).numpy().dtype
    assert_allclose(out, x.numpy())
    assert_allclose(utils.to_numpy([1, 2]), [1, 2])


def test_deprecated_warns_with_instructions():
    @utils.deprecated('Use g instead.')
    def f(x):
        return x + 1

    with pytest.warns(utils.DeprecatedWarning, match='f is deprecated. '
                                                     'Use g instead.'):
        assert f(1) == 2
    assert f.__name__ == 'f'


def test_model_replace_and_static_field():
    g = models.SphericalGaussian(mean=torch.zeros(2),
                                 covariance=torch.ones(()))
    h = g.replace(mean=torch.ones(2))
    assert torch.equal(h.mean, torch.ones(2)) and h.covariance is \
        g.covariance
    with pytest.raises(TypeError):
        g.replace(nonexistent=1)

    @base.modelclass
    class WithAxis(base.Model):
        value: torch.Tensor = None
        axis: tuple = base.static_field((-1,))

    field = {f.name: f for f in dataclasses.fields(WithAxis)}['axis']
    assert field.metadata['static'] and WithAxis().axis == (-1,)


@pytest.mark.parametrize('name', ['CACGMM', 'CWMM', 'CBMM', 'GMM', 'VMFMM',
                                  'ComplexAngularCentralGaussian',
                                  'ComplexCircularSymmetricGaussian',
                                  'Gaussian', 'VonMisesFisher', 'FCA',
                                  'GCACGMM', 'VMFCACGMM'])
def test_get_trainer_class_from_model_matches_jax(name):
    ours = base.get_trainer_class_from_model(getattr(models, name))
    theirs = jax_models.get_trainer_class_from_model(
        getattr(jax_models, name))
    assert ours.__name__ == theirs.__name__ == name + 'Trainer'
    assert ours is getattr(models, name + 'Trainer')
    with pytest.raises(AssertionError):
        base.get_trainer_class_from_model(ours)


def test_parameter_from_dict_by_name_and_class():
    d = {'mean': np.zeros(3), 'covariance': np.ones(())}
    by_name = base.parameter_from_dict('SphericalGaussian', d)
    by_class = base.parameter_from_dict(models.SphericalGaussian, d)
    assert isinstance(by_name, models.SphericalGaussian)
    assert torch.equal(by_name.mean, by_class.mean)
    assert isinstance(by_name.mean, torch.Tensor)


def test_stack_parameters_matches_jax():
    rng = np.random.default_rng(0)
    dicts = [{'weight': rng.random((2, 1)), 'cacg': {
        'covariance_eigenvectors': rng.random((2, 3, 3)) + 0j,
        'covariance_eigenvalues': rng.random((2, 3))}} for _ in range(4)]
    ours = base.stack_parameters(
        [models.CACGMM.from_dict(d) for d in dicts])
    theirs = jax_models.stack_parameters(
        [jax_models.CACGMM.from_dict(d) for d in dicts])
    assert ours.weight.shape == (4, 2, 1)
    assert_allclose(ours.cacg.covariance_eigenvectors.numpy(),
                    np.asarray(theirs.cacg.covariance_eigenvectors))
    assert_allclose(ours.weight.numpy(), np.asarray(theirs.weight))
    g = models.SphericalGaussian(mean=torch.zeros(2), covariance=1.0)
    with pytest.raises(AssertionError):
        base.stack_parameters([g, models.Gaussian(mean=torch.zeros(2),
                                                  covariance=torch.eye(2))])


@pytest.mark.parametrize('module', [utils, base])
def test_doctests(module):
    result = doctest.testmod(module)
    assert result.attempted > 0 and result.failed == 0, result
