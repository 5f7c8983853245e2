"""pb_bss_tpu_torch.testing.random_utils and .module_asserts against the
JAX package's: the generators draw the same numbers bit for bit from the
same seed, and each assert passes and fails where the JAX one does, on
tensors as on arrays."""
import numpy as np
import pytest
import torch

from pb_bss_tpu.testing import module_asserts as jax_asserts
from pb_bss_tpu.testing import random_utils as jax_random
from pb_bss_tpu_torch.testing import module_asserts, random_utils

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
TORCH_DTYPES = {np.float32: torch.float32, np.float64: torch.float64,
                np.complex64: torch.complex64,
                np.complex128: torch.complex128}


def _equal(ours, theirs):
    assert isinstance(ours, torch.Tensor)
    assert ours.dtype == TORCH_DTYPES[theirs.dtype.type]
    np.testing.assert_array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', ['randn', 'hermitian', 'pos_def_hermitian'])
@pytest.mark.parametrize('form', ['args', 'tuple', 'list'])
def test_generators_bit_for_bit(name, dtype, form):
    shape = (2, 3, 3)
    args = {'args': shape, 'tuple': (shape,), 'list': (list(shape),)}[form]
    ours = getattr(random_utils, name)(*args, dtype=dtype, rng=7)
    theirs = getattr(jax_random, name)(*args, dtype=dtype, rng=7)
    _equal(ours, theirs)


@pytest.mark.parametrize('dtype', DTYPES)
def test_uniform_bit_for_bit(dtype):
    _equal(random_utils.uniform((4, 5), dtype=dtype, rng=3),
           jax_random.uniform((4, 5), dtype=dtype, rng=3))


def test_generators_share_a_generator_in_order():
    """One numpy Generator threads through successive draws in the same
    order in both packages; torch dtypes name the same draws."""
    ours_rng, jax_rng = np.random.default_rng(11), np.random.default_rng(11)
    for name, args in (('uniform', ((3,),)), ('randn', (2, 2)),
                       ('pos_def_hermitian', (4, 4))):
        ours = getattr(random_utils, name)(*args, rng=ours_rng)
        theirs = getattr(jax_random, name)(*args, rng=jax_rng)
        _equal(ours, theirs)
    _equal(random_utils.randn(5, dtype=torch.complex64, rng=2),
           jax_random.randn(5, dtype=np.complex64, rng=2))


def test_generators_refuse_unknown_dtypes():
    for module in (random_utils, jax_random):
        with pytest.raises(ValueError, match='unsupported dtype'):
            module.randn(3, dtype=np.int32, rng=0)
    with pytest.raises(AssertionError):
        random_utils.hermitian(2, 3, rng=0)


def _hermitian():
    return jax_random.hermitian(3, 3, rng=1)


def _pos_def():
    return jax_random.pos_def_hermitian(3, 3, rng=1)


# (assert, x, y or None): each case passes for some inputs and fails for
# others in the JAX package
CASES = [
    ('assert_hermitian', _hermitian, None),
    ('assert_hermitian', lambda: jax_random.randn(3, 3, rng=2), None),
    ('assert_positive_semidefinite', _pos_def, None),
    ('assert_positive_semidefinite', lambda: -_pos_def(), None),
    ('assert_array_greater', lambda: np.array([2., 3.]),
     lambda: np.array([1., 2.])),
    ('assert_array_greater', lambda: np.array([2., 2.]),
     lambda: np.array([1., 2.])),
    ('assert_array_greater_equal', lambda: np.array([2., 2.]),
     lambda: np.array([1., 2.])),
    ('assert_array_greater_equal', lambda: np.array([0., 2.]),
     lambda: np.array([1., 2.])),
    ('assert_array_less', lambda: np.array([1., 2.]),
     lambda: np.array([2., 3.])),
    ('assert_array_less', lambda: np.array([1., 3.]),
     lambda: np.array([2., 3.])),
    ('assert_array_less_equal', lambda: np.array([1., 3.]),
     lambda: np.array([2., 3.])),
    ('assert_array_less_equal', lambda: np.array([4., 3.]),
     lambda: np.array([2., 3.])),
    ('assert_array_not_equal', lambda: np.array([1., 2.]),
     lambda: np.array([2., 3.])),
    ('assert_array_not_equal', lambda: np.array([1., 2.]),
     lambda: np.array([1., 3.])),
    ('assert_array_not_equal', lambda: np.array([1., 2.]),
     lambda: np.array([1., 2., 3.])),
    ('assert_isreal', lambda: np.array([1. + 0j, 2.]), None),
    ('assert_isreal', lambda: np.array([1. + 1e-9j, 2.]), None),
]


def _outcome(function, *args):
    try:
        function(*args)
    except AssertionError:
        return 'fails'
    return 'passes'


@pytest.mark.parametrize('name,x,y', CASES)
@pytest.mark.parametrize('kind', ['array', 'tensor'])
def test_asserts_agree_with_jax(name, x, y, kind):
    args = [x()] if y is None else [x(), y()]
    expected = _outcome(getattr(jax_asserts, name), *args)
    if kind == 'tensor':
        args = [torch.from_numpy(np.asarray(a)) for a in args]
    assert _outcome(getattr(module_asserts, name), *args) == expected


def test_every_assert_is_exported():
    assert sorted(module_asserts.__all__) == sorted(jax_asserts.__all__)
    assert sorted(random_utils.__all__) == sorted(jax_random.__all__)
