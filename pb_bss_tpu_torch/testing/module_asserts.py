"""Array assertions for tests (counterpart of
``pb_bss_tpu.testing.module_asserts``). Each takes tensors on any
device as well as arrays: tensors are copied to the host and checked
there with NumPy, as the JAX package checks its arrays."""
import numpy as np

from ..utils import to_numpy

__all__ = [
    'assert_hermitian',
    'assert_positive_semidefinite',
    'assert_array_greater',
    'assert_array_greater_equal',
    'assert_array_less',
    'assert_array_less_equal',
    'assert_array_not_equal',
    'assert_isreal',
]


def _compare(comparison, header, x, y, err_msg, verbose):
    np.testing.assert_array_compare(
        comparison, to_numpy(x), to_numpy(y), err_msg=err_msg,
        verbose=verbose, header=header)


def assert_hermitian(matrix, atol=1e-6):
    matrix = to_numpy(matrix)
    np.testing.assert_allclose(
        matrix, np.swapaxes(np.conj(matrix), -1, -2), atol=atol,
    )


def assert_positive_semidefinite(matrix, atol=1e-6):
    matrix = to_numpy(matrix)
    assert_hermitian(matrix, atol=atol)
    eigenvalues = np.linalg.eigvalsh(matrix)
    assert np.all(eigenvalues >= -atol), eigenvalues.min()


def assert_array_less(x, y, err_msg='', verbose=True):
    """numpy's ``assert_array_less``, which the JAX package re-exports,
    on tensors or arrays."""
    np.testing.assert_array_less(to_numpy(x), to_numpy(y), err_msg=err_msg,
                                 verbose=verbose)


def assert_array_greater_equal(x, y, err_msg='', verbose=True):
    _compare(np.greater_equal, 'Arrays are not greater-or-equal-ordered',
             x, y, err_msg, verbose)


def assert_array_less_equal(x, y, err_msg='', verbose=True):
    _compare(np.less_equal, 'Arrays are not less-or-equal-ordered',
             x, y, err_msg, verbose)


def assert_array_greater(x, y, err_msg='', verbose=True):
    _compare(np.greater, 'Arrays are not greater-ordered', x, y, err_msg,
             verbose)


def assert_isreal(actual, err_msg='', verbose=True):
    """Assert every element has zero imaginary part (``np.isreal``)."""
    np.testing.assert_equal(np.isreal(to_numpy(actual)), True, err_msg,
                            verbose)


def assert_array_not_equal(x, y, err_msg='', verbose=True):
    """Assert the arrays are NOT elementwise equal (a shape mismatch
    also raises)."""
    _compare(np.not_equal, 'Arrays are equal', x, y, err_msg, verbose)
