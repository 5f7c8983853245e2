"""Seeded random test-data generators (counterpart of
``pb_bss_tpu.testing.random_utils``).

Each generator draws its numbers with NumPy from the given seed or
``np.random.Generator``, in the JAX package's order, and returns the
draw as a tensor (``torch.from_numpy``): from the same seed both
packages give equal arrays, bit for bit. ``dtype`` is a NumPy dtype, as
in the JAX package, or the matching torch dtype.
"""
import numpy as np
import torch

__all__ = ['uniform', 'randn', 'hermitian', 'pos_def_hermitian']

_TORCH_TO_NUMPY = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.complex64: np.complex64,
    torch.complex128: np.complex128,
}


def _rng(seed_or_rng):
    if isinstance(seed_or_rng, np.random.Generator):
        return seed_or_rng
    return np.random.default_rng(seed_or_rng)


def _numpy_dtype(dtype):
    dtype = _TORCH_TO_NUMPY.get(dtype, dtype)
    for known in (np.float32, np.float64, np.complex64, np.complex128):
        if dtype is known:
            return known
    raise ValueError(f'unsupported dtype {dtype}')


def _shape(shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        return tuple(shape[0])
    return shape


def _uniform(shape, dtype, rng):
    def uniform_(data_type):
        return rng.uniform(-1, 1, shape).astype(data_type)

    if dtype in (np.float32, np.float64):
        return uniform_(dtype)
    if dtype is np.complex64:
        return uniform_(np.float32) + 1j * uniform_(np.float32)
    return uniform_(np.float64) + 1j * uniform_(np.float64)


def _randn(shape, dtype, rng):
    def normal(data_type):
        return np.sqrt(0.5) * rng.standard_normal(shape).astype(data_type)

    if dtype in (np.float32, np.float64):
        return rng.standard_normal(shape).astype(dtype)
    if dtype is np.complex64:
        return normal(np.float32) + 1j * normal(np.float32)
    return normal(np.float64) + 1j * normal(np.float64)


def _hermitian(shape, dtype, rng):
    assert shape[-1] == shape[-2], shape
    matrix = _randn(shape, dtype, rng)
    return (matrix + matrix.swapaxes(-1, -2).conj()) / 2


def uniform(shape=(1,), dtype=np.complex128, rng=None):
    """Uniform in [-1, 1) (real and imaginary parts drawn one after the
    other for complex dtypes)."""
    return torch.from_numpy(_uniform(shape, _numpy_dtype(dtype), _rng(rng)))


def randn(*shape, dtype=np.complex128, rng=None):
    """Standard normal; complex dtypes draw each part with variance 1/2."""
    return torch.from_numpy(
        _randn(_shape(shape), _numpy_dtype(dtype), _rng(rng)))


def hermitian(*shape, dtype=np.complex128, rng=None):
    """Random Hermitian matrices with shape (..., D, D)."""
    return torch.from_numpy(
        _hermitian(_shape(shape), _numpy_dtype(dtype), _rng(rng)))


def pos_def_hermitian(*shape, dtype=np.complex128, rng=None):
    """Random positive-definite Hermitian matrices (..., D, D)."""
    shape = _shape(shape)
    dtype = _numpy_dtype(dtype)
    matrix = _hermitian(shape, dtype, _rng(rng))
    matrix = matrix @ matrix.swapaxes(-1, -2).conj()
    matrix += shape[-1] * 2 * np.eye(shape[-1], dtype=dtype)
    return torch.from_numpy(matrix)
