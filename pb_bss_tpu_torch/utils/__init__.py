"""Small helpers of the extraction layer (counterpart of part of
``pb_bss_tpu.utils``): the squared magnitude, one-hot labels and the
STFT bins' center frequencies."""
from __future__ import annotations

import numpy as np

__all__ = ['abs_square', 'labels_to_one_hot', 'get_stft_center_frequencies']


def abs_square(x):
    """Squared magnitude ``|x|^2`` without the sqrt of ``abs``, for real
    and complex tensors."""
    if x.is_complex():
        return x.real ** 2 + x.imag ** 2
    return x ** 2


def labels_to_one_hot(labels, categories: int, axis: int = 0,
                      keepdims=False, dtype=bool):
    """One-hot encode integer labels (numpy in, numpy out) along
    ``axis``; with ``keepdims`` the labels' ``axis`` (of size 1) becomes
    the category axis.

    >>> labels_to_one_hot([0, 1], categories=3)
    array([[ True, False],
           [False,  True],
           [False, False]])
    """
    labels = np.asarray(labels)
    if keepdims:
        assert labels.shape[axis] == 1
        result_ndim = labels.ndim
    else:
        result_ndim = labels.ndim + 1
    if axis < 0:
        axis += result_ndim
    onehot = (
        np.arange(categories).reshape((categories,) + (1,) * labels.ndim)
        == labels[None]
    ).astype(dtype)  # (categories, ...)
    if keepdims:
        onehot = onehot[(slice(None),) * (axis + 1) + (0,)]
    return np.moveaxis(onehot, 0, axis)


def get_stft_center_frequencies(size=1024, sample_rate=16000):
    """Center frequency in Hz of each STFT bin (numpy).

    >>> get_stft_center_frequencies(4, 16000)
    array([   0., 4000., 8000.])
    """
    return np.arange(0, size / 2 + 1) * sample_rate / size
