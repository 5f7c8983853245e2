"""Array utilities (counterpart of ``pb_bss_tpu.utils``): the squared
magnitude, one-hot labels, the STFT bins' center frequencies, the
device-to-host copy, singleton insertion, the broadcast check, the
einops-like ``reshape``, the dominant eigenvector and the deprecation
decorator. The JAX package's ``run_on_device`` works around a TPU
transfer restriction that a CUDA device does not have and is not
ported."""
from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from ..ops.linalg import get_pca  # noqa: F401

__all__ = [
    'abs_square',
    'unsqueeze',
    'is_broadcast_compatible',
    'labels_to_one_hot',
    'get_stft_center_frequencies',
    'reshape',
    'get_pca',
    'to_numpy',
    'DeprecatedWarning',
    'deprecated',
]


def to_numpy(x):
    """A host numpy copy of a tensor on any device (complex included),
    or of anything ``np.asarray`` takes.

    >>> to_numpy(torch.tensor([1 + 2j], dtype=torch.complex64))
    array([1.+2.j], dtype=complex64)
    """
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().resolve_neg().cpu().numpy()
    return np.asarray(x)


def abs_square(x):
    """Squared magnitude ``|x|^2`` without the sqrt of ``abs``, for real
    and complex tensors."""
    if x.is_complex():
        return x.real ** 2 + x.imag ** 2
    return x ** 2


def unsqueeze(array, axis):
    """Insert singleton dimensions at the (possibly negative) positions.

    >>> tuple(unsqueeze(torch.ones((2, 3)), (-3, -1)).shape)
    (2, 1, 3, 1)
    >>> tuple(unsqueeze(13, (-2, -1)).shape)
    (1, 1)
    """
    array = torch.as_tensor(array)
    shape = list(array.shape)
    future_ndim = len(shape) + len(axis)
    for p in sorted(a % future_ndim for a in axis):
        shape.insert(p, 1)
    return array.reshape(shape)


def is_broadcast_compatible(*shapes):
    """True when all shapes can be broadcast against each other.

    >>> is_broadcast_compatible((5, 1, 6), (5, 3, 6))
    True
    >>> is_broadcast_compatible((5, 2, 6), (5, 3, 6))
    False
    """
    if len(shapes) < 2:
        return True
    for dim in zip(*[shape[::-1] for shape in shapes]):
        if len(set(dim).union({1})) > 2:
            return False
    return True


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


def _tokens(side):
    side = side.replace(',', ' ').replace('*', ' * ')
    return side.replace('(', ' ( ').replace(')', ' ) ').split()


def _rhs_groups(rhs):
    """The output axes as groups of names: ``(a b)`` and ``a*b`` join
    names into one flattened axis."""
    groups = []
    group = None
    join_next = False
    for t in _tokens(rhs):
        if t == '(':
            group = []
        elif t == ')':
            groups.append(group)
            group = None
        elif t == '*':
            join_next = True
        elif group is not None:
            group.append(t)
        elif join_next:
            groups[-1].append(t)
            join_next = False
        else:
            groups.append([t])
    return groups


def reshape(array, operation):
    """einops-like reshape/transpose: ``'f t d -> d (f t)'``.

    Transposes, squeezes literal ``1`` input axes, inserts literal ``1``
    output axes and flattens output groups written as ``(a b)`` or
    ``a*b``. Unflattening is not supported: the sizes are not known
    here.

    >>> tuple(reshape(torch.zeros((2, 3, 4)), 'f t d -> d (f t)').shape)
    (4, 6)
    >>> tuple(reshape(torch.zeros((2, 3, 4)), 'f t d -> d t f').shape)
    (4, 3, 2)
    """
    lhs, rhs = operation.split('->')
    lhs_tokens = _tokens(lhs)
    if any(t in lhs_tokens for t in ('*', '(')):
        raise NotImplementedError(
            'Unflatten operation not supported by design. '
            'Actual values for dimensions are not available to this '
            'function.')
    array = torch.as_tensor(array)
    squeeze_axes = [i for i, t in enumerate(lhs_tokens) if t == '1']
    for ax in reversed(squeeze_axes):
        array = array.squeeze(ax)
    lhs_names = [t for t in lhs_tokens if t != '1']

    groups = _rhs_groups(rhs)
    flat_rhs = [n for g in groups for n in g if n != '1']
    array = array.permute([lhs_names.index(n) for n in flat_rhs])

    out_shape = []
    i = 0
    for g in groups:
        if g == ['1']:
            out_shape.append(1)
            continue
        size = 1
        for n in g:
            if n == '1':
                continue
            size *= array.shape[i]
            i += 1
        out_shape.append(size)
    return array.reshape(out_shape)


class DeprecatedWarning(UserWarning):
    """Category emitted by :func:`deprecated`."""


def deprecated(instructions):
    """Decorator marking a callable as deprecated: every call emits a
    :class:`DeprecatedWarning` naming the callable and the
    ``instructions`` for migrating away from it."""
    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            warnings.warn(
                f'{fn.__qualname__} is deprecated. {instructions}',
                category=DeprecatedWarning, stacklevel=2)
            return fn(*args, **kwargs)
        return wrapper
    return decorator
