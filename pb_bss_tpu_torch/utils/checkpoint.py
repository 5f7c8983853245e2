"""Model checkpointing (counterpart of ``pb_bss_tpu.utils.checkpoint``).

A model's ``to_dict()`` is flattened to ``'a/b/c'`` keys of numpy
arrays and written with ``np.savez``: the JAX package's ``.npz`` layout,
so a file written by either package loads in the other
(:func:`save_model_npz` / :func:`load_model_npz`).

:func:`save_model` / :func:`load_model` keep the JAX package's
directory-checkpoint names. The JAX package writes that directory with
orbax, which needs JAX; here the directory holds the same flat arrays as
``model.npz``, so the two directory layouts do not interchange (the
``.npz`` files do).
"""
from __future__ import annotations

import pathlib

import numpy as np

from . import to_numpy

__all__ = ['save_model', 'load_model', 'save_model_npz',
           'load_model_npz']

_DIRECTORY_FILE = 'model.npz'


def _flatten_dict(d, prefix=''):
    """Nested dict -> {'a/b': numpy array}; tensors are copied to the
    host."""
    out = {}
    for k, v in d.items():
        key = f'{prefix}{k}'
        if isinstance(v, dict):
            out.update(_flatten_dict(v, key + '/'))
        else:
            out[key] = to_numpy(v)
    return out


def _unflatten_dict(flat):
    """Inverse of :func:`_flatten_dict` (the arrays stay numpy)."""
    out = {}
    for key, v in flat.items():
        parts = key.split('/')
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def save_model_npz(path, model):
    """Single-file ``.npz`` checkpoint of ``model.to_dict()``."""
    np.savez(path, **_flatten_dict(model.to_dict()))
    return path


def load_model_npz(path, model_class):
    """Load a model saved by :func:`save_model_npz` (by either package).

    Args:
        path: the ``.npz`` file.
        model_class: the model dataclass, or its name in
            ``pb_bss_tpu_torch.models``.
    """
    from ..models.base import parameter_from_dict
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return parameter_from_dict(model_class, _unflatten_dict(flat))


def save_model(path, model):
    """Directory checkpoint: ``path/model.npz`` (see the module
    docstring). Returns the absolute directory."""
    path = pathlib.Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    save_model_npz(path / _DIRECTORY_FILE, model)
    return path


def load_model(path, model_class):
    """Load a model saved by :func:`save_model`."""
    path = pathlib.Path(path).absolute()
    return load_model_npz(path / _DIRECTORY_FILE, model_class)
