"""Model base machinery: frozen dataclasses of tensors + serialization.

Same dict schema as ``pb_bss_tpu.models.base.Model`` (``to_dict`` /
``from_dict``), so a model fitted by either package loads in the other:
``from_dict`` accepts numpy arrays (e.g. a JAX model's ``to_dict()``
with its arrays converted by ``np.asarray``) and turns them into
tensors.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..ops.linalg import force_hermitian, unit_norm  # noqa: F401

__all__ = ['Model', 'modelclass', 'force_hermitian', 'unit_norm']


def _as_tensor(v):
    if isinstance(v, np.ndarray) or np.isscalar(v):
        return torch.as_tensor(np.array(v))  # a writable copy
    return v


class Model:
    """Mixin giving dataclass models dict (de)serialization. Use via
    the :func:`modelclass` decorator."""

    def to_dict(self):
        ret = {}
        for k in self.__dataclass_fields__:
            v = getattr(self, k)
            ret[k] = v.to_dict() if isinstance(v, Model) else v
        return ret

    @classmethod
    def from_dict(cls, d: dict):
        """Inverse of :meth:`to_dict`; numpy arrays become tensors."""
        assert cls.__dataclass_fields__.keys() == d.keys(), (
            cls.__dataclass_fields__.keys(), d.keys())
        kwargs = {}
        for k, v in d.items():
            target = _resolve_model_type(
                cls.__dataclass_fields__[k].type, cls)
            if target is not None and isinstance(v, dict):
                kwargs[k] = target.from_dict(v)
            else:
                kwargs[k] = _as_tensor(v)
        return cls(**kwargs)


def _resolve_model_type(field_type, owner_cls):
    """A dataclass field annotation as a Model subclass, or None
    (string annotations are looked up in the owner's module)."""
    if isinstance(field_type, str):
        module = sys.modules.get(owner_cls.__module__)
        field_type = getattr(module, field_type, None) if module else None
    if isinstance(field_type, type) and issubclass(field_type, Model):
        return field_type
    return None


def modelclass(cls):
    """Decorator: frozen dataclass + :class:`Model` mixin."""
    cls = dataclasses.dataclass(frozen=True, repr=True)(cls)
    if Model not in cls.__mro__:
        raise TypeError(f'{cls} must inherit from Model')
    return cls
