"""Dtype helpers: the real counterpart of a complex dtype and its
``tiny`` (works for tensors and dtypes alike)."""
from __future__ import annotations

import torch

__all__ = ['real_dtype', 'tiny']

_REAL_OF = {
    torch.complex64: torch.float32,
    torch.complex128: torch.float64,
}


def real_dtype(x):
    """Real counterpart of a tensor's/dtype's dtype."""
    dtype = x.dtype if isinstance(x, torch.Tensor) else x
    return _REAL_OF.get(dtype, dtype)


def tiny(x):
    """``finfo.tiny`` of the real counterpart dtype."""
    return torch.finfo(real_dtype(x)).tiny
