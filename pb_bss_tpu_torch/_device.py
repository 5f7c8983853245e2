"""Device and dtype rules of the port's transforms and metrics.

Their entry points take an explicit ``device=`` ('cuda' by default):
a CUDA device without CUDA raises, it never drops to the CPU. They
compute in float64 when every input is float64 and in float32 otherwise
(the card's precision; float64 on the CPU is the tests' oracle mode)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ['resolve_device', 'real_float', 'as_real_tensor']


def resolve_device(device):
    """``torch.device(device)``; raises when it names CUDA and there is
    none (``device='cpu'`` asks for the CPU)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "this call runs on the card (device='cuda') and CUDA is not "
            "available here; pass device='cpu' to run on the CPU.")
    return device


def _is_float64(x):
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.float64
    return np.asarray(x).dtype == np.float64


def real_float(*arrays):
    """float64 when every input is float64, else float32."""
    return (torch.float64 if all(_is_float64(x) for x in arrays)
            else torch.float32)


def as_real_tensor(x, device=None, dtype=None):
    """``x`` (tensor, array or sequence) as a real tensor on ``device``
    (its own device if None) at ``dtype`` (float64 stays float64,
    anything else becomes float32, if None)."""
    if dtype is None:
        dtype = real_float(x)
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=dtype)
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                           device=device)
