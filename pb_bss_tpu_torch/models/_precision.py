"""Full-fp32 matmul pin for the quality-critical einsums.

The JAX package pins the EM scatter, the E-step projection/quadratic
form and the PSD einsums to ``Precision.HIGHEST``. The port's
counterpart: those einsums run inside :func:`full_fp32`, which turns
TF32 off for cuBLAS matrix products (float32 and complex64) for the
duration of the block and restores the caller's setting afterwards.
PyTorch's own default is already full fp32; the pin keeps it so when a
caller has enabled TF32 globally. No global flag is changed at import.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ['full_fp32']


@contextlib.contextmanager
def full_fp32():
    """Run the enclosed matrix products in full fp32 (no TF32)."""
    matmul = torch.backends.cuda.matmul
    previous = matmul.allow_tf32
    if previous:
        matmul.allow_tf32 = False
    try:
        yield
    finally:
        if previous:
            matmul.allow_tf32 = previous
