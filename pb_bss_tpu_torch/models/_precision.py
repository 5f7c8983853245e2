"""Matmul precision of the quality-critical EM einsums.

The JAX package pins the EM scatter, the E-step projection/quadratic
form and the PSD einsums to ``Precision.HIGHEST`` and lets an experiment
swap that pin (``set_em_matmul_precision``). The port's counterpart:
those einsums run inside :func:`full_fp32`, which sets PyTorch's float32
matmul precision to :func:`em_matmul_precision` for the duration of the
block and restores the caller's setting afterwards. The JAX names map
onto what the card has:

=====================  ===========================================
JAX name               PyTorch float32 matmul precision
=====================  ===========================================
``'highest'``          ``'highest'``: full fp32, no TF32 (default)
``'high'``             ``'high'``: cuBLAS may take TF32
``'default'``/``'bf16'``  ``'medium'``: cuBLAS may take bf16
=====================  ===========================================

The default is ``'highest'``, which is what :func:`full_fp32` always
pinned. The hand-written CUDA kernels compute in fp32 whatever is set:
the knob reaches only the PyTorch einsums (the plain paths, the
streaming E-step and scatter, the beamformer PSDs). No global flag is
changed at import.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ['full_fp32', 'em_matmul_precision', 'set_em_matmul_precision']

_ALIASES = {
    'highest': 'highest',
    'high': 'high',
    'default': 'medium',
    'bf16': 'medium',
    'medium': 'medium',
}

_em_precision = 'highest'


def em_matmul_precision():
    """PyTorch's name (``'highest'``, ``'high'`` or ``'medium'``) of the
    precision the EM einsums run at."""
    return _em_precision


def set_em_matmul_precision(precision):
    """Set the EM einsum precision: ``'highest'``, ``'high'``,
    ``'default'`` or ``'bf16'`` (the JAX package's names; PyTorch's
    ``'medium'`` is taken too). Returns the previous value, as PyTorch
    names it. An unknown name raises ``ValueError``."""
    global _em_precision
    key = precision.lower() if isinstance(precision, str) else precision
    if key not in _ALIASES:
        raise ValueError(
            f'unknown EM matmul precision {precision!r}; expected one of '
            f'{sorted(_ALIASES)}')
    previous = _em_precision
    _em_precision = _ALIASES[key]
    return previous


@contextlib.contextmanager
def full_fp32():
    """Run the enclosed matrix products at :func:`em_matmul_precision`
    (full fp32, no TF32, by default)."""
    previous = torch.get_float32_matmul_precision()
    target = _em_precision
    if previous != target:
        torch.set_float32_matmul_precision(target)
    try:
        yield
    finally:
        if previous != target:
            torch.set_float32_matmul_precision(previous)
