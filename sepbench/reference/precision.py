"""The reference's arithmetic precisions.

``'float64'`` is the judge. ``'float32'`` is the precision the
configurations state. ``'tf32'`` is the control: float32 arithmetic
whose matrix products take their inputs rounded to TF32 (10 explicit
mantissa bits, round to nearest), as the H100's tensor cores do when
TF32 is allowed, and accumulate in float32. The rounding is done here,
so the control reads the same on the CPU and on the card.
"""
from __future__ import annotations

import torch

PRECISIONS = ('float64', 'float32', 'tf32')


def real_dtype(precision):
    if precision not in PRECISIONS:
        raise ValueError(f'precision must be one of {PRECISIONS}, got '
                         f'{precision!r}')
    return torch.float64 if precision == 'float64' else torch.float32


def complex_dtype(precision):
    return (torch.complex128 if real_dtype(precision) == torch.float64
            else torch.complex64)


def round_tf32(x):
    """float32 -> the nearest value with a 10-bit mantissa (ties away
    from zero), still stored as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm(a, b, precision):
    """Real ``a @ b`` in ``precision``; TF32 is never left to the
    library (its flags are off in the judge and the rounding is explicit
    in the control)."""
    dtype = real_dtype(precision)
    a, b = a.to(dtype), b.to(dtype)
    if precision == 'tf32':
        a, b = round_tf32(a), round_tf32(b)
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def eigh(a):
    """Hermitian eigendecomposition (ascending) in float64 whatever the
    working precision, cast back to it: the card's batched float32
    solver can stop unconverged on the ill-conditioned whitened pencils
    of the lowest bins. On the card a batch it refuses is solved again
    on the host."""
    try:
        values, vectors = torch.linalg.eigh(a.to(torch.complex128))
    except torch.linalg.LinAlgError:
        values, vectors = torch.linalg.eigh(a.to(torch.complex128).cpu())
    return (values.to(a.real.dtype).to(a.device),
            vectors.to(a.dtype).to(a.device))


def cmm(a, b, precision):
    """Complex ``a @ b`` as four real products."""
    if not a.is_complex():
        return torch.complex(mm(a, b.real, precision),
                             mm(a, b.imag, precision))
    if not b.is_complex():
        return torch.complex(mm(a.real, b, precision),
                             mm(a.imag, b, precision))
    re = mm(a.real, b.real, precision) - mm(a.imag, b.imag, precision)
    im = mm(a.real, b.imag, precision) + mm(a.imag, b.real, precision)
    return torch.complex(re, im)
