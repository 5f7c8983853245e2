"""IIR filtering primitives in torch ops.

Counterpart of ``pb_bss_tpu.transform.filters``. A second-order IIR
section is the affine linear recurrence ``s[n] = A s[n-1] + c[n]`` on a
2-vector state with a time-invariant ``A``, so the state at ``t`` is
``sum_k A^k c[t-k]``. PyTorch has no associative scan; the recurrence
runs as a log-depth doubling scan instead: ``ceil(log2 T)`` steps, step
``s`` adding ``A^(2^s) state[t - 2^s]`` to every ``state[t]`` and
squaring the power. Each step is a handful of elementwise ops over the
whole signal, so a 16,000-sample signal takes 14 steps, not 16,000.

Like the JAX package's scan, this route is f32-safe for the gammatone
cascade and not for near-DC band-passes whose pole sections amplify
coefficient rounding (``evaluation/module_srmr_device.py``): those run
as FFT convolutions against float64-designed impulse responses.
"""
from __future__ import annotations

import torch

__all__ = ['biquad_filter', 'lfilter_sos']


def _coefficient(v, x):
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def biquad_filter(x, b, a):
    """Apply one second-order IIR section along the last axis.

    Equivalent to ``scipy.signal.lfilter(b, a, x)`` with
    ``b = (b0, b1, b2)``, ``a = (a0, a1, a2)`` (normalized by ``a0``),
    in transposed direct form II.

    Args:
        x: (..., T) real tensor.
        b: 3 feedforward coefficients (scalars or tensors broadcastable
            against x's batch dims).
        a: 3 feedback coefficients.
    Returns:
        (..., T) filtered signal.
    """
    x = torch.as_tensor(x)
    b0, b1, b2 = (_coefficient(v, x) for v in b)
    a0, a1, a2 = (_coefficient(v, x) for v in a)
    b0, b1, b2 = b0 / a0, b1 / a0, b2 / a0
    a1, a2 = a1 / a0, a2 / a0

    # state s = (s1, s2): y[n] = s1[n-1] + b0 x[n]
    # s1[n] = -a1 s1[n-1] + s2[n-1] + (b1 - a1 b0) x[n]
    # s2[n] = -a2 s1[n-1]           + (b2 - a2 b0) x[n]
    s1 = (b1 - a1 * b0)[..., None] * x
    s2 = (b2 - a2 * b0)[..., None] * x
    s1, s2 = torch.broadcast_tensors(s1, s2)
    # P = A^d, with A = [[-a1, 1], [-a2, 0]], per batch entry
    p11, p12 = -a1, torch.ones_like(a1)
    p21, p22 = -a2, torch.zeros_like(a2)
    T = x.shape[-1]
    d = 1
    while d < T:
        q11, q12, q21, q22 = (p[..., None] for p in (p11, p12, p21, p22))
        prev1, prev2 = s1[..., :-d], s2[..., :-d]
        s1 = torch.cat([s1[..., :d],
                        s1[..., d:] + q11 * prev1 + q12 * prev2], -1)
        s2 = torch.cat([s2[..., :d],
                        s2[..., d:] + q21 * prev1 + q22 * prev2], -1)
        p11, p12, p21, p22 = (p11 * p11 + p12 * p21,
                              p11 * p12 + p12 * p22,
                              p21 * p11 + p22 * p21,
                              p21 * p12 + p22 * p22)
        d *= 2
    s1_prev = torch.nn.functional.pad(s1[..., :-1], (1, 0))
    return s1_prev + b0[..., None] * x


def lfilter_sos(x, sections):
    """Cascade of biquad sections: ``sections`` is a sequence of
    (b_coeffs, a_coeffs) tuples applied in order."""
    for b, a in sections:
        x = biquad_filter(x, b, a)
    return x
