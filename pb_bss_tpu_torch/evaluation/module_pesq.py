"""PESQ (ITU-T P.862) wrapper.

Capability parity with ``pb_bss/evaluation/module_pesq.py``: PESQ is an
ITU standard implemented by the C library behind the ``pesq`` PyPI
package; this module adds batching over leading axes and the
mode-from-sample-rate convention on top of that optional dependency,
and raises a clear installation hint when the library is absent. The
port's own copy of ``pb_bss_tpu.evaluation.module_pesq``.

Note: the pesq C code does not release the GIL and is not thread
safe — keep calls single-threaded.
"""
from __future__ import annotations

import numpy as np

__all__ = ['pesq']

# Modes the underlying C library accepts per sample rate.  8 kHz audio
# only supports narrow-band; 16 kHz supports both and defaults to
# wide-band.
_MODES = {8000: ('nb',), 16000: ('wb', 'nb')}


def _scorer(sample_rate, mode):
    """Resolve (and validate) the mode, import the backend, and return
    a ``signal_pair -> MOS-LQO`` callable."""
    try:
        from pesq import pesq as pesq_fn
    except ImportError:
        raise AssertionError(
            'To use this pesq implementation, install pesq from\n'
            'https://github.com/ludlows/python-pesq\n'
            'or install it with `pip install pesq`'
        )

    if sample_rate not in _MODES:
        raise ValueError(sample_rate)
    if mode is None:
        mode = _MODES[sample_rate][0]
    assert mode in _MODES[sample_rate], (mode, sample_rate)

    return lambda ref, deg: pesq_fn(
        ref=ref, deg=deg, fs=sample_rate, mode=mode)


def pesq(reference, estimation, sample_rate, mode=None):
    """PESQ MOS-LQO, batched over leading axes on the host.

    Args:
        reference: clean signal, shape (..., num_samples).
        estimation: degraded signal, broadcastable to ``reference``.
        sample_rate: 8000 or 16000.
        mode: 'nb' / 'wb'; default derived from ``sample_rate``.

    Returns:
        Scalar for 1-D inputs, else an array of shape ``(...)``.
    """
    score = _scorer(sample_rate, mode)

    estimation, reference = np.broadcast_arrays(estimation, reference)
    assert reference.shape == estimation.shape, (
        reference.shape, estimation.shape)
    if reference.ndim == 0:
        raise NotImplementedError(reference.ndim)
    if reference.ndim == 1:
        return score(reference, estimation)

    batch_shape = reference.shape[:-1]
    # A "batch" axis of >= 30 entries is almost certainly a sample or
    # feature axis in the wrong position — refuse instead of grinding
    # through thousands of C-library calls.
    for axis, extent in enumerate(batch_shape):
        assert extent < 30, (axis, reference.shape, estimation.shape)

    flat_ref = reference.reshape((-1,) + reference.shape[-1:])
    flat_est = estimation.reshape((-1,) + estimation.shape[-1:])
    values = [score(r, e) for r, e in zip(flat_ref, flat_est)]
    return np.array(values).reshape(batch_shape)
