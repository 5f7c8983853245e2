"""Deterministic affiliation initializers (counterpart of
``pb_bss_tpu.initializer.deterministic``): the ``flag`` time-segment
one-hot initializer with ``minimum`` flooring."""
from __future__ import annotations

import numpy as np
import torch

from .._dtypes import real_dtype as _real_dtype

__all__ = ['flag']


def flag(Y, num_classes: int, permutation_free: bool = False,
         minimum: float = 0):
    """Split the time axis into ``num_classes`` segments, assigning each
    segment fully to one class; ``minimum`` floors the inactive classes
    to avoid exact zeros.

    Args:
        Y: (..., N, D) observations (only the shape, dtype and device
            are used).
    Returns:
        (..., K, N) affiliations on Y's device.
    """
    if not permutation_free:
        raise NotImplementedError(permutation_free)

    Y = torch.as_tensor(Y)
    *ind, N, D = Y.shape

    labels = torch.from_numpy(
        np.linspace(0, num_classes, N, dtype=int, endpoint=False)).to(
            Y.device)
    eye = torch.eye(num_classes, dtype=_real_dtype(Y), device=Y.device)
    init = torch.broadcast_to(eye[labels].T, (*ind, num_classes, N))
    if minimum != 0:
        assert 0 < minimum < (1 / num_classes), (minimum, num_classes)
        init = torch.clamp(
            init, min=minimum / (1 - (num_classes - 1) * minimum))
        init = init / torch.sum(init, dim=-2, keepdim=True)
    return init
