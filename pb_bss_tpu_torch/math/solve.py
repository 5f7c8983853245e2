"""Namespace alias of the stable solver (counterpart of
``pb_bss_tpu.math.solve``); the implementation is
:mod:`pb_bss_tpu_torch.ops.linalg`."""
from ..ops.linalg import solve_pinv, stable_solve  # noqa: F401

__all__ = ['stable_solve', 'solve_pinv']
