"""Affiliation initializers (counterpart of ``pb_bss_tpu.initializer``;
the deflation and deterministic initializers are not ported yet)."""
from . import iid  # noqa: F401
