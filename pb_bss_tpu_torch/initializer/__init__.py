"""Affiliation initializers (counterpart of ``pb_bss_tpu.initializer``)."""
from . import iid  # noqa: F401
from . import deflation  # noqa: F401
from . import deterministic  # noqa: F401
