"""Small-matrix linear algebra and the hand-written CUDA kernels
(``em_loop``: whole-fit cACGMM EM, ``gev``: fused GEV beamformer). The
kernels are built on first use (``_build``), never at import."""
from . import linalg  # noqa: F401
