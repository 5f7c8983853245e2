"""Small-matrix linear algebra and the hand-written CUDA kernels
(``em_loop``: whole-fit cACGMM EM, ``em_stream``: streamed EM
statistics, ``em_step``: frequency-constant-weight EM steps,
``em_estep``: the opt-in E-step kernels, ``cwmm_loop``: whole-fit
complex Watson mixture EM, ``cbmm_loop``: whole-fit complex Bingham
mixture EM, ``mm_stream``: streamed Watson and Bingham statistics,
``bingham``: the Bingham moment inversion, ``integration_em``: the
integration models' per-iteration statistics, ``integration_em_loop``:
their whole fit, ``eigh``: batched Jacobi, ``gev``: fused GEV
beamformer). The kernels
are built on first use (``_build``), never at import."""
from . import linalg  # noqa: F401
