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
are built on first use (``_build``), never at import.

The package re-exports the JAX package's ``ops`` names from
:mod:`.linalg`, but for ``eigh``: ``ops.eigh`` is the Jacobi kernel's
module, the function is ``ops.linalg.eigh``."""
from . import linalg  # noqa: F401
from .linalg import (  # noqa: F401
    condition_hermitian,
    eigh_jacobi,
    force_hermitian,
    get_pca,
    gev_max_eigvec,
    solve_pinv,
    stable_solve,
    unit_norm,
)
