"""pb_bss_tpu_torch: the PyTorch + CUDA port of pb_bss_tpu.

Multi-channel blind source separation on an NVIDIA Hopper GPU:
``separate`` / ``separate_batch`` run STFT -> cACGMM (or, with
``model='cwmm'``, complex Watson, with ``model='cbmm'``, complex
Bingham mixture) EM -> DHTV permutation alignment -> mask or GEV
beamformer extraction -> iSTFT (``mesh=`` splits the batch and the
frequency bins over the ranks of a ``torch.distributed`` mesh,
``parallel``), with the EM fit (whole-fit for short
recordings, streamed statistics plus batched Jacobi for long ones; the
Bingham moment inversion in a chord-solve kernel) and the GEV beamformer
in hand-written CUDA kernels (``ops/em_loop.py``, ``ops/em_stream.py``,
``ops/cwmm_loop.py``, ``ops/cbmm_loop.py``, ``ops/mm_stream.py``,
``ops/bingham.py``, ``ops/eigh.py``, ``ops/gev.py``).
``StreamingSeparator`` is the serving form: fixed-size chunks of
multichannel audio in, separated samples out with a fixed latency, on
the block-online cACGMM (its warm-up fit on the whole-fit kernel, each
block's M-step on the Jacobi kernel). Imports torch, never jax; the
kernels are built on first use, not at import.

``pb_bss_tpu_torch.distribution`` (and ``.distribution.utils``) are
aliases of ``models`` (and ``models.base``), as in the JAX package.
"""
import sys as _sys

from . import utils  # noqa: F401
from . import parallel  # noqa: F401
from . import pipeline  # noqa: F401
from .pipeline import separate, separate_batch  # noqa: F401
from . import streaming  # noqa: F401
from .streaming import StreamingSeparator  # noqa: F401
from . import math  # noqa: F401
from . import ops  # noqa: F401
from . import initializer  # noqa: F401
from . import permutation_alignment  # noqa: F401
from .permutation_alignment import (  # noqa: F401
    DHTVPermutationAlignment,
    GreedyPermutationAlignment,
    OraclePermutationAlignment,
)
from . import extraction  # noqa: F401
from . import evaluation  # noqa: F401
from . import transform  # noqa: F401
from .models.cbmm import CBMM, CBMMTrainer  # noqa: F401
from .models.cwmm import CWMM, CWMMTrainer  # noqa: F401

from . import models  # noqa: F401
_sys.modules[__name__ + '.distribution'] = models
# ``from pb_bss_tpu_torch.distribution.utils import ...`` needs the dotted
# submodule path registered too
_sys.modules[__name__ + '.distribution.utils'] = models.base
distribution = models

__version__ = '0.1.0'
