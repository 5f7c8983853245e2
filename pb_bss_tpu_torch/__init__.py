"""pb_bss_tpu_torch: the PyTorch + CUDA port of pb_bss_tpu.

Multi-channel blind source separation on an NVIDIA Hopper GPU:
``separate`` / ``separate_batch`` run STFT -> cACGMM (or, with
``model='cwmm'``, complex Watson, with ``model='cbmm'``, complex
Bingham mixture) EM -> DHTV permutation alignment -> mask or GEV
beamformer extraction -> iSTFT, with the EM fit (whole-fit for short
recordings, streamed statistics plus batched Jacobi for long ones; the
Bingham moment inversion in a chord-solve kernel) and the GEV beamformer
in hand-written CUDA kernels (``ops/em_loop.py``, ``ops/em_stream.py``,
``ops/cwmm_loop.py``, ``ops/cbmm_loop.py``, ``ops/mm_stream.py``,
``ops/bingham.py``, ``ops/eigh.py``, ``ops/gev.py``). Imports torch,
never jax; the kernels are built on first use, not at import.
"""
from .models.cbmm import CBMM, CBMMTrainer  # noqa: F401
from .models.cwmm import CWMM, CWMMTrainer  # noqa: F401
from .pipeline import separate, separate_batch  # noqa: F401

__version__ = '0.1.0'
