"""Evaluation layer: the exports of ``pb_bss_tpu.evaluation`` plus the
port's ``si_sdr_allow_float32`` / ``si_sdr_stft``. The device programs
and the facades run on the card unless the caller names the CPU; the
host float64 oracles are the port's own NumPy / SciPy copies."""
from .module_mir_eval import mir_eval_sources  # noqa: F401
from .module_bss_eval import bss_eval_sources  # noqa: F401
from .module_bss_eval_device import (  # noqa: F401
    bss_eval_sources_batch,
    bss_eval_sources_device,
    mir_eval_sources_batch,
)
from .module_stoi_device import stoi_batch, stoi_device  # noqa: F401
from .module_pesq import pesq  # noqa: F401
from .module_srmr import srmr  # noqa: F401
from .module_srmr_device import srmr_batch, srmr_device  # noqa: F401
from .module_stoi import stoi  # noqa: F401
from .module_si_sdr import (  # noqa: F401
    si_sdr,
    si_sdr_allow_float32,
    si_sdr_stft,
)
from .sxr_module import input_sxr, output_sxr, get_snr  # noqa: F401
from .wrapper import InputMetrics, OutputMetrics  # noqa: F401
from .batch_wrapper import (  # noqa: F401
    InputMetricsBatch,
    OutputMetricsBatch,
)
