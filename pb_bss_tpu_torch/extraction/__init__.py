"""Extraction layer: T-F masks, PSD estimation, beamformers, geometry
(counterpart of ``pb_bss_tpu.extraction``)."""
from . import mask_module  # noqa: F401
from .mask_module import *  # noqa: F401,F403
from . import beamformer  # noqa: F401
from .beamformer import *  # noqa: F401,F403
from .beamformer import phase_correction  # noqa: F401
from . import beamformer_wrapper  # noqa: F401
from .beamformer_wrapper import get_bf_vector  # noqa: F401
from .beamformer_wrapper import (  # noqa: F401
    get_bf_vector as get_single_source_bf_vector,
)
from . import beamform_utils  # noqa: F401
