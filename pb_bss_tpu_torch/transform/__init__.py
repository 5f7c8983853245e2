"""Transforms: STFT/iSTFT frontend, phase reconstruction, gammatone
(the exports of ``pb_bss_tpu.transform``)."""
from . import stft_module  # noqa: F401
from .stft_module import stft, istft, STFT  # noqa: F401
from .griffin_lim_module import GriffinLim, MISI  # noqa: F401
from . import gammatone  # noqa: F401
from .gammatone import gammatone_filterbank  # noqa: F401
from . import filters  # noqa: F401
