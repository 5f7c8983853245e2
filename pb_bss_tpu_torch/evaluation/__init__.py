from .module_si_sdr import (  # noqa: F401
    si_sdr,
    si_sdr_allow_float32,
    si_sdr_stft,
)
