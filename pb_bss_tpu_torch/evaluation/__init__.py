from .module_si_sdr import si_sdr, si_sdr_stft  # noqa: F401
