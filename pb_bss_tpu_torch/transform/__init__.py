from .stft_module import istft, stft  # noqa: F401
