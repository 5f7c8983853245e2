from .dummy_data import (  # noqa: F401
    low_reverberation_data,
    reverberation_data,
)
