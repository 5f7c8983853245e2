from . import random_utils  # noqa: F401
from . import module_asserts  # noqa: F401
from .dummy_data import (  # noqa: F401
    low_reverberation_data,
    real_audio_data,
    real_test_data_root,
    reverberation_data,
)
