from .dummy_data import low_reverberation_data  # noqa: F401
