"""The benchmark of pb_bss_tpu_torch on NVIDIA GPUs (``run.py``)."""
