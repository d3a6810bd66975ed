"""The benchmark of portfft_tpu_torch on an NVIDIA H100 (``run.py``)."""
