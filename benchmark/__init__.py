"""The benchmark of sdfkit_tpu_torch on an NVIDIA H100 (``run.py``)."""
