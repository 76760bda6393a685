"""The benchmark of gymnasium_tpu_torch on one NVIDIA H100 (``run.py``)."""
