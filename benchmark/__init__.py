"""The benchmark of admm_library_torch on one NVIDIA H100: `run.py` is
its command; `harness.py` one run of one cell."""
