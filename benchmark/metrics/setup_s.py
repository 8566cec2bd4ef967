"""Seconds from the start of the process (before torch is imported)
to the end of the warm calls: CUDA initialisation, loading (in a first
run, building) the kernels, the inputs made from the seed and the warm
calls' eager warm-up and capture."""


def read(run):
    return run.setup_s
