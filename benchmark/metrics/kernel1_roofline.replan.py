"""Kernel 1's share of its roofline: the bound (the larger of its
operations over 67 TFLOP/s and its bytes over 3.35 TB/s, both counted
from the shapes by arith.fused_work) over the CUDA-event time of one
k-block at the arguments of a launch of the cell's own solve. Silent
where the window launched no kernel 1."""


def read(run):
    if run.kernel1 is None:
        return None
    return 100.0 * run.kernel1["bound_ms"] / run.kernel1["ms"]
