"""The 95th percentile of the host-clock time of every batch call of the
window, from the call until torch.cuda.synchronize() returns."""
from benchmark import arith


def read(run):
    return arith.percentile(run.calls_ms, 95)
