"""The median host-clock time of every solve call of the window."""
from benchmark import arith


def read(run):
    return arith.percentile(run.calls_ms, 50)
