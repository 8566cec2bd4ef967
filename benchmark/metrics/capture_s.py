"""Seconds of the set-up spent capturing CUDA graphs
(graph.CACHE.stats["capture_ms"] over the warm calls). Silent where
nothing was captured."""


def read(run):
    return run.capture_ms / 1e3 if run.captures else None
