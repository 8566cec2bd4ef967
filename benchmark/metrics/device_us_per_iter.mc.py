"""Device microseconds an iteration: the CUDA-event time of every graph
replay of the window (graph.CACHE.replay_events) over the calls'
lockstep iterations. Eager kernels outside graphs are not in it."""


def read(run):
    if not run.replay_ms or not sum(run.iters):
        return None
    return 1e3 * sum(run.replay_ms) / sum(run.iters)
