"""Iterations a call, averaged over the window's calls: a call's
Solution.iters, its largest lane (the lockstep count) for a batch."""


def read(run):
    return sum(run.iters) / len(run.iters) if run.iters else None
