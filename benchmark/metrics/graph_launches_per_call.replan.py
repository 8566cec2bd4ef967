"""Graph launches a call: the program's replay count
(graph.CACHE.stats["replays"]) over each call, averaged."""


def read(run):
    if run.replays is None:
        return None
    return sum(run.replays) / len(run.replays)
