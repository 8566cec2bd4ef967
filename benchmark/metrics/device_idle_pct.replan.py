"""The share of the window in which no graph replay ran on the card:
1 - (CUDA-event time of the replays) / (window's wall time). Eager
kernels outside graphs count as idle, gaps inside a replay as busy."""


def read(run):
    if not run.replay_ms:
        return None
    return 100.0 * (1.0 - sum(run.replay_ms) / 1e3 / run.window_s)
