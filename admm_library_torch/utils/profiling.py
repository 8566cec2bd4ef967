"""Tracing and timing hooks on torch.profiler.

`trace` writes a Chrome / TensorBoard trace of the enclosed block;
`timed` and `phase_costs` time a call to its end on the device: a CUDA
call returns before the card has finished, so each timed run ends in
`torch.cuda.synchronize()`.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block, host and (where there is one) the
    card, and write the trace under `logdir` (`*.pt.trace.json`, which
    TensorBoard and chrome://tracing read). Yields the profiler.
    It cannot see the kernels inside CUDA-graph conditional bodies (a
    captured solve's phases): use `utils/trace` for those."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        try:
            yield prof
        finally:
            _sync()


def timed(fn, *args, warmup: int = 1, iters: int = 3, **kw):
    """(result, best_seconds): `warmup` untimed calls (kernel builds and
    first-use costs), then `iters` timed calls, each synchronised with
    the card; reports the minimum (steady-state) time."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kw)
        _sync()
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return out, best


def phase_costs(solve_fn, factor_fn, *args):
    """Split set-up (factor) and iteration cost of a solve."""
    _, t_factor = timed(factor_fn, *args)
    _, t_total = timed(solve_fn, *args)
    return {"factor_s": t_factor, "total_s": t_total,
            "iterate_s": max(t_total - t_factor, 0.0)}
