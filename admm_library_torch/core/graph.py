"""Captured residual checks: the port's counterpart of the JAX package's
`jax.jit`-compiled phases.

The JAX package runs a whole phase as one XLA program, a
`lax.while_loop` whose body runs `check_every` iterations and the
residual check. Here the host loop of `core.admm.run_admm`,
`run_admm_lanes`, `parallel.batch.run_admm_batch_shared` and of the
partitioned drivers (`parallel.consensus.run_consensus`,
`consensus_mc.run_consensus_mc`, `horizon._run_horizon`) stays, and on
the card each of its checks is one CUDA graph replay. The host still
reads one small flag tensor a check. `parallel.rowshard.
solve_rowsharded` replays a few graphs an iteration instead: its CG
stops on a flag the host reads every ops/kkt._CG_CHECK steps.

A check is `step(state, variant) -> updates`: `state` is a dict of
tensors (one level of nested dicts allowed: the problem data, the
scaling, the KKT factor), `updates` the top-level entries the check
changes, and `variant` the check's static part, the restart boundary
and the rho test (`(restart, rho_test)`), which selects one of up to
four graphs. A variant may also name a segment of a check that the host
sequences, with host reads between segments: `parallel.rowshard`'s loop
runs ("cg", steps) blocks of its CG, ("tail",) iteration ends and
("check", restart, rho_test) checks, one graph each. A loop's static
arguments enter the key as plain hashable values (a mesh by its shape
and coordinates, never by identity). A step makes no host read and
keeps no host counter: what it counts lives in the state.

`CheckLoop` runs a loop's checks. Where `capturable` says no (CPU
tensors, an eager-only backend, a mesh axis of size > 1) it applies
each step's updates to a plain dict, the plain version of this module.
Where it says yes, the state lives in static buffers owned by an entry
of a `CheckCache`, keyed by `check_key`; a later loop with the same key
copies its data and starting carry into them. The first check of each
variant runs eagerly on the cache's side stream (the warm-up that
capture needs: cuBLAS handles and workspaces), the next one of that
variant is captured there, and every later one replays. No check runs
twice. A failure to capture or replay raises.
"""
from __future__ import annotations

import collections
import time

import torch

# Backends whose check has no host read: one product ('inv'), two
# triangular solves ('chol'), or block sweeps whose trip counts are
# static shapes ('banded': two sweeps over the N blocks; 'spike': batched
# interior products and a sweep over the separator blocks; a check of
# config 2 on 'banded' is a graph of ~61,000 nodes); and the matrix-free
# CG of parallel/rowshard ('rowshard_cg'), whose loop runs as segments
# that the host sequences: blocks of ops/kkt._CG_CHECK steps between
# reads of its stop flag, iteration tails and checks. The KKT backends
# 'cg' (its loop condition read inside a check, every _CG_CHECK steps)
# and 'pallas_cg' (kernel 2's launches counted in Python) stay eager.
CAPTURED_BACKENDS = ("inv", "chol", "banded", "spike",
                     "rowshard_cg")

# Entries of the default cache; the oldest is dropped beyond this.
CACHE_SIZE = 16

# The Settings fields a check reads. max_iter is not among them: only
# the host loop reads it. restart_every, adaptive_rho and
# adaptive_rho_interval pick the variant on the host; the restart
# average's divisor enters the key as the loop's `restart_checks`.
CHECK_FIELDS = (
    "check_every", "sigma", "alpha", "refine_steps", "cg_tol",
    "cg_max_iter", "rho_eq_scale", "rho_soc_scale", "eps_abs", "eps_rel",
    "eps_pinf", "eps_dinf", "adaptive_rho_tol", "rho_min", "rho_max",
    "stall_checks", "history")


def capturable(device, backend: str, mesh=None) -> bool:
    """Whether the checks of a loop on `device` with `backend` and
    `mesh` are captured: a CUDA device, a backend of CAPTURED_BACKENDS,
    and no mesh axis of size > 1 (collectives and `runtime.agree` stay
    eager; a 1-rank mesh makes no call and is captured like none)."""
    return (torch.device(device).type == "cuda"
            and backend in CAPTURED_BACKENDS
            and (mesh is None or all(s == 1 for s in mesh.shape.values())))


def _leaves(state, prefix=()):
    for k in sorted(state):
        v = state[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _map(fn, state):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in state.items()}


def check_key(kind: str, backend: str, settings, state, **static):
    """The cache key of a loop: its kind, backend, the CHECK_FIELDS of
    its settings, the path, shape, dtype and device of every state
    tensor, and the static arguments of its step (cone, restart_checks,
    ...), which must be hashable."""
    return (kind, backend,
            tuple(getattr(settings, f) for f in CHECK_FIELDS),
            tuple((p, tuple(t.shape), t.dtype, t.device)
                  for p, t in _leaves(state)),
            tuple(sorted(static.items())))


class _Entry:
    """Static buffers of one key and its captured variants."""

    def __init__(self, step, state, cache):
        self.step = step
        self.buffers = _map(torch.clone, state)
        self.device = next(t for _, t in _leaves(state)).device
        self.cache = cache
        self.pool = None
        self.graphs = {}
        self.warmed = set()

    def load(self, state):
        for (_, dst), (_, src) in zip(_leaves(self.buffers),
                                      _leaves(state)):
            dst.copy_(src)

    def write(self, updates):
        """Copy a step's updates into the buffers (a step returns fresh
        tensors, or a buffer unchanged under its own key)."""
        for key, value in updates.items():
            if value is not self.buffers[key]:
                self.buffers[key].copy_(value)

    def run(self, variant):
        stats = self.cache.stats
        graph = self.graphs.get(variant)
        if graph is not None:
            graph.replay()
            stats["replays"] += 1
            return
        stream = self.cache.stream(self.device)
        if variant not in self.warmed:
            cur = torch.cuda.current_stream(self.device)
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                self.write(self.step(self.buffers, variant))
            cur.wait_stream(stream)
            self.warmed.add(variant)
            stats["eager_checks"] += 1
            return
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=self.cache.keep_graphs)
        t0 = time.perf_counter()
        # capture_begin/end rather than torch.cuda.graph, which would
        # synchronise the card and empty the allocator's cache at every
        # capture: the warm-up already ran on this stream, and the graph
        # allocates from its own pool.
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=self.pool)
            try:
                self.write(self.step(self.buffers, variant))
            finally:
                graph.capture_end()
        if self.cache.keep_graphs:
            graph.instantiate()
        stats["capture_ms"] += 1e3 * (time.perf_counter() - t0)
        stats["captures"] += 1
        self.graphs[variant] = graph
        graph.replay()
        stats["replays"] += 1


class CheckCache:
    """Captured checks by `check_key`, at most `size` entries (the
    least recently used goes first), with counters for the measuring
    scripts: captures, replays, eager checks (warm-ups) and the host
    milliseconds spent capturing. One side stream per device serves
    every capture. With `keep_graphs` set, each graph keeps its captured
    template beside its executable (`raw_cuda_graph()`), so that a
    measuring script can count its nodes; it costs host memory only."""

    def __init__(self, size: int = CACHE_SIZE):
        self.size = size
        self.keep_graphs = False
        self.entries = collections.OrderedDict()
        self.streams = {}
        self.stats = dict(captures=0, replays=0, eager_checks=0,
                          capture_ms=0.0)

    def entry(self, key, step, state):
        """The entry of `key`, its buffers loaded with `state`."""
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
            entry.step = step
            entry.load(state)
            return entry
        entry = self.entries[key] = _Entry(step, state, self)
        while len(self.entries) > self.size:
            self.entries.popitem(last=False)
        return entry

    def stream(self, device):
        if device not in self.streams:
            self.streams[device] = torch.cuda.Stream(device)
        return self.streams[device]

    def clear(self):
        self.entries.clear()


CACHE = CheckCache()


class CheckLoop:
    """The state and the checks of one host loop.

    `step(state, variant)` is the check (module docstring); `pre(state)`,
    where given, runs eagerly before it every check and returns updates
    too (the fused kernel's launch, which stays outside the graph).
    `capture=None` follows `capturable`; `capture=True` for a loop that
    `capturable` refuses raises ValueError. `static` holds the step's
    hashable arguments for the key.
    """

    def __init__(self, kind, step, state, settings, backend, mesh=None,
                 pre=None, capture=None, cache=None, **static):
        dev = next(t for _, t in _leaves(state)).device
        allowed = capturable(dev, backend, mesh)
        if capture and not allowed:
            raise ValueError(f"a check on {dev} with backend {backend!r} "
                             "and this mesh is not captured")
        self.capture = allowed if capture is None else capture
        self.step, self.pre = step, pre
        if self.capture:
            cache = CACHE if cache is None else cache
            key = check_key(kind, backend, settings, state, **static)
            self._entry = cache.entry(key, step, state)
            self.state = self._entry.buffers
        else:
            self.state = dict(state)

    def __call__(self, variant) -> None:
        """Run one check; the caller then reads state['flags']."""
        if self.pre is not None:
            self.set(self.pre(self.state))
        if self.capture:
            self._entry.run(variant)
        else:
            self.state.update(self.step(self.state, variant))

    def set(self, updates):
        """Host-side updates between checks (a refactor): copied into the
        static buffers, or rebound in the plain dict."""
        if not self.capture:
            self.state.update(updates)
            return
        for key, value in updates.items():
            dst = self.state[key]
            if isinstance(dst, dict):
                for name, leaf in value.items():
                    dst[name].copy_(leaf)
            else:
                dst.copy_(value)

    def result(self, *keys):
        """The entries `keys` of the state, owned by the caller: clones
        of the static buffers, which the next loop of the key reuses."""
        out = [self.state[k] for k in keys]
        if self.capture:
            out = [_map(torch.clone, v) if isinstance(v, dict) else v.clone()
                   for v in out]
        return out
