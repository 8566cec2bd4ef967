"""Captured residual checks: the port's counterpart of the JAX package's
`jax.jit`-compiled phases.

The JAX package runs a whole phase as one XLA program, a
`lax.while_loop` whose body runs `check_every` iterations and the
residual check. Here the host loop of `core.admm.run_phase` (one
problem or a lockstep batch of independent ones),
`parallel.batch.run_admm_batch_shared` and of the partitioned drivers
(`parallel.consensus.run_consensus`, `consensus_mc.run_consensus_mc`,
`horizon._run_horizon`) stays, and on the card each of its checks is
one CUDA graph replay. The host still
reads one small flag tensor a check. On the matrix-free CGs
(`parallel.rowshard.solve_rowsharded`, and the phases of `run_phase`
and the batch loop on 'cg') a loop replays a few graphs an iteration
instead: the CG stops on a flag the host reads every
ops/kkt._CG_CHECK steps.

A check is `step(state, variant) -> updates`: `state` is a dict of
tensors (one level of nested dicts allowed: the problem data, the
scaling, the KKT factor), `updates` the entries the check changes, and
`variant` the check's static part, the restart boundary and the rho
test (`(restart, rho_test)`), which selects one of up to four graphs. A
variant may also name a segment that the host sequences, with host
reads between segments: `parallel.rowshard`'s loop runs ("cg", steps)
blocks of its CG, ("tail",) iteration ends and ("check", restart,
rho_test) checks, one graph each; `parallel.batch`'s loop and
`core.admm.run_phase` run a ("prologue",) (cast, scaling, factor and
starting carry from the raw data), their checks, ("refactor",) segments
and an ("epilogue",) (the unscale and the objective), on 'cg' each
check's iterations before it as ("head", first), ("cg", steps) and
("tail", first) segments (core.admm.CG_SEGMENTS), and the drivers
above them (the shared batch's re-centred rounds, `api`'s staged
rounds) their own round segments; `api`'s polish and warm-start check
are loops of one segment each. A segment may add entries to the
state: its updates hold new keys, which get buffers of their own,
allocated outside every graph's pool (a segment that adds entries is
captured twice). A loop's
static arguments enter the key as plain hashable values (a mesh by its
shape and coordinates, never by identity). A step makes no host read and
keeps no host counter: what it counts lives in the state.

`CheckLoop` runs a loop's checks. Where `capturable` says no (CPU
tensors, an eager-only backend or loop, a mesh axis of size > 1) it
applies each step's updates to a plain dict, the plain version of this
module.
Where it says yes, the state lives in static buffers owned by an entry
of a `CheckCache`, keyed by `check_key`; a later loop with the same key
copies its data and starting carry into them. An entry's very first
segment runs eagerly on the cache's side stream (the warm-up that
capture needs: cuBLAS and cuSOLVER handles and workspaces) and is then
captured for its next meeting; every other variant is captured there
the first time it is met and replayed. So every variant a run meets is
captured in that run, and a rerun captures nothing. No segment runs
twice. A failure to capture or replay raises.

A hand-written kernel launched inside a capture is counted by the graph
(`count_launch`): each replay adds the graph's launches to the kernel
wrapper's `launches`, so that count stays the number of times the
kernel ran.
"""
from __future__ import annotations

import collections
import gc
import time

import torch

# Backends whose check has no host read: one product ('inv'), two
# triangular solves ('chol'), block sweeps whose trip counts are static
# shapes ('banded': two sweeps over the N blocks; 'spike': batched
# interior products and a sweep over the separator blocks; a check of
# config 2 on 'banded' is a graph of ~61,000 nodes), one launch of
# kernel 2 an iteration ('pallas_cg', counted at each replay); and the
# matrix-free CGs, whose loops run as segments that the host sequences:
# blocks of ops/kkt._CG_CHECK steps between reads of the CG's stop flag
# (parallel/rowshard's 'rowshard_cg'; ops/kkt's 'cg' in the loops of
# CG_LOOPS only).
CAPTURED_BACKENDS = ("inv", "chol", "banded", "spike", "pallas_cg", "cg",
                     "rowshard_cg")

# The loops in which 'cg' is captured: the phases of `api.solve`,
# `solve_batch` and `solve_batch_shared` (core.admm.run_phase,
# parallel.batch._run_batch), which run its CG as host-sequenced
# segments, and the other loops of those solves, which run no CG. The
# consensus drivers' checks call ops/kkt.cg_solve, whose host reads sit
# inside the check: they stay eager on 'cg'.
CG_LOOPS = ("run_admm", "run_admm_lanes", "run_admm_batch_shared",
            "solve_shared_recentered", "recentered_rounds", "polish",
            "warm_check")

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


def capturable(device, backend: str, mesh=None, kind=None) -> bool:
    """Whether the checks of a loop of `kind` on `device` with `backend`
    and `mesh` are captured: a CUDA device, a backend of
    CAPTURED_BACKENDS ('cg' only for a kind of CG_LOOPS), and no mesh
    axis of size > 1 (collectives and `runtime.agree` stay eager; a
    1-rank mesh makes no call and is captured like none)."""
    return (torch.device(device).type == "cuda"
            and backend in CAPTURED_BACKENDS
            and (backend != "cg" or kind in CG_LOOPS)
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


def _write(buffers, updates, grown=None):
    """Copy `updates` into `buffers` (a buffer given back unchanged under
    its own key is skipped). A new key gets a clone of its own, or,
    inside a capture (`grown` a list), is only listed there as
    (buffers, key, value): its buffer must not come from the graph's
    pool (`_Entry._capture`)."""
    for key, value in updates.items():
        dst = buffers.get(key)
        if isinstance(value, dict):
            _write(buffers.setdefault(key, {}), value, grown)
        elif dst is None and grown is not None:
            grown.append((buffers, key, value))
        elif dst is None:
            buffers[key] = value.clone()
        elif value is not dst:
            dst.copy_(value)


def is_check(variant) -> bool:
    """Whether a variant is a residual check, (restart, rho_test) or
    ("check", restart, rho_test), rather than another named segment."""
    return not isinstance(variant[0], str) or variant[0] == "check"


# The kernel wrappers launched inside the capture under way (None when
# no capture is), in launch order.
_captured_launches = None


def count_launch(kernel) -> None:
    """One launch of the hand-written kernel whose wrapper is `kernel`
    (it carries the `launches` count): counted at once, or, inside a
    `CheckCache` capture, at every replay of the graph that holds it."""
    if _captured_launches is not None:
        _captured_launches.append(kernel)
        return
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a kernel launch captured outside a CheckCache "
                           "would not be counted at its replays")
    kernel.launches += 1


def check_key(kind: str, backend: str, settings, state, **static):
    """The cache key of a loop: its kind, backend, the CHECK_FIELDS of
    its settings (none for a loop whose step reads no Settings, given
    `settings` None), the path, shape, dtype and device of every state
    tensor, and the static arguments of its step (cone, restart_checks,
    ...), which must be hashable."""
    return (kind, backend,
            () if settings is None else
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
        self.kernels = {}
        self.warm = False

    def load(self, state):
        """Copy a new loop's data and carry into the buffers of the same
        paths (entries a segment added keep their contents)."""
        for path, src in _leaves(state):
            dst = self.buffers
            for k in path:
                dst = dst[k]
            dst.copy_(src)

    def write(self, updates):
        _write(self.buffers, updates)

    def _replay(self, variant):
        self.graphs[variant].replay()
        self.cache.stats["replays"] += 1
        for kernel in self.kernels[variant]:
            kernel.launches += 1

    def run(self, variant):
        if variant not in self.graphs:
            stream = self.cache.stream(self.device)
            if not self.warm:
                # The entry's first segment: eager on the capture stream
                # (the warm-up), then captured for its next meeting.
                cur = torch.cuda.current_stream(self.device)
                stream.wait_stream(cur)
                with torch.cuda.stream(stream):
                    self.write(self.step(self.buffers, variant))
                cur.wait_stream(stream)
                self.warm = True
                self.cache.stats["eager_checks"] += 1
                self._capture(variant, stream)
                return
            self._capture(variant, stream)
        self._replay(variant)

    def _capture(self, variant, stream):
        # A segment that adds state entries is captured twice: the first
        # capture lists them, their buffers are then allocated outside
        # the graph's pool, and the second capture writes into them. A
        # buffer allocated inside a capture would take pool blocks that
        # an earlier capture's scratch freed, and that graph's replays
        # would overwrite it.
        stats = self.cache.stats
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        # No garbage collection inside a capture: collecting an
        # unreachable CUDAGraph (a dropped cache's) destroys it, a call
        # that invalidates the capture under way. torch.cuda.graph runs
        # gc.collect() before each capture for the same reason.
        gc_on = gc.isenabled()
        gc.disable()
        try:
            grown = []
            graph, launched = self._capture_once(variant, stream, grown)
            if grown:
                for buffers, key, value in grown:
                    buffers[key] = torch.empty_like(value)
                # Drop the first graph and its outputs before the
                # second capture.
                del graph, value
                grown.clear()
                graph, launched = self._capture_once(variant, stream, grown)
                if grown:
                    raise RuntimeError(f"segment {variant} added state "
                                       "entries at its second capture")
        finally:
            if gc_on:
                gc.enable()
        if self.cache.keep_graphs:
            graph.instantiate()
        stats["capture_ms"] += 1e3 * (time.perf_counter() - t0)
        stats["captures"] += 1
        self.graphs[variant] = graph
        self.kernels[variant] = launched

    def _capture_once(self, variant, stream, grown):
        global _captured_launches
        graph = torch.cuda.CUDAGraph(keep_graph=self.cache.keep_graphs)
        # capture_begin/end rather than torch.cuda.graph, which would
        # synchronise the card and empty the allocator's cache at every
        # capture: the warm-up already ran on this stream, and the graph
        # allocates from its own pool.
        launched = _captured_launches = []
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=self.pool)
            try:
                _write(self.buffers, self.step(self.buffers, variant),
                       grown)
            finally:
                _captured_launches = None
                graph.capture_end()
        return graph, launched


class CheckCache:
    """Captured checks by `check_key`, at most `size` entries (the
    least recently used goes first), with counters for the measuring
    scripts: captures, replays, eager segments (each entry's warm-up)
    and the host milliseconds spent capturing. One side stream per
    device serves every capture. With `keep_graphs` set, each graph
    keeps its captured template beside its executable
    (`raw_cuda_graph()`), so that a measuring script can count its
    nodes; it costs host memory only."""

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
            stream = torch.cuda.Stream(device)
            # The stream's cuBLAS handle and workspace, made here: a
            # segment captured before any eager product on this stream
            # would make them inside its capture, which fails (the 'cg'
            # backend's first CG head; its prologue runs no product).
            with torch.cuda.stream(stream):
                torch.cuda.current_blas_handle()
            self.streams[device] = stream
        return self.streams[device]

    def clear(self):
        self.entries.clear()


CACHE = CheckCache()


class CheckLoop:
    """The state and the checks of one host loop.

    `step(state, variant)` is the check (module docstring); `pre(state)`,
    where given, runs before the step in every check, inside the same
    segment (on the card a node of the check's graph): the fused
    kernel's launch. Its updates reach the step and are not kept.
    `capture=None` follows `capturable`; `capture=True` for a loop that
    `capturable` refuses raises ValueError. `static` holds the step's
    hashable arguments for the key.
    """

    def __init__(self, kind, step, state, settings, backend, mesh=None,
                 pre=None, capture=None, cache=None, **static):
        dev = next(t for _, t in _leaves(state)).device
        allowed = capturable(dev, backend, mesh, kind)
        if capture and not allowed:
            raise ValueError(f"a check on {dev} with backend {backend!r} "
                             "and this mesh is not captured")
        self.kind = kind
        self.capture = allowed if capture is None else capture
        self.step = step if pre is None else _PreStep(pre, step)
        if self.capture:
            cache = CACHE if cache is None else cache
            key = check_key(kind, backend, settings, state, **static)
            self._entry = cache.entry(key, self.step, state)
            self.state = self._entry.buffers
        else:
            self.state = dict(state)

    def __call__(self, variant) -> None:
        """Run one check or segment; after a check the caller reads
        state['flags']."""
        if self.capture:
            self._entry.run(variant)
        else:
            self.state.update(self.step(self.state, variant))

    def set(self, updates):
        """Host-side updates between segments: copied into the static
        buffers (a new key gets buffers of their own), or rebound in the
        plain dict."""
        if self.capture:
            self._entry.write(updates)
        else:
            self.state.update(updates)

    def result(self, *keys):
        """The entries `keys` of the state, owned by the caller: clones
        of the static buffers, which the next loop of the key reuses."""
        out = [self.state[k] for k in keys]
        if self.capture:
            out = [_map(torch.clone, v) if isinstance(v, dict) else v.clone()
                   for v in out]
        return out


class _PreStep:
    """A step whose checks run `pre` first, inside the same segment."""

    def __init__(self, pre, step):
        self.pre, self.step = pre, step

    def __call__(self, state, variant):
        if not is_check(variant):
            return self.step(state, variant)
        return self.step(dict(state, **self.pre(state)), variant)
