"""Captured residual checks: the port's counterpart of the JAX package's
`jax.jit`-compiled phases.

The JAX package runs a whole phase as one XLA program, a
`lax.while_loop` whose body runs `check_every` iterations and the
residual check. Here the host loop of `core.admm.run_phase` (one
problem or a lockstep batch of independent ones),
`parallel.batch.run_admm_batch_shared`, of the partitioned drivers
(`parallel.consensus.run_consensus`, `consensus_mc.run_consensus_mc`,
`horizon._run_horizon`) and of `parallel.rowshard.solve_rowsharded`
stays, and on the card each of its checks is one CUDA graph replay. The
host reads one small flag tensor a check.

A check is `step(state, variant) -> updates`: `state` is a dict of
tensors (one level of nested dicts allowed: the problem data, the
scaling, the KKT factor), `updates` the entries the check changes, and
`variant` the check's static part, the restart boundary and the rho
test (`(restart, rho_test)`), which selects one of up to four graphs. A
variant may also name a segment that the host sequences, with host
reads between segments: `parallel.batch`'s loop and
`core.admm.run_phase` run a ("prologue",) (cast, scaling, factor and
starting carry from the raw data), their checks, ("refactor",) segments
and an ("epilogue",) (the unscale and the objective), and the drivers
above them (the shared batch's re-centred rounds, `api`'s staged
rounds) their own round segments; `api`'s polish and warm-start check
are loops of one segment each. A segment may add entries to the
state: its updates hold new keys, which get buffers of their own,
allocated outside every graph's pool (a segment that adds entries is
captured twice). A loop's
static arguments enter the key as plain hashable values (a mesh by its
shape and coordinates, never by identity). A step makes no host read and
keeps no host counter: what it counts lives in the state.

A loop inside a step whose trip count the data decides, the matrix-free
CGs' (ops/kkt.cg_solve, parallel/rowshard's), goes through
`while_blocks`, the counterpart of `lax.while_loop`: inside a capture
it is CUDA-graph conditional nodes whose condition a kernel sets on the
card (csrc/graph_cond.cu), outside one the plain loop with a host read
before each block.

`CheckLoop` runs a loop's checks. Where `capturable` says no (CPU
tensors, an eager-only backend, a mesh axis of size > 1) it
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
import contextlib
import ctypes
import functools
import gc
import time
import weakref

import torch

# Backends whose check has no host read: one product ('inv'), two
# triangular solves ('chol'), block sweeps whose trip counts are static
# shapes ('banded': two sweeps over the N blocks; 'spike': batched
# interior products and a sweep over the separator blocks; a check of
# config 2 on 'banded' is a graph of ~61,000 nodes), one launch of
# kernel 2 an iteration ('pallas_cg', counted at each replay); and the
# matrix-free CGs (ops/kkt's 'cg', parallel/rowshard's 'rowshard_cg'),
# whose loops are conditional nodes (`while_blocks`).
CAPTURED_BACKENDS = ("inv", "chol", "banded", "spike", "pallas_cg", "cg",
                     "rowshard_cg")
# The backends whose checks run `while_blocks`: a captured loop on one
# of them loads the node library and makes the body stream first.
NODE_BACKENDS = ("cg", "rowshard_cg")

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
    """Whether the checks of a loop (of `kind`, which no rule reads) on
    `device` with `backend` and `mesh` are captured: a CUDA device, a
    backend of CAPTURED_BACKENDS, and no mesh axis of size > 1
    (collectives and `runtime.agree` stay eager; a 1-rank mesh makes no
    call and is captured like none)."""
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


# The capture under way in a CheckCache (a `_Capture`), else None.
_capture = None


def count_launch(kernel) -> None:
    """One launch of the hand-written kernel whose wrapper is `kernel`
    (it carries the `launches` count): counted at once, or, inside a
    `CheckCache` capture, at every replay of the graph that holds it."""
    if _capture is not None:
        if _capture.in_body:
            raise RuntimeError("a kernel launch inside a conditional node "
                               "runs a number of times no replay counts")
        _capture.launched.append(kernel)
        return
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a kernel launch captured outside a CheckCache "
                           "would not be counted at its replays")
    kernel.launches += 1


def _node_runner():
    """The builder of conditional nodes of the capture under way, or None
    outside a capture (the plain loop)."""
    if (_capture is None and torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError("a conditional loop captured outside a "
                           "CheckCache")
    return _capture


def _runs(blocks):
    """[(steps, count)]: `blocks` as runs of equal step counts."""
    runs = []
    for steps in blocks:
        if runs and runs[-1][0] == steps:
            runs[-1][1] += 1
        else:
            runs.append([steps, 1])
    return [tuple(r) for r in runs]


def while_blocks(carry: dict, live_fn, body, blocks):
    """The counterpart of `lax.while_loop` over blocks of a loop:
    `body(carry, steps)` (the carry's entries that `steps` steps change)
    for each `steps` of `blocks` in turn, while `live_fn(carry)`, a tensor of
    one element, is true before it. Returns the carry after the last
    block that ran.

    Outside a capture it is the plain loop, a host read of the flag
    before each block. Inside a `CheckCache` capture it is conditional
    nodes whose condition a kernel sets on the card: one WHILE node for
    each run of equal blocks (an IF node for a run of one), whose body is
    one block, and which re-arms after each pass while the flag holds
    and the run has blocks left. The carry is copied first, and each
    block writes into the copy in place, so the tensors after the nodes
    are the same memory whether a body ran or not; every value is the
    plain loop's, bit for bit."""
    runner = _node_runner()
    if runner is None:
        for steps in blocks:
            if not bool(live_fn(carry)):
                break
            carry = dict(carry, **body(carry, steps))
        return carry
    carry = {k: v.clone() for k, v in carry.items()}
    live = live_fn(carry).reshape(()).to(torch.bool, copy=True)

    def block(steps):
        for k, v in body(carry, steps).items():
            if v is not carry[k]:
                carry[k].copy_(v)
        live.copy_(live_fn(carry).reshape(()))

    for steps, count in _runs(blocks):
        runner.node(live, count, functools.partial(block, steps))
    return carry


# The conditional-node library (csrc/graph_cond.cu), loaded by `nodes`.
_cond = None


def nodes():
    """The conditional-node library, built and loaded at its first call,
    which must come before any capture that adds a node."""
    global _cond
    if _cond is None:
        from ..ops import _build
        lib = _build.load_library("graph_cond")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.admm_cond_init.argtypes = []
        lib.admm_cond_open.argtypes = [ptr, ptr, i32, ptr, ptr,
                                       ctypes.POINTER(ctypes.c_ulonglong)]
        lib.admm_cond_close.argtypes = [ptr, i32, ctypes.c_ulonglong, ptr,
                                        ptr, ctypes.POINTER(ctypes.c_size_t)]
        lib.admm_cond_abort.argtypes = [ptr]
        for fn in (lib.admm_cond_init, lib.admm_cond_open,
                   lib.admm_cond_close, lib.admm_cond_abort):
            fn.restype = i32
        lib.admm_cond_error_string.argtypes = [i32]
        lib.admm_cond_error_string.restype = ctypes.c_char_p
        _cond_check(lib, lib.admm_cond_init(), "loading its kernels")
        _cond = lib
    return _cond


def _cond_check(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"conditional node: {what} failed: "
                           f"{lib.admm_cond_error_string(rc).decode()}")


# torch's call that routes the current stream's allocations into a graph
# pool while it captures (a conditional body's, into its entry's pool).
_ROUTE_STREAM = "_cuda_beginAllocateCurrentStreamToPool"


class _Capture:
    """The capture under way in `_Entry._capture_once`: the kernel
    wrappers launched in it (in launch order), its conditional nodes'
    body node count, and whether a body is being captured."""

    def __init__(self, entry):
        self.entry = entry
        self.launched = []
        self.body_nodes = 0
        self.in_body = False

    def node(self, live, count, block):
        """A conditional node after the work captured so far: `block()`,
        captured once as its body, runs while the 0-d bool `live` holds,
        at most `count` times (an IF node for a count of 1). Raises if
        the node cannot be added or its body cannot be captured."""
        dev = live.device
        side = self.entry.cache.streams.get((dev, "body"))
        if _cond is None or side is None:
            raise RuntimeError("conditional nodes inside a capture need "
                               "CheckCache.prepare_nodes before it")
        lib = _cond
        passes = (torch.empty((), dtype=torch.int32, device=dev)
                  if count > 1 else None)
        pptr = None if passes is None else passes.data_ptr()
        handle = ctypes.c_ulonglong()
        stream = torch.cuda.current_stream(dev).cuda_stream
        _cond_check(lib, lib.admm_cond_open(
            stream, side.cuda_stream, count, live.data_ptr(), pptr,
            ctypes.byref(handle)), "adding the node")
        try:
            with torch.cuda.stream(side), self.entry.body_pool(dev):
                self.in_body = True
                block()
        except BaseException:
            # End the body's capture and the capture it sits in: torch
            # would instantiate a graph whose node holds a broken body
            # (the process dies there) where it now raises.
            lib.admm_cond_abort(side.cuda_stream)
            lib.admm_cond_abort(stream)
            raise
        finally:
            self.in_body = False
        body_nodes = ctypes.c_size_t()
        _cond_check(lib, lib.admm_cond_close(
            side.cuda_stream, count, handle.value, live.data_ptr(), pptr,
            ctypes.byref(body_nodes)), "capturing its body")
        self.body_nodes += body_nodes.value


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
        self.body_pool_id = None
        self.graphs = {}
        self.kernels = {}
        self.body_nodes = {}
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

    @contextlib.contextmanager
    def body_pool(self, device):
        """Routes the current stream's allocations, a conditional body's,
        into the entry's body pool while it captures. A pool of its own
        beside the graphs' `pool`: ending its routing cannot end the
        routing of the capture it sits in. The entry holds one use of
        the pool until it is dropped."""
        route = getattr(torch._C, _ROUTE_STREAM, None)
        if route is None:
            raise RuntimeError(f"torch {torch.__version__} has no "
                               f"{_ROUTE_STREAM}: a conditional body's "
                               "allocations cannot go to a graph pool")
        first = self.body_pool_id is None
        if first:
            self.body_pool_id = torch.cuda.graph_pool_handle()
        index = torch.device(device).index
        route(index, self.body_pool_id)
        try:
            yield
        finally:
            torch._C._cuda_endAllocateToPool(index, self.body_pool_id)
            if first:
                weakref.finalize(self, torch._C._cuda_releasePool, index,
                                 self.body_pool_id)
            else:
                torch._C._cuda_releasePool(index, self.body_pool_id)

    def _replay(self, variant):
        timed = self.cache.replay_events
        if timed is not None:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        self.graphs[variant].replay()
        if timed is not None:
            end.record()
            timed.append((start, end))
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
            graph, cap = self._capture_once(variant, stream, grown)
            if grown:
                for buffers, key, value in grown:
                    buffers[key] = torch.empty_like(value)
                # Drop the first graph and its outputs before the
                # second capture.
                del graph, value
                grown.clear()
                graph, cap = self._capture_once(variant, stream, grown)
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
        self.kernels[variant] = cap.launched
        self.body_nodes[variant] = cap.body_nodes

    def _capture_once(self, variant, stream, grown):
        global _capture
        graph = torch.cuda.CUDAGraph(keep_graph=self.cache.keep_graphs)
        # capture_begin/end rather than torch.cuda.graph, which would
        # synchronise the card and empty the allocator's cache at every
        # capture: the warm-up already ran on this stream, and the graph
        # allocates from its own pool.
        cap = _capture = _Capture(self)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=self.pool)
            try:
                _write(self.buffers, self.step(self.buffers, variant),
                       grown)
            finally:
                _capture = None
                graph.capture_end()
        return graph, cap


class CheckCache:
    """Captured checks by `check_key`, at most `size` entries (the
    least recently used goes first), with counters for the measuring
    scripts: captures, replays, eager segments (each entry's warm-up)
    and the host milliseconds spent capturing. One side stream per
    device serves every capture. With `keep_graphs` set, each graph
    keeps its captured template beside its executable
    (`raw_cuda_graph()`), so that a measuring script can count its
    nodes; it costs host memory only. With `replay_events` a list, each
    replay records a pair of CUDA events around itself on the stream
    (`replay_ms` sums them): the device time of the replays, which
    profiles cannot give where a graph holds conditional nodes (CUPTI
    loses records of the kernels in their bodies)."""

    def __init__(self, size: int = CACHE_SIZE):
        self.size = size
        self.keep_graphs = False
        self.replay_events = None
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

    def stream(self, device, role="capture"):
        """The stream of `role` on `device`: 'capture' runs every capture
        and warm-up, 'body' captures the bodies of conditional nodes."""
        key = (torch.device(device), role)
        if key not in self.streams:
            stream = torch.cuda.Stream(device)
            # The stream's cuBLAS handle and workspace, made here: a
            # segment captured before any eager product on this stream
            # would make them inside its capture, which fails (the 'cg'
            # backend's first check; its prologue runs no product).
            with torch.cuda.stream(stream):
                torch.cuda.current_blas_handle()
            self.streams[key] = stream
        return self.streams[key]

    def body_stream(self, device):
        return self.stream(device, "body")

    def prepare_nodes(self, device):
        """What a capture that adds conditional nodes on `device` needs
        made before it: the node library, the body stream and its cuBLAS
        workspace."""
        nodes()
        self.body_stream(device)

    def replay_ms(self) -> float:
        """The device milliseconds of the replays timed since the last
        call (waits for the last one); empties `replay_events`."""
        events, self.replay_events[:] = list(self.replay_events), []
        if events:
            events[-1][1].synchronize()
        return sum(a.elapsed_time(b) for a, b in events)

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
            if backend in NODE_BACKENDS and dev.type == "cuda":
                cache.prepare_nodes(dev)
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
