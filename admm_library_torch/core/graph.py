"""Captured residual checks and phases: the port's counterpart of the
JAX package's `jax.jit`-compiled phases.

The JAX package runs a whole phase as one XLA program, a
`lax.while_loop` whose body runs `check_every` iterations and the
residual check, with the restart average and the refactor as
`lax.cond`s inside it. Here the loops over checks of
`core.admm.run_phase` (one problem or a lockstep batch of independent
ones), `parallel.batch._run_batch`, of the partitioned drivers
(`parallel.consensus.run_consensus`, `consensus_mc.run_consensus_mc`,
`horizon._run_horizon`) and of `parallel.rowshard.solve_rowsharded` go
through `CheckLoop.run_checks`, the counterpart of that
`lax.while_loop`: on the card it is one segment, a CUDA graph whose
WHILE node runs the checks, each check variant an IF node inside it and
the refactor an IF node after it, so the host reads nothing between
checks; outside a capture it is the plain host loop, one small flag
tensor read after each check.

A check is `step(state, variant) -> updates`: `state` is a dict of
tensors (nested dicts at any depth: the problem data, the scaling, the
KKT factor), `updates` the entries the check changes, and
`variant` the check's static part, the restart boundary and the rho
test (`(restart, rho_test)`, `variant_at`), which selects one of up to
four bodies. A variant may also name another segment:
`parallel.batch`'s loop and `core.admm.run_phase` run a ("prologue",)
(cast, scaling, factor and starting carry from the raw data), their
checks, ("refactor",) segments and an ("epilogue",) (the unscale and
the objective), and the drivers above them (the shared batch's
re-centred rounds, `api`'s staged rounds) their own round segments;
`api`'s polish and warm-start check are loops of one segment each. A
segment may add entries to the state: its updates hold new keys, which
get buffers of their own, allocated outside every graph's pool (a
segment that adds entries is captured twice); a check or refactor
inside a phase may add none. A loop's static arguments enter the key as
plain hashable values (a mesh by its shape and coordinates, never by
identity). A step makes no host read and keeps no host counter: what it
counts lives in the state.

A whole solve, the counterpart of one compiled program of the JAX
package (`_solve_shared_jit`, `_solve_jit`), is a `program`: a driver
function whose loops (each a `CheckLoop`, each phase's checks and the
segments around them) and whose host branches (`cond`, the reference's
`lax.cond`; `repeat`, a `lax.while_loop` over rounds) make one entry
of the cache. Plain, the driver runs as written: its loops are plain
loops and each branch reads its flag on the host. Captured, every loop
keeps its state in the entry, under a name of its own, and the whole
driver is one graph: each phase a WHILE node, each `cond` an IF node,
each `repeat` a WHILE node, nested as the driver nests them (at most
`NODE_DEPTH` deep), so a rerun is one graph launch and no host read.
The entry's first run is the driver run eagerly into the entry's
buffers (the warm-up: every loop's state made, every library call it
takes made once outside a capture; a branch that run does not take
makes its loops' entries without running their checks), then the
driver is captured for the next run.

A loop inside a step whose trip count the data decides, the matrix-free
CGs' (ops/kkt.cg_solve, parallel/rowshard's), goes through
`while_blocks`, the counterpart of `lax.while_loop`: inside a capture
it is CUDA-graph conditional nodes whose condition a kernel sets on the
card (csrc/graph_cond.cu), outside one the plain loop with a host read
before each block. Nodes nest: a CG's WHILE node sits inside a check's
IF node inside a phase's WHILE node, each depth captured on a body
stream and into a body pool of its own.

`CheckLoop` runs a loop's segments. Where `capturable` says no (CPU
tensors, an eager-only backend, a mesh axis of size > 1) it
applies each step's updates to a plain dict, the plain version of this
module.
Where it says yes, the state lives in static buffers owned by an entry
of a `CheckCache`, keyed by `check_key`; a later loop with the same key
copies its data and starting carry into them. An entry's very first
segment runs eagerly on the cache's side stream (the warm-up that
capture needs: cuBLAS and cuSOLVER handles and workspaces; where that
segment is a phase, only its first check) and is then captured for its
next meeting; every other segment is captured there the first time it
is met and replayed. So every segment a run meets is captured in that
run, and a rerun captures nothing. No segment runs twice. A failure to
build, capture or replay raises; nothing falls back to a host read per
check.

A hand-written kernel launched inside a capture is counted by the graph
(`count_launch`): each replay adds the graph's launches to the kernel
wrapper's `launches`, and a launch inside a conditional body adds one
to a device counter of its own at each pass, read only when `launches`
is asked for, so that count stays the number of times the kernel ran.

With `utils.trace` on, every segment, phase and program branch runs
inside a span of its own (`_segment`, `phase_nodes`, `plain_checks`,
`cond`, `repeat`, `program`): stamp kernels inside a capture, host
timing elsewhere; the entry's host work (`program`, `_Entry`) is
recorded as host spans. Off, a capture holds no stamp and no count of
the phases' WHILE passes.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import gc
import math
import weakref
from typing import NamedTuple

import torch

from ..utils import trace

# Backends whose check has no host read: one product ('inv'), two
# triangular solves ('chol'), block sweeps whose trip counts are static
# shapes ('banded': two sweeps over the N blocks; 'spike': batched
# interior products and a sweep over the separator blocks; a check of
# config 2 on 'banded' is a graph of ~61,000 nodes), one launch of
# kernel 2 an iteration ('pallas_cg'); and the matrix-free CGs
# (ops/kkt's 'cg', parallel/rowshard's 'rowshard_cg'), whose loops are
# conditional nodes (`while_blocks`).
CAPTURED_BACKENDS = ("inv", "chol", "banded", "spike", "pallas_cg", "cg",
                     "rowshard_cg")
# The deepest nesting of conditional nodes: a program's WHILE node over
# rounds (or its IF node on a fallback), a phase's WHILE node, a check
# variant's IF node, a CG's WHILE node.
NODE_DEPTH = 4
# The pass budget of a phase's WHILE node: never the bound that stops
# it (the state's 'max_iter' is).
PHASE_PASSES = 2 ** 31 - 1

# Entries of the default cache; the oldest is dropped beyond this.
CACHE_SIZE = 16

# The Settings fields a check reads. max_iter is not among them: a phase
# reads it from the state entry 'max_iter', so that loops that differ
# only in it (the f64 continuation's chunks, the re-centred rounds)
# share one capture. The check cadence (restart_every, adaptive_rho,
# adaptive_rho_interval) picks the variant: it enters the phase's
# variant (`Phase`), which keys its graph, and the restart average's
# divisor enters the key as the loop's `restart_checks`.
CHECK_FIELDS = (
    "check_every", "sigma", "alpha", "refine_steps", "cg_tol",
    "cg_max_iter", "rho_eq_scale", "rho_soc_scale", "eps_abs", "eps_rel",
    "eps_pinf", "eps_dinf", "adaptive_rho_tol", "rho_min", "rho_max",
    "stall_checks", "history")

# The named segment of a loop that refactors after a check asks for it.
REFACTOR = ("refactor",)


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


def interval_checks(settings) -> int:
    """The adaptive-rho test's cadence in checks (0: no test)."""
    if not settings.adaptive_rho:
        return 0
    return max(1, settings.adaptive_rho_interval // settings.check_every)


def variant_at(check, restart_checks: int, interval: int):
    """(restart, rho_test) of check number `check`: whether it ends a
    restart window of `restart_checks` checks and whether it runs the
    adaptive-rho test (every `interval` checks; 0 for none). `check` is
    a host int (bools out) or a 0-d tensor on the card (each part a 0-d
    bool tensor, or False where its cadence is off): the plain loop and
    the phase's nodes pick the variant with this one function."""
    restart = bool(restart_checks) and (check % restart_checks
                                        == restart_checks - 1)
    rho_test = bool(interval) and check % interval == interval - 1
    return restart, rho_test


class Phase(NamedTuple):
    """The variant of a loop's phase, the segment that runs its checks
    (`CheckLoop.run_checks`): the cadence of its check variants, the
    variants its checks can meet (`reachable`, each `tag` + (restart,
    rho_test)), whether a check's flags[1] asks for a REFACTOR, and
    whether flags[0] is 'done' rather than 'live'. `checks` bounds the
    number of checks (the warm-up runs one); the graph of a phase is
    keyed with None there. The key of its graph, with the check's
    static arguments in the entry's key."""
    name: str
    tag: tuple
    k: int
    restart_checks: int
    interval: int
    reachable: tuple
    refactor: bool
    done: bool
    checks: int | None = None

    def covers(self, other) -> bool:
        """Whether this phase's graph serves `other`: the same loop with
        every variant `other` can reach."""
        return (self._replace(reachable=(), checks=None)
                == other._replace(reachable=(), checks=None)
                and set(other.reachable) <= set(self.reachable))


def _live(flags, done: bool):
    """Whether the loop goes on after a check, from its flags (0-d)."""
    return flags[0] == 0 if done else flags[0] != 0


def plain_checks(run, read, phase: Phase, max_iter: int):
    """The host loop over checks, the plain form of a phase: `run(variant)`
    runs one segment, `read()` gives the check's flags as host values
    (the one device-to-host read of a check); after a check whose
    flags[1] asks for it, a REFACTOR. Inside the span 'checks'."""
    it, checks, live = 0, 0, True
    with trace.span("checks"):
        while (live and it < max_iter
               and (phase.checks is None or checks < phase.checks)):
            run(phase.tag + variant_at(it // phase.k, phase.restart_checks,
                                       phase.interval))
            it += phase.k
            checks += 1
            flags = read()
            live = not flags[0] if phase.done else bool(flags[0])
            if phase.refactor and flags[1]:
                run(REFACTOR)


def _segment(step, state, variant):
    """`step(state, variant)` inside the span of its segment: 'check'
    for a residual check, else the segment's name."""
    with trace.span("check" if is_check(variant) else variant[0]):
        return step(state, variant)


def _matches(parts, static):
    """The 0-d bool tensor that holds where the device's variant `parts`
    is `static`; None where no part is a tensor."""
    cond = None
    for part, want in zip(parts, static):
        if isinstance(part, torch.Tensor):
            hit = part if want else ~part
            cond = hit if cond is None else cond & hit
    return cond


def _write_in_place(buffers, updates, path=()):
    """`updates` copied into the existing `buffers`: what a check writes
    inside a conditional body, whose replays must leave their results
    in the state. A new key raises: its buffer would come from a body
    pool."""
    for key, value in updates.items():
        dst = buffers.get(key)
        if dst is None:
            raise RuntimeError(
                f"a segment inside a capture's nodes added the state entry "
                f"{'/'.join(path + (key,))}; every entry must exist "
                "before the phase or program is captured")
        if isinstance(value, dict):
            _write_in_place(dst, value, path + (key,))
        elif value is not dst:
            dst.copy_(value)


def _write_missing(buffers, updates):
    """The entries of `updates` that `buffers` lacks, cloned in; every
    existing entry is left as it is (a program's warm-up making the
    entries of a branch its run did not take)."""
    for key, value in updates.items():
        dst = buffers.get(key)
        if isinstance(value, dict):
            _write_missing(buffers.setdefault(key, {}), value)
        elif dst is None:
            buffers[key] = value.clone()


def phase_nodes(runner, step, state, phase: Phase) -> None:
    """The phase's checks as conditional nodes built by `runner`, on the
    state's own tensors: a WHILE node that runs while flags[0] says live
    and state['it'] < state['max_iter'] (before the first check only the
    bound), whose body holds an IF node for each variant in
    `phase.reachable` (its condition `variant_at` of it // k, all taken
    before any check; the check itself where one variant is reachable),
    then, for a loop that refactors, an IF node on flags[1] holding the
    REFACTOR. Each body writes its segment's updates into the state in
    place, so every value is the plain loop's, bit for bit. The WHILE
    node sits inside the span 'checks', each body inside its segment's;
    with tracing on, each pass adds one to the cache's pass counter."""
    def run(variant):
        _write_in_place(state, _segment(step, state, variant))

    it = state["it"]
    live = ((it < state["max_iter"])
            & ((it == 0) | _live(state["flags"], phase.done)))
    live = live.reshape(()).to(torch.bool, copy=True)
    counter = getattr(runner, "pass_counter", None)
    passes = None if counter is None else counter()

    def one_pass():
        parts = variant_at(state["it"] // phase.k, phase.restart_checks,
                           phase.interval)
        if len(phase.reachable) == 1:
            picks = [(phase.reachable[0], None)]
        else:
            picks = [(v, _matches(parts, v[len(phase.tag):]))
                     for v in phase.reachable]
        for variant, cond in picks:
            if cond is None:
                run(variant)
            else:
                runner.node(cond, 1, functools.partial(run, variant))
        if phase.refactor:
            runner.node(state["flags"][1] != 0, 1,
                        functools.partial(run, REFACTOR))
        if passes is not None:
            passes.add_(1)
        live.copy_((state["it"] < state["max_iter"])
                   & _live(state["flags"], phase.done))

    with trace.span("checks"):
        runner.node(live, PHASE_PASSES, one_pass)


# The capture under way in a CheckCache (a `_Capture`), else None.
_capture = None
# The kernel wrappers that count launches inside conditional bodies
# (`Counted`), for `CheckCache.prepare_nodes`.
_COUNTED = []


class Counted:
    """A hand-written kernel's wrapper and the times its kernel ran,
    `launches`: eager launches and replays of graphs that hold it at top
    level, counted on the host, plus the passes of conditional bodies
    that launch it, counted on the card in a 0-d counter per device (made
    by `CheckCache.prepare_nodes` before any capture) and read only when
    `launches` is asked for. Setting `launches` sets the host count and
    zeroes the card's."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self.host = 0
        self.on_device = {}
        _COUNTED.append(self)

    def __call__(self, *args, **kwargs):
        return self.__wrapped__(*args, **kwargs)

    @property
    def launches(self) -> int:
        return self.host + sum(int(c.item()) for c in self.on_device.values())

    @launches.setter
    def launches(self, value: int):
        self.host = value
        for c in self.on_device.values():
            c.zero_()

    def counter(self, device):
        dev = torch.device(device)
        if dev not in self.on_device:
            self.on_device[dev] = torch.zeros((), dtype=torch.int64,
                                              device=dev)
        return self.on_device[dev]


def _add_launch(kernel) -> None:
    if isinstance(kernel, Counted):
        kernel.host += 1
    else:
        kernel.launches += 1


def count_launch(kernel, device=None) -> None:
    """One launch of the hand-written kernel whose wrapper is `kernel`
    (it carries the `launches` count) on `device`: counted at once; inside
    a `CheckCache` capture at top level, at every replay of the graph
    that holds it; inside a conditional body, by the body on the card at
    every pass."""
    if _capture is not None:
        if _capture.depth:
            counter = (kernel.on_device.get(torch.device(device))
                       if isinstance(kernel, Counted) and device is not None
                       else None)
            if counter is None:
                raise RuntimeError(
                    "a kernel launch inside a conditional node needs its "
                    "device counter, made by CheckCache.prepare_nodes")
            counter.add_(1)
            _capture.body_launched.append(kernel)
            return
        _capture.launched.append(kernel)
        return
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a kernel launch captured outside a CheckCache "
                           "would not be counted at its replays")
    _add_launch(kernel)


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


# The program under way (a `_Program`), else None.
_program = None
# The one variant of a program's entry.
PROGRAM = ("program",)


class _Program:
    """A program's driver run over its entry (`program`): where its
    loops keep their state (`entry.loops`, by a name that the driver's
    structure fixes: the loop's place among the loops of its branch
    body, and the body's among the branches above it) and how its
    segments, phases and branches run (`mode`): 'warm', eagerly into the
    entry's buffers, each branch read on the host; 'make', only the
    entries a branch the warm run did not take would add, its phases
    running no check; 'nodes', every write in place and every branch a
    conditional node (inside a capture)."""

    def __init__(self, entry, mode: str):
        self.entry = entry
        self.mode = mode
        self.scope = ()
        self.counts = {}

    def name(self, what: str) -> tuple:
        i = self.counts.get(what, 0)
        self.counts[what] = i + 1
        return self.scope + (f"{what}{i}",)

    def loop_state(self, kind: str) -> dict:
        """The state of the next loop of the driver, a dict of the
        entry's `loops` (empty the first time)."""
        name = "/".join(self.name("loop")) + ":" + kind
        return self.entry.loops.setdefault(name, {})

    def write(self, buffers, updates) -> None:
        if self.mode == "nodes":
            _write_in_place(buffers, updates)
        elif self.mode == "make":
            _write_missing(buffers, updates)
        else:
            _write(buffers, updates)

    def body(self, name, block, span):
        """`block()` as the body of the branch `name`, inside the span
        `span`: the loops it builds are named inside it, the same at
        every pass."""
        outer = self.scope, self.counts
        self.scope, self.counts = name, {}
        try:
            with trace.span(span):
                block()
        finally:
            self.scope, self.counts = outer

    @contextlib.contextmanager
    def making(self):
        outer, self.mode = self.mode, "make"
        try:
            yield
        finally:
            self.mode = outer

    def runner(self):
        runner = _node_runner()
        if runner is None:
            raise RuntimeError("a program's branch as a conditional node "
                               "outside a capture")
        return runner


def cond(pred, body, read, span: str = "cond") -> None:
    """The counterpart of `lax.cond` in a driver: `body()` where `pred`
    (a tensor of one element) holds, inside the span `span`. Plain (no
    program, or a program's warm-up), `read(pred)` is the host's read of
    the flag (agreed over a mesh where the caller's `read` does that);
    inside a captured program it is an IF node, its body captured
    whether or not a run takes it. A warm-up that does not take the
    branch makes its entries."""
    prog = _program
    if prog is None:
        if read(pred):
            with trace.span(span):
                body()
        return
    name = prog.name("node")
    run = functools.partial(prog.body, name, body, span)
    if prog.mode == "nodes":
        prog.runner().node(pred.reshape(()).to(torch.bool, copy=True), 1,
                           run)
    elif prog.mode == "warm" and read(pred):
        run()
    else:
        with prog.making():
            run()


def repeat(count: int, body, pred, read, span: str = "repeat") -> None:
    """The counterpart of a `lax.while_loop` over rounds in a driver:
    `body()` at most `count` times, the first pass always, each later
    one while `pred()` (a tensor of one element, read after the pass
    before) holds; each pass inside the span `span`. Plain,
    `read(pred())` is the host's read before each later pass; inside a
    captured program it is one WHILE node of budget `count` whose body,
    captured once, is one pass."""
    prog = _program
    if prog is None:
        for r in range(count):
            with trace.span(span):
                body()
            if r + 1 < count and not read(pred()):
                break
        return
    if count <= 0:
        return
    name = prog.name("node")
    if prog.mode != "nodes":
        for r in range(count):
            prog.body(name, body, span)
            if (prog.mode == "make" or r + 1 == count
                    or not read(pred())):
                break
        return
    live = torch.ones((), dtype=torch.bool, device=prog.entry.device)

    def one_pass():
        body()
        live.copy_(pred().reshape(()))
    prog.runner().node(live, count, functools.partial(prog.body, name,
                                                      one_pass, span))


def _drive(entry, driver, mode: str):
    """`driver(entry.buffers)` as a `_Program` over `entry` in `mode`;
    returns the driver's outputs."""
    global _program
    outer = _program
    _program = _Program(entry, mode)
    try:
        return driver(entry.buffers)
    finally:
        _program = outer


def program(kind: str, driver, inputs: dict, backend: str, mesh=None,
            **static) -> dict:
    """A whole solve, `driver(inputs) -> outputs` (dicts of tensors), the
    counterpart of one compiled program of the JAX package (module
    docstring). Where `capturable` allows, it is one entry of `CACHE`,
    keyed by `kind`, `backend`, the inputs' paths, shapes, dtypes and
    devices and `static`, which must hold every value the driver reads
    besides its inputs (its settings, whole): the first run is the
    driver eagerly into the entry (its warm-up) and captured after it,
    each later run a copy of the inputs into the entry, one graph launch
    and a copy of the outputs out. Elsewhere (the CPU, a mesh axis of
    size > 1) it is `driver(inputs)`, the plain host form. A program
    inside a program is its driver, its loops the outer one's. A capture
    or a node that fails raises. The driver runs inside the span `kind`
    (captured: its graph's first and last nodes, each replay a row of
    the trace's ring); the key and the inputs' copies are the host span
    'inputs', the copies out 'outputs'."""
    outermost = _program is None

    def traced(buffers):
        with trace.span(kind, ring=outermost):
            return driver(buffers)
    dev = next(t for _, t in _leaves(inputs)).device
    if not outermost or not capturable(dev, backend, mesh, kind):
        return traced(inputs)
    with trace.host("inputs"):
        if dev.type == "cuda":
            CACHE.prepare_nodes(dev)
        entry = CACHE.entry(check_key(kind, backend, None, inputs,
                                      **static), None, inputs)
    out = entry.run_program(PROGRAM, traced)
    with trace.host("outputs"):
        return _map(torch.clone, out)


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


# libcuda, for `_upload` (loaded at its first call).
_libcuda = None


def _upload(graph, device) -> None:
    """The graph's executable uploaded to the card on the current stream
    (cuGraphUpload), so that its first launch does not pay the upload:
    a program's first replay comes in a later call than its capture,
    and a graph of ~10^4-10^5 nodes takes milliseconds to upload."""
    global _libcuda
    if _libcuda is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuGraphUpload.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.cuGraphUpload.restype = ctypes.c_int
        _libcuda = lib
    rc = _libcuda.cuGraphUpload(
        ctypes.c_void_p(graph.raw_cuda_graph_exec()),
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"cuGraphUpload returned {rc}")


def _cond_check(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"conditional node: {what} failed: "
                           f"{lib.admm_cond_error_string(rc).decode()}")


# torch's call that routes the current stream's allocations into a graph
# pool while it captures (a conditional body's, into its entry's pool).
_ROUTE_STREAM = "_cuda_beginAllocateCurrentStreamToPool"


class _Capture:
    """The capture under way in `_Entry._capture_once`: the kernel
    wrappers launched at its top level and in its conditional bodies (in
    launch order), its conditional nodes' body node count, whether a
    phase's WHILE passes went uncounted, and the depth of the body being
    captured (0 at top level)."""

    def __init__(self, entry):
        self.entry = entry
        self.launched = []
        self.body_launched = []
        self.passes_blind = False
        self.body_nodes = 0
        self.depth = 0

    def pass_counter(self):
        """The cache's count of phase WHILE passes on the entry's device,
        while tracing is on; else None, and the capture's passes are
        uncounted."""
        if not trace.enabled():
            self.passes_blind = True
            return None
        return self.entry.cache.passes.get(self.entry.device)

    def node(self, live, count, block):
        """A conditional node after the work captured so far on the
        current stream: `block()`, captured once as its body, runs while
        the 0-d bool `live` holds, at most `count` times (an IF node for a
        count of 1). The body is captured on the body stream of its
        depth, its allocations routed into the entry's body pool of that
        depth; a body may add nodes of its own. Raises if the node cannot
        be added or its body cannot be captured."""
        dev = live.device
        depth = self.depth + 1
        side = self.entry.cache.streams.get((dev, f"body{depth}"))
        if _cond is None or side is None:
            raise RuntimeError(f"a conditional node at depth {depth} "
                               "inside a capture needs "
                               "CheckCache.prepare_nodes before it (at "
                               f"most {NODE_DEPTH} deep)")
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
            with torch.cuda.stream(side), self.entry.body_pool(dev, depth):
                self.depth = depth
                block()
        except BaseException:
            # End the body's capture and the capture it sits in: torch
            # would instantiate a graph whose node holds a broken body
            # (the process dies there) where it now raises. An outer
            # body's handler ends the captures above it in turn.
            lib.admm_cond_abort(side.cuda_stream)
            lib.admm_cond_abort(stream)
            raise
        finally:
            self.depth = depth - 1
        body_nodes = ctypes.c_size_t()
        _cond_check(lib, lib.admm_cond_close(
            side.cuda_stream, count, handle.value, live.data_ptr(), pptr,
            ctypes.byref(body_nodes)), "capturing its body")
        self.body_nodes += body_nodes.value


def check_key(kind: str, backend: str, settings, state, **static):
    """The cache key of a loop: its kind, backend, the CHECK_FIELDS of
    its settings (none for a loop whose step reads no Settings, given
    `settings` None), the path, shape, dtype and device of every state
    tensor, the static arguments of its step (cone, restart_checks,
    ...), which must be hashable, and whether tracing is on (a traced
    graph holds stamps and the pass counter)."""
    return (kind, backend,
            () if settings is None else
            tuple(getattr(settings, f) for f in CHECK_FIELDS),
            tuple((p, tuple(t.shape), t.dtype, t.device)
                  for p, t in _leaves(state)),
            tuple(sorted(static.items())), trace.enabled())


class _Entry:
    """Static buffers of one key and its captured variants; for a
    program, the state of each of its loops (`loops`) and the outputs of
    its graph (`outputs`)."""

    def __init__(self, step, state, cache):
        self.step = step
        self.buffers = _map(torch.clone, state)
        self.loops = {}
        self.outputs = {}
        self.device = next(t for _, t in _leaves(state)).device
        self.cache = cache
        self.pool = None
        self.body_pool_ids = {}
        self.graphs = {}
        self.kernels = {}
        self.body_kernels = {}
        self.blind_passes = {}
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
    def body_pool(self, device, depth: int = 1):
        """Routes the current stream's allocations, a conditional body's
        at `depth`, into the entry's body pool of that depth while it
        captures. A pool of its own beside the graphs' `pool` and the
        other depths' pools: ending a routing ends the first routing of
        the same pool, which must not be the one of the capture it sits
        in. The entry holds one use of each pool until it is dropped."""
        route = getattr(torch._C, _ROUTE_STREAM, None)
        if route is None:
            raise RuntimeError(f"torch {torch.__version__} has no "
                               f"{_ROUTE_STREAM}: a conditional body's "
                               "allocations cannot go to a graph pool")
        pool = self.body_pool_ids.get(depth)
        first = pool is None
        if first:
            pool = self.body_pool_ids[depth] = torch.cuda.graph_pool_handle()
        index = torch.device(device).index
        route(index, pool)
        try:
            yield
        finally:
            torch._C._cuda_endAllocateToPool(index, pool)
            if first:
                weakref.finalize(self, torch._C._cuda_releasePool, index,
                                 pool)
            else:
                torch._C._cuda_releasePool(index, pool)

    def _replay(self, variant):
        timed = self.cache.replay_events
        if timed is not None:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        with trace.host("launch"):
            self.graphs[variant].replay()
        if timed is not None:
            end.record()
            timed.append((start, end))
        self.cache.stats["replays"] += 1
        for kernel in self.kernels[variant]:
            _add_launch(kernel)
        self.cache.blind_passes += self.blind_passes[variant]

    def run(self, variant):
        if variant not in self.graphs:
            stream = self.cache.stream(self.device)
            if not self.warm:
                # The entry's first segment: eager on the capture stream
                # (the warm-up), then captured for its next meeting. A
                # phase warms up on its first check and goes on in its
                # graph.
                warm = (variant._replace(checks=1)
                        if isinstance(variant, Phase) else variant)
                self._warm(lambda: self.write(self.step(self.buffers, warm)))
                self._capture(variant, stream)
                if not isinstance(variant, Phase):
                    return
            else:
                self._capture(variant, stream)
        self._replay(variant)

    def run_program(self, variant, driver):
        """One run of the program `driver` (`program`): its outputs. The
        first run is the driver eagerly into the entry's buffers on the
        capture stream (the warm-up; its outputs are this run's), then
        the driver is captured; later runs replay the graph."""
        if variant not in self.graphs:
            stream = self.cache.stream(self.device)
            out = None
            if not self.warm:
                out = self._warm(lambda: _drive(self, driver, "warm"))

            def body(grown):
                self.outputs[variant] = _drive(self, driver, "nodes")
            self._capture(variant, stream, body)
            if out is not None:
                return out
        self._replay(variant)
        return self.outputs[variant]

    def _warm(self, fn):
        """fn() eagerly on the capture stream, the entry's warm-up (the
        host span 'warm-up')."""
        stream = self.cache.stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        with trace.host("warm-up"), torch.cuda.stream(stream):
            out = fn()
        cur.wait_stream(stream)
        self.warm = True
        self.cache.stats["eager_checks"] += 1
        return out

    def _capture(self, variant, stream, body=None):
        # A segment that adds state entries is captured twice: the first
        # capture lists them, their buffers are then allocated outside
        # the graph's pool, and the second capture writes into them. A
        # buffer allocated inside a capture would take pool blocks that
        # an earlier capture's scratch freed, and that graph's replays
        # would overwrite it. A program's entries all exist before its
        # capture (its warm-up made them): it adds none.
        if body is None:
            def body(grown):
                _write(self.buffers, self.step(self.buffers, variant),
                       grown)
        stats = self.cache.stats
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        # capture_ms is the host span 'capture''s own clock pair.
        with trace.clock("capture") as span:
            # No garbage collection inside a capture: collecting an
            # unreachable CUDAGraph (a dropped cache's) destroys it, a
            # call that invalidates the capture under way.
            # torch.cuda.graph runs gc.collect() before each capture for
            # the same reason.
            gc_on = gc.isenabled()
            gc.disable()
            try:
                grown = []
                graph, cap = self._capture_once(body, stream, grown)
                if grown:
                    for buffers, key, value in grown:
                        buffers[key] = torch.empty_like(value)
                    # Drop the first graph and its outputs before the
                    # second capture.
                    del graph, value
                    grown.clear()
                    graph, cap = self._capture_once(body, stream, grown)
                    if grown:
                        raise RuntimeError(f"segment {variant} added "
                                           "state entries at its second "
                                           "capture")
            finally:
                if gc_on:
                    gc.enable()
            if self.cache.keep_graphs:
                graph.instantiate()
            _upload(graph, self.device)
        stats["capture_ms"] += span.ns / 1e6
        stats["captures"] += 1
        self._keep(variant, graph, cap)

    def _keep(self, variant, graph, cap):
        """The captured graph of `variant` and what its capture `cap`
        counted: the kernels it launches at top level and in its bodies,
        whether its phases' passes went uncounted (tracing off) and its
        bodies' nodes."""
        self.graphs[variant] = graph
        self.kernels[variant] = cap.launched
        self.body_kernels[variant] = cap.body_launched
        self.blind_passes[variant] = int(cap.passes_blind)
        self.body_nodes[variant] = cap.body_nodes

    def _capture_once(self, body, stream, grown):
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
                body(grown)
            finally:
                _capture = None
                graph.capture_end()
        return graph, cap


class CheckCache:
    """Captured checks by `check_key`, at most `size` entries (the
    least recently used goes first), with counters for the measuring
    scripts: captures, replays (graph launches), eager segments (each
    entry's warm-up) and the host milliseconds spent capturing, and on
    the card the passes of every phase's WHILE node captured with
    tracing on (`while_passes`; `blind_passes` counts the replays of
    graphs whose passes went uncounted).
    One side stream per device serves every capture, and one body stream
    per device and depth every conditional body. With `keep_graphs` set,
    each graph keeps its captured template beside its executable
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
        self.passes = {}
        self.blind_passes = 0
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
        and warm-up, 'body<d>' captures the bodies of conditional nodes
        at depth d."""
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

    def body_stream(self, device, depth: int = 1):
        return self.stream(device, f"body{depth}")

    def prepare_nodes(self, device):
        """What a capture that adds conditional nodes on `device` needs
        made before it: the node library, a body stream (with its cuBLAS
        workspace) for each depth, the launch counters of the kernel
        wrappers, the count of WHILE passes and the trace's slots."""
        from ..ops import fused, pallas_cg  # noqa: F401 (their Counted)
        dev = torch.device(device)
        nodes()
        trace.prepare(dev)
        for depth in range(1, NODE_DEPTH + 1):
            self.body_stream(dev, depth)
        for kernel in _COUNTED:
            kernel.counter(dev)
        if dev not in self.passes:
            self.passes[dev] = torch.zeros((), dtype=torch.int64, device=dev)

    def while_passes(self) -> int:
        """The passes of every phase WHILE node replayed so far (a read
        of the card). Raises where a graph whose passes went uncounted
        (captured with tracing off) has replayed since `zero_counts`."""
        if self.blind_passes:
            raise RuntimeError(
                f"{self.blind_passes} replays of phases captured with "
                "tracing off: their WHILE passes were not counted; switch "
                "utils.trace on before the capture")
        return sum(int(c.item()) for c in self.passes.values())

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


def zero_counts(cache=None) -> None:
    """Every kernel wrapper's `launches` and the cache's WHILE passes set
    to zero, and the passes' uncounted replays forgotten."""
    cache = CACHE if cache is None else cache
    for kernel in _COUNTED:
        kernel.launches = 0
    for counter in cache.passes.values():
        counter.zero_()
    cache.blind_passes = 0


class CheckLoop:
    """The state and the segments of one loop.

    `step(state, variant)` is the check (module docstring); `pre(state)`,
    where given, runs before the step in every check, inside the same
    segment (on the card a node of the check's graph): the fused
    kernel's launch. Its updates reach the step and are not kept.
    `capture=None` follows `capturable`; `capture=True` for a loop that
    `capturable` refuses raises ValueError. `static` holds the step's
    hashable arguments for the key. `run_checks` runs the loop's checks.
    A loop built inside a captured `program`'s driver is part of the
    program: its state lives in the program's entry, and its segments
    and checks run as the program runs (`_Program`).
    """

    def __init__(self, kind, step, state, settings, backend, mesh=None,
                 pre=None, capture=None, cache=None, **static):
        dev = next(t for _, t in _leaves(state)).device
        self.kind = kind
        self.device = dev
        self.step = step if pre is None else _PreStep(pre, step)
        self._prog = _program
        if self._prog is not None:
            self.capture = False
            self.state = self._prog.loop_state(kind)
            self._prog.write(self.state, state)
            return
        allowed = capturable(dev, backend, mesh, kind)
        if capture and not allowed:
            raise ValueError(f"a check on {dev} with backend {backend!r} "
                             "and this mesh is not captured")
        self.capture = allowed if capture is None else capture
        if self.capture:
            cache = CACHE if cache is None else cache
            if dev.type == "cuda":
                cache.prepare_nodes(dev)
            key = check_key(kind, backend, settings, state, **static)
            self._phase_step = _LoopStep(self.step)
            self._entry = cache.entry(key, self._phase_step, state)
            self.state = self._entry.buffers
        else:
            self.state = dict(state)

    def __call__(self, variant) -> None:
        """Run one segment; after a check the caller may read
        state['flags']."""
        if self._prog is not None:
            self._prog.write(self.state, _segment(self.step, self.state,
                                                  variant))
        elif self.capture:
            self._entry.run(variant)
        else:
            self.state.update(_segment(self.step, self.state, variant))

    def run_checks(self, settings, restart_checks: int, *, tag=(),
                   refactor: bool = True, done: bool = False, agree=None):
        """The loop over checks, the counterpart of the JAX package's
        `lax.while_loop` over checks: check number c is the variant `tag`
        + `variant_at(c, restart_checks, interval_checks(settings))`,
        each check runs check_every iterations and sets 'flags' (flags[0]
        'live', or 'done' with `done`; with `refactor`, flags[1] asks for
        a REFACTOR after the check), while it is live and state['it'] <
        settings.max_iter.

        Plain (`capture` off), it is the host loop, one read of the
        flags a check (through `agree`, the ranks' agreement, where
        given). Captured, it is one segment, the `Phase` whose graph's
        WHILE node runs the checks on the card (`phase_nodes`) with no
        read; its bound is the state entry 'max_iter', so a loop that
        differs only in max_iter replays the same graph. The graph holds
        the variants reachable within max_iter; a graph holding more
        serves too."""
        k = settings.check_every
        n_checks = max(0, -(-settings.max_iter // k))
        interval = interval_checks(settings)
        period = math.lcm(restart_checks or 1, interval or 1)
        reachable = tuple(sorted(
            {tuple(tag) + variant_at(c, restart_checks, interval)
             for c in range(min(n_checks, period))}))
        phase = Phase("phase", tuple(tag), k, restart_checks, interval,
                      reachable, refactor, done)
        if self._prog is not None:
            self._program_checks(phase, settings.max_iter, n_checks, agree)
            return
        if not self.capture:
            def read():
                flags = self.state["flags"]
                return (flags if agree is None else agree(flags)).tolist()
            plain_checks(self, read, phase, settings.max_iter)
            return
        if not n_checks:
            return
        self.set(dict(max_iter=torch.full((), settings.max_iter,
                                          dtype=torch.int64,
                                          device=self.device)))
        self._phase_step.host = (settings.max_iter, agree)
        phase = next((v for v in self._entry.graphs
                      if isinstance(v, Phase) and v.covers(phase)), phase)
        self(phase)

    def _program_checks(self, phase: Phase, max_iter: int, n_checks: int,
                        agree):
        """The checks of a program's loop: the plain loop in its warm-up
        (none where it makes a branch's entries), the phase's nodes in its
        capture; the bound 'max_iter' in the state (the program's key
        holds it)."""
        prog = self._prog
        prog.write(self.state, dict(max_iter=torch.full(
            (), max_iter, dtype=torch.int64, device=self.device)))
        if prog.mode == "nodes":
            if n_checks:
                phase_nodes(prog.runner(), self.step, self.state, phase)
        elif prog.mode == "warm":
            def read():
                flags = self.state["flags"]
                return (flags if agree is None else agree(flags)).tolist()
            plain_checks(self, read, phase, max_iter)

    def set(self, updates):
        """Host-side updates between segments: copied into the static
        buffers (a new key gets buffers of their own), or rebound in the
        plain dict; in a program, written as its segments are."""
        if self._prog is not None:
            self._prog.write(self.state, updates)
        elif self.capture:
            self._entry.write(updates)
        else:
            self.state.update(updates)

    def result(self, *keys):
        """The entries `keys` of the state, owned by the caller: clones
        of the static buffers, which the next loop of the key reuses (a
        program's loop gives its entry's tensors: the program copies its
        outputs out)."""
        out = [self.state[k] for k in keys]
        if self.capture:
            out = [_map(torch.clone, v) if isinstance(v, dict) else v.clone()
                   for v in out]
        return out


class _LoopStep:
    """The step of a captured loop's entry: the loop's own step for its
    segments, and for a `Phase` its checks, as conditional nodes inside a
    capture (`phase_nodes`), else as the plain loop on a copy of the
    state (the entry's warm-up), whose changed entries it returns.
    `host` holds the host's (max_iter, agree) of the loop that runs it."""

    def __init__(self, step):
        self.step = step
        self.host = None

    def __call__(self, state, variant):
        if not isinstance(variant, Phase):
            return _segment(self.step, state, variant)
        runner = _node_runner()
        if runner is not None:
            phase_nodes(runner, self.step, state, variant)
            return {}
        max_iter, agree = self.host
        work = dict(state)

        def run(v):
            work.update(_segment(self.step, work, v))

        def read():
            flags = work["flags"]
            return (flags if agree is None else agree(flags)).tolist()
        plain_checks(run, read, variant, max_iter)
        return work


class _PreStep:
    """A step whose checks run `pre` first, inside the same segment."""

    def __init__(self, pre, step):
        self.pre, self.step = pre, step

    def __call__(self, state, variant):
        if not is_check(variant):
            return self.step(state, variant)
        return self.step(dict(state, **self.pre(state)), variant)
