"""One run of one cell: set-up, the measured window, the traced extras,
the check of the answers against the plain reference, and the result.

Everything that belongs to one configuration, one traffic mix or one
metric is data found by name:

- `BENCHMARK.json` (at the checkout's root) names each cell's
  configuration and traffic and each metric's cells;
- `configs/<config>.json`: the problem family and its sizes, the
  solver's settings, the guarantee and the limits of the comparison;
- `families/<family>.py`: the frozen problem builder of a family
  (`build`, `bounds_for_s0`);
- `workloads/<traffic>.json`: the entry the calls go through, the lanes
  of a call and the draw of the initial states (`traffic.py` reads it);
- `metrics/<metric>.py`: `read(run) -> float | None`, the metric from
  what the run recorded; None leaves the metric out of the line.

A call is timed on the host clock from the call until
`torch.cuda.synchronize()` returns after it; the window is closed loop,
one caller, and ends with the first call that ends past `seconds`.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import random
import time
from pathlib import Path

from . import arith, reference, traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "admm_library_tpu")
# The kernel-1 launch of the set-up's eager warm-up whose arguments the
# traced run times again (the first ones start from the cold iterate).
KERNEL1_LAUNCH = 3
SOLVED = 1


class NoCard(RuntimeError):
    """The machine lacks the CUDA devices the cell asks for."""


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of the spec with its configuration, traffic, family and
    the metrics it reports, found by name under `base`."""

    def __init__(self, name: str, spec: dict, base: Path = HERE):
        found = [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        wl = found[0]
        self.name, self.chips = name, wl["chips"]
        self.config = json.loads(
            (base / "configs" / f"{wl['config']}.json").read_text())
        self.traffic = json.loads(
            (base / "workloads" / f"{wl['traffic']}.json").read_text())
        self.family = _module(base / "families"
                              / f"{self.config['family']}.py")

        def mine(metric):
            return "workloads" not in metric or name in metric["workloads"]
        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]
        self.readers = {m["name"]: _module(base / "metrics"
                                           / f"{m['name']}.py")
                        for m in self.end_to_end + self.per_layer}

    def draw_spec(self) -> dict:
        draw = dict(self.traffic["draw"])
        if draw["center"] == "nominal":
            draw["center"] = self.config["problem"]["s0_nominal"]
        return dict(self.traffic, draw=draw)


class Run:
    """What a run recorded, for the metric readers. Lists hold one entry
    per call of the window; the traced fields are None in an untraced
    run."""

    def __init__(self, cell: Cell, trace: bool):
        self.cell, self.trace = cell, trace
        self.lanes = cell.traffic["lanes"]
        self.setup_s = None
        self.captures = 0
        self.capture_ms = 0.0
        self.window_s = None
        self.calls_ms = []
        self.iters = []                 # lockstep iterations a call
        self.replays = None             # graph launches a call
        self.host_reads = None          # host reads a call
        self.replay_ms = None           # device ms of every replay
        self.kernel1 = None             # dict(ms, bound_ms, bound_by, ...)


class _Kernel1:
    """Records a copy of the arguments of the KERNEL1_LAUNCH-th eager
    launch of kernel 1 (`ops/fused.fused_iterate_shared`) in the block.
    The wrapper that counts the kernel's launches stays in place: the
    function it wraps is swapped."""

    def __init__(self, fused):
        self.kernel = fused.fused_iterate_shared
        self.inner = getattr(self.kernel, "__wrapped__", None)
        self.seen, self.args, self.kw = 0, None, None

    def __enter__(self):
        import torch

        def record(*args, **kw):
            if (self.seen < KERNEL1_LAUNCH
                    and not torch.cuda.is_current_stream_capturing()):
                self.seen += 1
                self.args = [a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args]
                self.kw = dict(kw)
            return self.inner(*args, **kw)
        if self.inner is not None:
            self.kernel.__wrapped__ = record
        return self

    def __exit__(self, *exc):
        if self.inner is not None:
            self.kernel.__wrapped__ = self.inner

    def time(self):
        """The k-block's CUDA-event time at the recorded arguments and
        its bound from the shapes."""
        x, z = self.args[8], self.args[9]
        kw = self.kw
        B, n, m = x.shape[0], x.shape[1], z.shape[1]
        flops, nbytes = arith.fused_work(B, n, m, kw["cone"].m_l1, kw["k"],
                                         kw["refine_steps"])
        ms = arith.cuda_ms(lambda: self.kernel(*self.args, **kw), reps=20,
                           warmup=3)
        bound_ms, bound_by = arith.bound(flops, nbytes)
        return dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by, B=B, n=n,
                    m=m, k=kw["k"], flops=flops, bytes=nbytes)


class _ProgramLabels:
    """Labels each replay recorded in `graph.CACHE.replay_events` inside
    the block by the kind of the whole-solve program it belongs to."""

    def __init__(self, graph):
        self.graph, self.real = graph, graph.program
        self.spans = []

    def __enter__(self):
        events = self.graph.CACHE.replay_events

        def program(kind, *a, **k):
            i0 = len(events)
            out = self.real(kind, *a, **k)
            self.spans.append((kind, i0, len(events)))
            return out
        self.graph.program = program
        return self

    def __exit__(self, *exc):
        self.graph.program = self.real

    def label(self, count):
        labels = ["segment outside a program"] * count
        for kind, i0, i1 in self.spans:
            for i in range(i0, i1):
                labels[i] = f"program {kind}"
        return labels


class _Reservoir:
    """A uniform sample of `size` calls of the window drawn from the
    seed (every call where size is 0)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, random.Random(seed)
        self.kept, self.seen = [], 0

    def offer(self, item_fn):
        i, self.seen = self.seen, self.seen + 1
        if not self.size or i < self.size:
            self.kept.append(item_fn())
            return
        j = self.rng.randrange(i + 1)
        if j < self.size:
            self.kept[j] = item_fn()


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(rec, entry, settings, problem, pool, seconds, sample, device,
            graph):
    """The closed loop: calls over the pool until one ends `seconds`
    after the first began. Returns each call's status and iterations (on
    the device) and the host seconds spent making the next call's bounds.
    A traced run also counts each call's host reads and graph launches."""
    statuses, iters = [], []
    gaps_s, i = 0.0, 0
    tw0 = t2 = time.perf_counter()
    while t2 - tw0 < seconds:
        g0 = time.perf_counter()
        l, u, qp = problem(pool[i % pool.shape[0]])
        _sync(device)
        reads = arith.HostReads() if rec.trace else contextlib.nullcontext()
        r0 = graph.CACHE.stats["replays"]
        with reads:
            t1 = time.perf_counter()
            sol = entry(qp, settings)
            _sync(device)
            t2 = time.perf_counter()
        gaps_s += t1 - g0
        rec.calls_ms.append(1e3 * (t2 - t1))
        if rec.trace:
            rec.host_reads.append(reads.count)
            rec.replays.append(graph.CACHE.stats["replays"] - r0)
        statuses.append(sol.status.clone())
        iters.append(sol.iters.clone())
        sample.offer(lambda: tuple(t.clone() for t in
                                   (l, u, sol.x, sol.z, sol.y, sol.status)))
        i += 1
    rec.window_s = t2 - tw0
    return statuses, iters, gaps_s


def _breakdown(rec, labels, events, gaps_s):
    """The replays' device seconds by program kind and the window's
    host time outside them, largest first."""
    rec.replay_ms = [a.elapsed_time(b) for a, b in events]
    by_kind = {}
    for name, ms in zip(labels.label(len(events)), rec.replay_ms):
        by_kind[name] = by_kind.get(name, 0.0) + ms / 1e3
    busy = sum(rec.replay_ms) / 1e3
    calls_s = sum(rec.calls_ms) / 1e3
    gaps = [["host inside calls, outside replays", max(calls_s - busy, 0.0)],
            ["host between calls: bounds of the next call", gaps_s],
            ["host between calls: bookkeeping",
             max(rec.window_s - calls_s - gaps_s, 0.0)]]
    return dict(device_ops=sorted(([k, v] for k, v in by_kind.items()),
                                  key=lambda kv: -kv[1])[:10],
                idle_gaps=sorted(gaps, key=lambda kv: -kv[1]))


def _judge(sample, base_qp, settings, limits, unsolved, log):
    """The sampled answers against the plain reference: (compared, bad),
    compared = {name: (value, limit)}, bad = the answers that say SOLVED
    and read above the limit."""
    worst, bad, checked = 0.0, 0, 0
    parts = {k: 0.0 for k in reference.RATIOS}
    for l, u, x, z, y, status in sample.kept:
        ratio, part = reference.kkt_ratio(dict(base_qp, l=l, u=u), x, z, y,
                                          settings.eps_abs, settings.eps_rel)
        worst = max(worst, float(ratio.max()))
        parts = {k: max(parts[k], part[k]) for k in parts}
        bad += int(((ratio > limits["kkt_ratio"])
                    & (status.reshape(-1) == SOLVED)).sum())
        checked += ratio.numel()
    log(f"reference: {checked} answers checked, worst ratios "
        f"{json.dumps(parts)}")
    return {"unsolved": (unsolved, limits["unsolved"]),
            "kkt_ratio": (worst, limits["kkt_ratio"])}, bad


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        t_start: float | None = None, device=None, spec: dict | None = None,
        base: Path = HERE, settings_change: dict | None = None,
        entry_wrap=None, log=print):
    """One run of `cell_name`: (result, the run's record). `device` None
    asks for the CUDA card (NoCard without it); the tests pass the CPU.
    `settings_change` (the control) replaces settings of the
    configuration and `entry_wrap` (the tests' faults) wraps the entry;
    neither is reachable from the command line."""
    t0 = time.perf_counter() if t_start is None else t_start
    import torch

    spec = load_spec() if spec is None else spec
    cell = Cell(cell_name, spec, base)
    if device is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < cell.chips:
            raise NoCard(f"{cell_name} needs {cell.chips} CUDA device(s); "
                         f"this machine has {count}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    log(f"deterministic algorithms: "
        f"{torch.are_deterministic_algorithms_enabled()}")
    marks = [("start", t0), ("torch", time.perf_counter())]
    torch.empty(1, device=device)
    marks.append(("device", time.perf_counter()))

    import admm_library_torch as port
    from admm_library_torch.core import graph
    from admm_library_torch.ops import _build, fused
    if device.type == "cuda":
        _build.build()
    marks.append(("program", time.perf_counter()))

    cfg, tr = cell.config, cell.traffic
    base_qp = cell.family.build(cfg["problem"],
                                dtype=getattr(torch, cfg["dtype"]),
                                device=device)
    cone = port.ConeSpec(m_box=base_qp["m_box"], m_l1=base_qp["m_l1"],
                         soc_dims=tuple(base_qp.get("soc_dims", ())))
    warm_s0, pool = traffic.draws(cell.draw_spec(), seed, device)
    settings = port.Settings(**cfg["settings"])
    if settings_change:
        settings = settings.replace(**settings_change)
    entry = getattr(port, tr["entry"])
    if entry_wrap is not None:
        entry = entry_wrap(entry)
    batched = tr["entry"] == "solve_batch_shared"

    def problem(s0):
        """The QP of one call: the shared data and the bounds of s0
        (lanes, components)."""
        l, u = cell.family.bounds_for_s0(base_qp, cfg["problem"],
                                         s0 if batched else s0[0])
        return l, u, port.QPData(P=base_qp["P"], q=base_qp["q"],
                                 A=base_qp["A"], l=l, u=u,
                                 lam=base_qp["lam"], cone=cone)

    _sync(device)
    marks.append(("inputs", time.perf_counter()))
    rec = Run(cell, trace)
    stats0 = dict(graph.CACHE.stats)
    k1 = _Kernel1(fused) if trace else contextlib.nullcontext()
    with k1:
        for s0 in warm_s0:
            entry(problem(s0)[2], settings)
            _sync(device)
    rec.setup_s = time.perf_counter() - t0
    marks.append(("warm calls", time.perf_counter()))
    log("set-up s: " + ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b)
                                 in zip(marks, marks[1:])))
    rec.captures = graph.CACHE.stats["captures"] - stats0["captures"]
    rec.capture_ms = graph.CACHE.stats["capture_ms"] - stats0["capture_ms"]

    launches0 = fused.fused_iterate_shared.launches if trace else 0
    stats1 = dict(graph.CACHE.stats)
    sample = _Reservoir(tr["sample_calls"], seed)
    labels = _ProgramLabels(graph) if trace else contextlib.nullcontext()
    if trace:
        rec.replays, rec.host_reads = [], []
        graph.CACHE.replay_events = []
    with labels:
        statuses, iters, gaps_s = _window(rec, entry, settings, problem,
                                          pool, seconds, sample, device,
                                          graph)
    _sync(device)
    in_window = {k: graph.CACHE.stats[k] - stats1[k]
                 for k in ("captures", "eager_checks")}
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    breakdown = None
    if trace:
        events, graph.CACHE.replay_events = graph.CACHE.replay_events, None
        _sync(device)
        breakdown = _breakdown(rec, labels, events, gaps_s)
        if (k1.args is not None
                and fused.fused_iterate_shared.launches > launches0):
            rec.kernel1 = k1.time()

    rec.iters = [int(t.max()) for t in iters]
    statuses = torch.stack(statuses)
    unsolved = int((statuses != SOLVED).sum())
    compared, bad = _judge(sample, base_qp, settings, cfg["limits"],
                           unsolved, log)
    log(f"window: {len(rec.calls_ms)} calls in {rec.window_s:.3f} s, "
        f"iterations {min(rec.iters)}..{max(rec.iters)}, captures in "
        f"window {in_window['captures']}, eager segments in window "
        f"{in_window['eager_checks']}, set-up captures {rec.captures}")
    if rec.kernel1:
        log(f"kernel 1: {json.dumps(rec.kernel1)}")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": memory_peak}
    if trace:
        dev["busy_s"] = sum(rec.replay_ms) / 1e3
        dev["window_s"] = rec.window_s
    result = {"correct": all(v <= lim for v, lim in compared.values()),
              "attempted": statuses.numel(), "failed": unsolved + bad,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    return result, rec


def loaded_forbidden(modules) -> list:
    """The names in `modules` whose top-level name is forbidden."""
    return sorted({name for name in modules
                   if name.split(".")[0] in FORBIDDEN})

