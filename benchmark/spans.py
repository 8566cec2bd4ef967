"""Readings of the program's own spans (admm_library_torch/utils/trace.py)
in a traced run: the per-layer quantities they give and the breakdown
built from them. Pure functions of a run's record; nothing here changes
how a run is made.

They read two fields that `harness.Run` does not record yet:

- `run.spans`: the port's `trace.read()` after the window, from a run
  that switched `utils/trace` on before its warm calls;
- `run.bounds_ns`: each call's bounds, (start, end) on
  `time.perf_counter_ns`, the harness's host work between calls.

A run without them (every run of the harness as it is, and a port
without `utils/trace`) reads None from every reading here. Wiring them
into `benchmark/harness.py` is a `benchmark` change (PERF.md section 7).
"""
from __future__ import annotations

NO_SPAN = "host: no span"
BOUNDS = "host: harness, bounds of the next call"


def self_ns(device: dict) -> dict:
    """{path: ns} of each span less its children's."""
    own = {p: t["ns"] for p, t in device.items()}
    for path, t in device.items():
        parent = path.rpartition("/")[0]
        if parent in own:
            own[parent] -= t["ns"]
    return own


def device_ops(device: dict, top: int = 10) -> list:
    """[[path, seconds]] of the span tree's self times, largest first."""
    own = sorted(self_ns(device).items(), key=lambda kv: -kv[1])
    return [[path, ns / 1e9] for path, ns in own[:top]]


def _innermost(spans):
    """[(t0, t1, name)]: the time the spans (start, end, depth, name)
    cover, each piece named by the deepest span open in it."""
    events = sorted([(s, 1, i) for i, (s, _, _, _) in enumerate(spans)]
                    + [(e, 0, i) for i, (_, e, _, _) in enumerate(spans)])
    opened, pieces, prev = {}, [], None
    for t, starts, i in events:
        if opened and t > prev:
            top = max(opened.values(), key=lambda sp: sp[2])
            pieces.append((prev, t, top[3]))
        if starts:
            opened[i] = spans[i]
        else:
            opened.pop(i, None)
        prev = t
    return pieces


def _complement(intervals, t0, t1):
    """The parts of [t0, t1] that no interval covers."""
    out, at = [], t0
    for s, e in sorted(intervals):
        if e <= at:
            continue
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


def window_calls(run) -> list:
    """The host spans of the window's calls, by call, oldest first: the
    last len(run.calls_ms) calls whose top span is the cell's entry."""
    entry = run.cell.traffic["entry"]
    calls = {}
    for sp in run.spans["spans"]:
        calls.setdefault(sp["call"], []).append(sp)
    mine = [spans for _, spans in sorted(calls.items())
            if any(sp["parent"] is None and sp["name"] == entry
                   for sp in spans)]
    return mine[-len(run.calls_ms):] if run.calls_ms else []


def idle_gaps(run, top: int = 10) -> list:
    """[[name, seconds]]: the window less the replays' time on the card,
    each gap's pieces named by the innermost host span open in them,
    largest first; None without the program's replays or the calls'
    bounds."""
    n = len(run.calls_ms)
    if _program(run) is None or not n or not getattr(run, "bounds_ns",
                                                     None):
        return None
    bounds = run.bounds_ns[-n:]
    w0 = bounds[0][0]
    w1 = w0 + run.window_s * 1e9
    busy = [(r["start"], r["end"]) for r in run.spans["replays"]]
    gaps = _complement(busy, w0, w1)
    spans = [(s, e, 0, BOUNDS) for s, e in bounds]
    for call in window_calls(run):
        spans += [(sp["start"], sp["end"], sp["depth"] + 1,
                   "host: " + sp["path"]) for sp in call]
    pieces = _innermost(spans)
    out, j = {}, 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        at, k = a, j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            if s > at:
                out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (min(s, b) - at)
            lo, hi = max(s, at), min(e, b)
            if hi > lo:
                out[name] = out.get(name, 0.0) + (hi - lo)
                at = hi
            k += 1
        if b > at:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (b - at)
    ranked = sorted(out.items(), key=lambda kv: -kv[1])
    return [[name, ns / 1e9] for name, ns in ranked[:top]]


# ---------------------------------------------------------------- readings

def _program(run):
    """The device totals of a run whose trace holds program replays, else
    None."""
    spans = getattr(run, "spans", None)
    if not spans or not spans.get("replays") or not spans.get("device"):
        return None
    return spans["device"]


def _sum(device, leaf):
    paths = [t for p, t in device.items() if p.rpartition("/")[2] == leaf]
    return sum(t["ns"] for t in paths), sum(t["count"] for t in paths)


def check_every(run) -> int:
    from admm_library_torch import Settings
    return Settings(**run.cell.config["settings"]).check_every


def kernel1_us_per_iter(run):
    """Kernel 1's device time inside the program an iteration: the sum of
    the 'kernel1' spans over their count times check_every."""
    device = _program(run)
    if device is None:
        return None
    ns, count = _sum(device, "kernel1")
    return ns / 1e3 / (count * check_every(run)) if count else None


def iterate_block_us_per_iter(run):
    """The plain iteration body's device time inside the program an
    iteration: the sum of the 'iterate_block' spans over their count
    times check_every."""
    device = _program(run)
    if device is None:
        return None
    ns, count = _sum(device, "iterate_block")
    return ns / 1e3 / (count * check_every(run)) if count else None


def phase_loop_us_per_iter(run):
    """The phase loop's device time an iteration outside the iteration
    body: the 'checks' spans less the 'kernel1' and 'iterate_block' ones
    inside them, over the 'check' spans' count times check_every."""
    device = _program(run)
    if device is None:
        return None
    checks, _ = _sum(device, "checks")
    _, count = _sum(device, "check")
    if not count:
        return None
    body = _sum(device, "kernel1")[0] + _sum(device, "iterate_block")[0]
    return (checks - body) / 1e3 / (count * check_every(run))


def outside_checks_ms(run):
    """The program's device time a replay outside its phases' loops over
    checks: the program spans less the 'checks' spans, over the
    replays."""
    device = _program(run)
    if device is None:
        return None
    roots = {r["path"] for r in run.spans["replays"]}
    ns = sum(device[p]["ns"] for p in roots if p in device)
    calls = sum(device[p]["count"] for p in roots if p in device)
    if not calls:
        return None
    return (ns - _sum(device, "checks")[0]) / 1e6 / calls


def host_us_per_call(run):
    """The entry's host time a call before its replay is launched: from
    each window call's top span to the start of its first 'launch' span,
    averaged (the host work that holds the card idle; what follows the
    launch overlaps the replay)."""
    if _program(run) is None:
        return None
    before = []
    for spans in window_calls(run):
        top = next(sp for sp in spans if sp["parent"] is None)
        launches = [sp["start"] for sp in spans if sp["name"] == "launch"]
        if launches:
            before.append(min(launches) - top["start"])
    return sum(before) / len(before) / 1e3 if before else None
