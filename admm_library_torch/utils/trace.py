"""Spans of a solve's work, on the card and on the host: one switch
(`enable`, `disable`, `enabled`; off by default), the hooks that the
port's code opens (`span`, `host`, `clock`) and one read of everything
recorded (`read`).

Two kinds of span:

- Segment spans, `span(name)`: the static tree of a solve. A program
  (`core/graph.program`, by its kind), its branches (phase1, round,
  fallback), the segments of its loops (prologue, refactor, epilogue,
  the re-centred driver's start, carry, setup, safeguard, final, join),
  each phase's loop over checks (checks), each check (check) and inside
  it kernel 1's launch (kernel1) or the plain body (iterate_block). A
  span's path is the names of the spans open around it and its own,
  joined by '/'. Inside a capture a span is a pair of stamp kernels
  (csrc/graph_cond.cu, one thread reading the card's %globaltimer): the
  one at its start writes the time into the slot of its path, the one at
  its end adds the time since to the slot's total and one to its count.
  The slot is fixed at the capture, so a body that runs at each pass of
  a conditional node sums every pass into one slot, and its count is
  the passes. The span at the top of a program also writes each
  replay's (sequence number, path, start, end) into a ring on the card.
  Outside a capture (the CPU, a plain loop, a program's eager warm-up)
  the same span is timed on the host clock into totals of its own, so
  the tree is the same on every device.
- Host spans, `host(name)`: records of the entry's host work (name,
  parent, path, depth, start, end on `time.perf_counter_ns`, and a call
  id that every span of one call shares: a span opened with none open
  starts a call).

The card's clock is tied to the host's by a calibration at `enable`
(and at a device's first `prepare` after it) and again at `read`: a
stamp between two host clock reads around a synchronise, the tightest of
a few tries. `read` fits the offset and drift from the two and converts
the ring to host time with it, giving the fit's uncertainty beside it.

Off, `span` and `host` return a shared null context, no graph holds a
stamp, and `core/graph`'s device count of the passes of phase WHILE
nodes is not captured (its count of kernel launches inside conditional
bodies is, either way).
Tracing on or off is part of every cache key, so a traced graph and an
untraced one never share an entry.
"""
from __future__ import annotations

import contextlib
import ctypes
import time

import torch

# Span slots per device, and entries of the replay ring.
N_SLOTS = 1024
RING = 8192
# Offsets into a device's slot buffer (int64): each slot's open stamp,
# total ns and count, the ring's head and the calibration stamp, then the
# ring's rows (sequence number, slot, start, end).
_TOTAL, _COUNT = N_SLOTS, 2 * N_SLOTS
_HEAD, _CALIB = 3 * N_SLOTS, 3 * N_SLOTS + 1
_RING_AT = 3 * N_SLOTS + 2
_LEN = _RING_AT + 4 * RING
# Stamp modes (csrc/graph_cond.cu trace_stamp).
BEGIN, END, END_RING, CALIBRATE = 0, 1, 2, 3
# Tries of a calibration: the tightest host bracket is kept.
_CALIB_TRIES = 8

_on = False
_scope = ()          # names of the segment spans open
_ids = {}            # segment path -> slot
_paths = []          # slot -> segment path
_host_totals = {}    # segment path -> [ns, count], timed on the host
_records = []        # host spans
_open = []           # names of the host spans open
_call = 0            # id of the last call
_devices = {}        # torch.device -> _Device
_lib = None
_NULL = contextlib.nullcontext()


def enabled() -> bool:
    return _on


def enable() -> None:
    """Switch tracing on: later captures hold stamps and the count of
    the phases' WHILE passes, later host work is recorded. Calibrates the clock of every
    device prepared so far (the first point of `read`'s fit)."""
    global _on
    _on = True
    for dev in _devices.values():
        dev.points = [_calibrate(dev)]


def disable() -> None:
    """Switch tracing off. What was recorded stays until `reset`."""
    global _on
    _on = False


def reset() -> None:
    """Forget every record and total, the card's too (the slots and the
    paths they belong to stay)."""
    _records.clear()
    _host_totals.clear()
    for dev in _devices.values():
        dev.buf.zero_()


class _Device:
    """The slot buffer of one CUDA device and its calibration points
    (globaltimer ns, host ns, half the host bracket)."""

    def __init__(self, device):
        self.device = device
        self.buf = torch.zeros(_LEN, dtype=torch.int64, device=device)
        self.points = []


def prepare(device) -> None:
    """The slot buffer of `device`, made before any capture that may
    stamp on it (`CheckCache.prepare_nodes`); calibrated if tracing is on
    and it has no point yet. Nothing is done inside a capture."""
    dev = torch.device(device)
    if dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return
    _library()
    if dev not in _devices:
        _devices[dev] = _Device(dev)
    if _on and not _devices[dev].points:
        _devices[dev].points = [_calibrate(_devices[dev])]


def _library():
    global _lib
    if _lib is None:
        from ..core import graph
        lib = graph.nodes()
        lib.admm_trace_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
        lib.admm_trace_stamp.restype = ctypes.c_int
        _lib = lib
    return _lib


def _stamp(dev: _Device, slot: int, mode: int) -> None:
    """One stamp kernel on the current stream of `dev` (captured where
    the stream captures)."""
    lib = _library()
    stream = torch.cuda.current_stream(dev.device).cuda_stream
    rc = lib.admm_trace_stamp(ctypes.c_void_p(stream),
                              ctypes.c_void_p(dev.buf.data_ptr()), N_SLOTS,
                              RING, slot, mode)
    if rc != 0:
        raise RuntimeError(f"trace stamp failed: "
                           f"{lib.admm_cond_error_string(rc).decode()}")


def _calibrate(dev: _Device):
    """(globaltimer ns, host ns, uncertainty ns): an eager stamp between
    two host clock reads around a synchronise; the tightest of a few."""
    best = None
    for _ in range(_CALIB_TRIES):
        torch.cuda.synchronize(dev.device)
        h0 = time.perf_counter_ns()
        _stamp(dev, 0, CALIBRATE)
        torch.cuda.synchronize(dev.device)
        h1 = time.perf_counter_ns()
        if best is None or h1 - h0 < 2 * best[2]:
            best = (int(dev.buf[_CALIB].item()), (h0 + h1) / 2,
                    (h1 - h0) / 2)
    return best


def _slot(path: str) -> int:
    slot = _ids.get(path)
    if slot is None:
        if len(_paths) >= N_SLOTS:
            raise RuntimeError(f"more than {N_SLOTS} span paths")
        slot = _ids[path] = len(_paths)
        _paths.append(path)
    return slot


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


class _Span:
    """A segment span (module docstring)."""

    __slots__ = ("name", "ring", "path", "dev", "t0")

    def __init__(self, name: str, ring: bool):
        self.name, self.ring = name, ring

    def __enter__(self):
        global _scope
        _scope = _scope + (self.name,)
        self.path = "/".join(_scope)
        self.dev = None
        if _capturing():
            dev = torch.device("cuda", torch.cuda.current_device())
            self.dev = _devices.get(dev)
            if self.dev is None:
                raise RuntimeError(f"a span captured on {dev} needs "
                                   "trace.prepare before the capture")
            _stamp(self.dev, _slot(self.path), BEGIN)
        else:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _scope
        _scope = _scope[:-1]
        if self.dev is None:
            total = _host_totals.setdefault(self.path, [0, 0])
            total[0] += time.perf_counter_ns() - self.t0
            total[1] += 1
        elif exc[0] is None:
            _stamp(self.dev, _slot(self.path), END_RING if self.ring else END)
        return False


def span(name: str, ring: bool = False):
    """The segment span `name` around the block (module docstring); with
    `ring`, a program's top span, whose replays go to the ring."""
    return _Span(name, ring) if _on else _NULL


class _Host:
    """A host span; its duration (`ns`) is measured whether or not it is
    recorded."""

    __slots__ = ("name", "record", "t0", "ns", "call", "parent", "path",
                 "depth")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _call
        self.record = _on
        if self.record:
            if not _open:
                _call += 1
            self.call = _call
            self.parent = _open[-1] if _open else None
            self.depth = len(_open)
            _open.append(self.name)
            self.path = "/".join(_open)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.ns = t1 - self.t0
        if self.record:
            _open.pop()
            _records.append(dict(name=self.name, parent=self.parent,
                                 path=self.path, depth=self.depth,
                                 start=self.t0, end=t1, call=self.call))
        return False


def host(name: str):
    """The host span `name` around the block, recorded while tracing is
    on (a null context while it is off)."""
    return _Host(name) if _on else _NULL


def clock(name: str) -> _Host:
    """The host span `name`, whose `ns` is measured whether or not
    tracing is on (a counter that must be fed by the span's own clock
    pair: `CheckCache.stats["capture_ms"]`)."""
    return _Host(name)


def read() -> dict:
    """Everything recorded, in one synchronise per device:

    - 'spans': the host spans (dicts: name, parent, path, depth, start,
      end, call; perf_counter ns);
    - 'host': {path: {'ns', 'count'}} of the segment spans timed on the
      host;
    - 'device': {path: {'ns', 'count'}} of the stamps on the cards;
    - 'replays': the ring's rows, oldest first (dicts: seq, path, start,
      end in perf_counter ns; the last RING replays);
    - 'clock': {device: {'offset_ns', 'drift', 'uncertainty_ns'}}: the
      fit host = offset + drift * globaltimer.

    Calibrates each traced device again (the fit's second point)."""
    out = dict(spans=[dict(r) for r in _records],
               host={p: dict(ns=t[0], count=t[1])
                     for p, t in _host_totals.items()},
               device={}, replays=[], clock={})
    for dev in _devices.values():
        if not dev.points:
            continue
        dev.points.append(_calibrate(dev))
        (g1, h1, u1), (g2, h2, u2) = dev.points[0], dev.points[-1]
        drift = (h2 - h1) / (g2 - g1) if g2 != g1 else 1.0
        offset = h1 - drift * g1
        out["clock"][str(dev.device)] = dict(
            offset_ns=offset, drift=drift, uncertainty_ns=max(u1, u2))
        buf = dev.buf.cpu().tolist()
        for slot, path in enumerate(_paths):
            count = buf[_COUNT + slot]
            if count:
                t = out["device"].setdefault(path, dict(ns=0, count=0))
                t["ns"] += buf[_TOTAL + slot]
                t["count"] += count
        head = buf[_HEAD]
        for seq in range(max(0, head - RING), head):
            at = _RING_AT + 4 * (seq % RING)
            _, slot, g0, g1_ = buf[at:at + 4]
            out["replays"].append(dict(seq=seq, path=_paths[slot],
                                       start=offset + drift * g0,
                                       end=offset + drift * g1_))
    return out
