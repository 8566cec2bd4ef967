"""The port's spans (admm_library_torch/utils/trace.py) on the CPU.

- Off (the default), nothing is recorded, and the cache key of a loop
  or program differs between tracing on and off.
- On, a small rendezvous `solve_batch_shared` and a `solve` give the
  span tree of the program (phase1, round, checks, check, the segments)
  timed on the host, each path's parent in the tree, self times >= 0,
  the 'check' counts equal to the checks the plain loop ran; the host
  spans of the entry nest inside their parents and share one call id a
  call.
- The phases' WHILE-pass counter of core/graph under the switch: a
  phase captured with tracing off has its passes listed as uncounted,
  and `CheckCache.while_passes` raises once a graph holding it has
  replayed; zeroing the counts clears that. A kernel launched inside a
  conditional body is counted on the card either way
  (`Counted.launches`).

The card's side (stamps against CUDA events, the replay ring, the
calibration, the counters in captured programs) is in
tests/test_torch_gpu.py.
"""
import collections

import pytest
import torch

import admm_library_torch as T
from admm_library_torch.core import graph
from admm_library_torch.models import monte_carlo as tmc
from admm_library_torch.ops import fused
from admm_library_torch.parallel import batch
from admm_library_torch.utils import trace


@pytest.fixture
def tracing():
    """Tracing on for the test, everything recorded forgotten after."""
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


def _mc_batch(lanes=4, seed=5):
    qp, _, _ = tmc.monte_carlo_mpc(torch.Generator().manual_seed(seed),
                                   batch=lanes, N=6, dim=2,
                                   dtype=torch.float32, device="cpu")
    return qp


def _one(qp):
    return T.QPData(P=qp.P, q=qp.q, A=qp.A, l=qp.l[0], u=qp.u[0],
                    lam=qp.lam, cone=qp.cone)


SETTINGS = T.Settings(eps_abs=1e-6, eps_rel=1e-6)


def _checks_run(monkeypatch):
    """A list that gets one entry for every batch check that runs."""
    seen = []
    real = batch.batch_check

    def counted(state, variant, **kw):
        seen.append(variant)
        return real(state, variant, **kw)
    monkeypatch.setattr(batch, "batch_check", counted)
    return seen


def _assert_tree(totals):
    """Every path's parent is in the tree and holds at least its
    children's time."""
    children = collections.defaultdict(int)
    for path, t in totals.items():
        assert t["count"] > 0 and t["ns"] >= 0, path
        if "/" in path:
            parent = path.rsplit("/", 1)[0]
            assert parent in totals, path
            children[parent] += t["ns"]
    for path, ns in children.items():
        assert totals[path]["ns"] >= ns, path


def test_off_records_nothing():
    assert not trace.enabled()
    trace.reset()
    T.solve_batch_shared(_mc_batch(lanes=2), SETTINGS.replace(max_iter=50))
    out = trace.read()
    assert out["spans"] == [] and out["host"] == {}
    assert out["device"] == {} and out["replays"] == []


def test_the_key_holds_the_switch():
    state = dict(x=torch.zeros(3))
    off = graph.check_key("k", "inv", SETTINGS, state, cone=None)
    trace.enable()
    try:
        on = graph.check_key("k", "inv", SETTINGS, state, cone=None)
    finally:
        trace.disable()
    assert on != off
    assert graph.check_key("k", "inv", SETTINGS, state, cone=None) == off


def test_a_batch_solve_gives_the_program_tree(tracing, monkeypatch):
    checks = _checks_run(monkeypatch)
    T.solve_batch_shared(_mc_batch(), SETTINGS)
    out = trace.read()
    totals = out["host"]
    _assert_tree(totals)
    root = "solve_batch_shared"
    for path in ("", "/start", "/phase1", "/phase1/prologue",
                 "/phase1/checks", "/phase1/checks/check",
                 "/phase1/epilogue", "/carry", "/round", "/round/setup",
                 "/round/checks/check", "/round/safeguard", "/final"):
        assert root + path in totals, path
    assert totals[root]["count"] == 1
    # One span per check the plain loop ran, under its phase.
    assert sum(t["count"] for p, t in totals.items()
               if p.endswith("/check")) == len(checks) > 0
    # The plain body runs in every check on the CPU.
    assert sum(t["count"] for p, t in totals.items()
               if p.endswith("/check/iterate_block")) == len(checks)
    assert out["device"] == {} and out["replays"] == []
    assert [s["name"] for s in out["spans"]] == ["inputs",
                                                 "solve_batch_shared"]


def test_a_fallback_runs_inside_its_span(tracing, monkeypatch):
    checks = _checks_run(monkeypatch)
    T.solve_batch_shared(_mc_batch(), T.Settings(eps_abs=1e-9,
                                                 eps_rel=1e-9))
    totals = trace.read()["host"]
    _assert_tree(totals)
    assert "solve_batch_shared/fallback/checks/check" in totals
    assert "solve_batch_shared/fallback/join" in totals
    assert sum(t["count"] for p, t in totals.items()
               if p.endswith("/check")) == len(checks)


def test_each_call_has_its_own_id_and_nested_spans(tracing):
    qp = _mc_batch()
    for _ in range(2):
        T.solve(_one(qp), SETTINGS)
    spans = trace.read()["spans"]
    calls = sorted({s["call"] for s in spans})
    assert len(calls) == 2
    for call in calls:
        mine = [s for s in spans if s["call"] == call]
        roots = [s for s in mine if s["parent"] is None]
        assert [r["name"] for r in roots] == ["solve"]
        by_path = {s["path"]: s for s in mine}
        assert {"solve", "solve/solve_batch_shared",
                "solve/solve_batch_shared/inputs"} <= set(by_path)
        for s in mine:
            assert s["start"] <= s["end"]
            if s["parent"] is not None:
                parent = by_path[s["path"].rsplit("/", 1)[0]]
                assert parent["name"] == s["parent"]
                assert parent["depth"] == s["depth"] - 1
                assert parent["start"] <= s["start"] <= s["end"] \
                    <= parent["end"]
    totals = trace.read()["host"]
    _assert_tree(totals)
    assert totals["solve_batch_shared"]["count"] == 2


def test_reset_forgets_what_was_recorded(tracing):
    T.solve_batch_shared(_mc_batch(lanes=2), SETTINGS.replace(max_iter=50))
    assert trace.read()["spans"]
    trace.reset()
    out = trace.read()
    assert out["spans"] == [] and out["host"] == {}


class _Replayed:
    def replay(self):
        pass


def _body_capture(entry):
    """A `_Capture` of `entry` that launched kernel 1 inside a
    conditional body and built a phase's WHILE node."""
    cap = graph._Capture(entry)
    cap.depth = 1
    outer, graph._capture = graph._capture, cap
    try:
        fused.fused_iterate_shared.counter("cpu")
        graph.count_launch(fused.fused_iterate_shared, "cpu")
        cap.pass_counter()
    finally:
        graph._capture = outer
    return cap


def test_a_body_launch_with_counters_off_raises_at_the_count():
    kernel = fused.fused_iterate_shared
    cache = graph.CheckCache()
    cache.passes[torch.device("cpu")] = torch.zeros((), dtype=torch.int64)
    entry = graph._Entry(None, dict(x=torch.zeros(2)), cache)
    kernel.launches = 0
    try:
        cap = _body_capture(entry)
        assert cap.body_launched == [kernel] and cap.passes_blind
        entry._keep("v", _Replayed(), cap)
        assert cache.while_passes() == 0
        entry._replay("v")
        # The launch counter is captured with tracing off too (the
        # capture itself added one; the CPU stands in for the card's
        # body here); the passes are not, and their count raises.
        assert kernel.launches == 1
        with pytest.raises(RuntimeError, match="tracing off"):
            cache.while_passes()
        graph.zero_counts(cache)
        assert kernel.launches == 0 and cache.while_passes() == 0
    finally:
        kernel.on_device.pop(torch.device("cpu"), None)
        kernel.launches = 0


def test_a_body_launch_with_tracing_on_is_counted(tracing):
    kernel = fused.fused_iterate_shared
    cache = graph.CheckCache()
    cache.passes[torch.device("cpu")] = torch.zeros((), dtype=torch.int64)
    entry = graph._Entry(None, dict(x=torch.zeros(2)), cache)
    kernel.launches = 0
    try:
        cap = _body_capture(entry)
        assert cap.body_launched == [kernel] and not cap.passes_blind
        entry._keep("v", _Replayed(), cap)
        entry._replay("v")
        # The capture itself added one on the device counter (the CPU
        # stands in for the card's body here).
        assert kernel.launches == 1 and cache.while_passes() == 0
    finally:
        kernel.on_device.pop(torch.device("cpu"), None)
        kernel.launches = 0
    names = [s["name"] for s in trace.read()["spans"]]
    assert names == ["launch"]
