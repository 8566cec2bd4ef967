"""The whole shared-batch solve as captured segments
(admm_library_torch/parallel/batch.py, core/graph.py) on the CPU.

- Every segment of `solve_batch_shared` (the batch loop's prologue,
  checks, refactors and epilogue; the re-centred driver's start, round
  set-up, safeguard, final residuals and join) makes no host read: each
  runs under FakeTensorMode from the state it met in a real solve, where
  `.item()`, `float(t)`, `bool(t)` and `.tolist()` raise; box-only, L1
  and SOC rows, hybrid, single and double precision.
- `solve_batch_shared` is bitwise the frozen host-code solve of
  tests/torch_loops_reference.py (`_ref_solve_batch_shared`): box-only
  and mixed cones, refactors, the f64 fallback, a per-lane q, a warm
  start, every precision path, 'chol', a 1-rank data mesh.
- The loops' keys: phase 1, the rounds, the f64 fallback and the
  driver are four entries, the same ones on a rerun, keyed on plain
  values.
- The graph module's plain parts: new entries of a segment, loads by
  path, the check/segment split, a pre inside the check, the launch
  count outside a capture.
- One slice-level case against the JAX package's solve_batch_shared.

The card's side (captured == eager bitwise, kernel 1 inside the check
graph, first-meeting captures, launches counted at replays) is in
tests/test_torch_gpu.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import admm_library_torch as T
from admm_library_torch.core import graph
from admm_library_torch.models import monte_carlo as tmc
from admm_library_torch.parallel import batch
from admm_library_torch.parallel.batch import make_data_mesh

import torch_loops_reference as ref
from test_torch_graph import M_BOX, N, _arrays, _qp

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
B = 4
# Restart every 3 checks, rho test every 2, rho far off: refactors,
# restarts and every check variant occur.
SETTINGS = T.Settings(check_every=5, adaptive_rho_interval=10,
                      restart_every=15, history=3, max_iter=300, rho=10.0,
                      backend="inv")


def _raw_batch(rows, dtype=F64, lane_q=False):
    """B lanes sharing (P, A) of test_torch_graph's problem, box bounds
    shifted per lane, q shared or per lane; unscaled."""
    arrays, cone = _arrays(rows, 0)
    qp = _qp(arrays, cone, dtype)
    rng = np.random.default_rng(7)
    shift = torch.zeros((B, qp.m), dtype=dtype)
    shift[:, 2:M_BOX] = torch.as_tensor(
        0.2 * rng.standard_normal((B, M_BOX - 2)), dtype=dtype)
    q = qp.q
    if lane_q:
        q = q + torch.as_tensor(0.1 * rng.standard_normal((B, N)),
                                dtype=dtype)
    return T.QPData(P=qp.P, q=q, A=qp.A, l=qp.l + shift, u=qp.u + shift,
                    lam=qp.lam, cone=cone)


def _mc_batch(dtype=F64, seed=5):
    qp, _, _ = tmc.monte_carlo_mpc(torch.Generator().manual_seed(seed),
                                   batch=B, N=6, dim=2, dtype=dtype,
                                   device="cpu")
    return qp


class _Segments:
    """Records (kind, step, variant, state before it) of every segment
    run by any CheckLoop while installed; the segments run as before."""

    def __init__(self, monkeypatch):
        self.runs = []
        real = graph.CheckLoop.__call__

        def call(loop, variant):
            self.runs.append((loop.kind, loop.step, variant,
                              dict(loop.state)))
            return real(loop, variant)
        monkeypatch.setattr(graph.CheckLoop, "__call__", call)

    def variants(self, kind):
        return {v for k, _, v, _ in self.runs if k == kind}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------- (a)

_FAKE_SETTINGS = {
    # Tight eps and one round: the rounds leave lanes unsolved, so the
    # f64 fallback and the join run too.
    "hybrid": dict(eps_abs=1e-10, eps_rel=1e-10, recenter_rounds=2,
                   max_iter=100),
    "single": dict(precision="single", max_iter=100),
    "double": dict(precision="double", max_iter=100),
}


@pytest.mark.parametrize("rows", ["box", "l1", "soc"])
@pytest.mark.parametrize("precision", sorted(_FAKE_SETTINGS))
def test_segments_make_no_host_read(rows, precision, monkeypatch):
    """Each distinct segment of a real solve, from the state it met,
    under FakeTensorMode: no host read, and every update keeps the shape
    and dtype of the real run's."""
    s = SETTINGS.replace(**_FAKE_SETTINGS[precision])
    rec = _Segments(monkeypatch)
    batch.solve_batch_shared(_raw_batch(rows, lane_q=rows == "box"), s)
    seen = set()
    for kind, step, variant, state in rec.runs:
        if (kind, variant) in seen:
            continue
        seen.add((kind, variant))
        real = step(state, variant)
        mode = FakeTensorMode()
        fake_state = graph._map(mode.from_tensor, state)
        with mode:
            fake = step(fake_state, variant)
        got = dict(_leaves(fake))
        for path, t in _leaves(real):
            assert tuple(got[path].shape) == tuple(t.shape), (variant, path)
            assert got[path].dtype == t.dtype, (variant, path)
    loop = rec.variants("run_admm_batch_shared")
    assert {batch.PROLOGUE, batch.REFACTOR, batch.EPILOGUE} <= loop
    assert {(False, True), (True, False)} <= loop
    if precision == "hybrid":
        assert rec.variants("solve_shared_recentered") == {
            batch.START, batch.CARRY, batch.SETUP, batch.SAFEGUARD,
            batch.FINAL, batch.JOIN}


# ---------------------------------------------------------------- (b)

def _assert_bitwise(new, old):
    for f in dataclasses.fields(old):
        a, b = getattr(new, f.name), getattr(old, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def _case(name):
    """(problem, settings, solve kwargs, segments that must run)."""
    fb = {batch.JOIN}
    cases = {
        "box_hybrid": (_mc_batch(), T.Settings(backend="inv"), {},
                       {batch.SETUP}),
        "box_hybrid_f32_data": (_mc_batch(F32), T.Settings(backend="inv"),
                                {}, {batch.SETUP}),
        "mixed_hybrid": (_raw_batch("soc"), SETTINGS, {},
                         {batch.SETUP, batch.REFACTOR}),
        "l1_hybrid_lane_q": (_raw_batch("l1", lane_q=True), SETTINGS, {},
                             {batch.SETUP}),
        "box_refactors_lane_q": (_raw_batch("box", lane_q=True), SETTINGS,
                                 {}, {batch.REFACTOR}),
        "f64_fallback": (_mc_batch(), T.Settings(backend="inv",
                                                 eps_abs=1e-9,
                                                 eps_rel=1e-9), {}, fb),
        "soc_f64_fallback": (_raw_batch("soc"), SETTINGS.replace(
            eps_abs=1e-10, eps_rel=1e-10, max_iter=150), {}, fb),
        "single": (_raw_batch("soc", F32), SETTINGS.replace(
            precision="single"), {}, {batch.REFACTOR}),
        "double": (_raw_batch("l1"), SETTINGS.replace(precision="double"),
                   {}, {batch.REFACTOR}),
        "two_phase": (_mc_batch(), T.Settings(backend="inv",
                                              recenter_rounds=0), {},
                      set()),
        "chol_hybrid": (_raw_batch("box"), SETTINGS.replace(
            backend="chol"), {}, {batch.SETUP}),
        "cg_hybrid": (_raw_batch("box"), SETTINGS.replace(
            backend="cg", max_iter=100), {}, {batch.REFACTOR}),
        "warm_start_no_history": (_mc_batch(), T.Settings(
            backend="inv", history=0, stall_checks=2), "warm", set()),
        "data_axis_1rank": (_mc_batch(), SETTINGS, "mesh",
                            {batch.SETUP}),
    }
    return cases[name]


_BITWISE = ["box_hybrid", "box_hybrid_f32_data", "mixed_hybrid",
            "l1_hybrid_lane_q", "box_refactors_lane_q", "f64_fallback",
            "soc_f64_fallback", "single", "double", "two_phase",
            "chol_hybrid", "cg_hybrid", "warm_start_no_history",
            "data_axis_1rank"]


@pytest.mark.parametrize("case", _BITWISE)
def test_solve_batch_shared_is_bitwise_the_frozen_solve(case, monkeypatch):
    qp, s, how, want = _case(case)
    kw = {}
    if how == "warm":
        rng = np.random.default_rng(2)
        kw = {k: torch.as_tensor(0.1 * rng.standard_normal((B, w)),
                                 dtype=qp.dtype)
              for k, w in (("x0", qp.n), ("z0", qp.m), ("y0", qp.m))}
    elif how == "mesh":
        kw = dict(mesh=make_data_mesh(device="cpu"))
    old = ref._ref_solve_batch_shared(qp, s, **kw)
    rec = _Segments(monkeypatch)
    new = batch.solve_batch_shared(qp, s, **kw)
    _assert_bitwise(new, old)
    ran = rec.variants("run_admm_batch_shared") | rec.variants(
        "solve_shared_recentered")
    assert want <= ran, want - ran


def _buffered(monkeypatch):
    """The capture path's bookkeeping on the CPU: every loop keeps its
    state in the static buffers of a fresh cache's entries (loads by
    path, writes, new keys, results cloned out), each segment run
    eagerly into them in place of a graph. A program's first run is its
    warm-up into its entry; a later run is its node form where a node
    builder is installed (`test_torch_graph.install_nodes`), else the
    warm-up's form again."""
    cache = graph.CheckCache()

    def run(entry, variant):
        entry.write(entry.step(entry.buffers, variant))
        entry.cache.stats["replays"] += 1

    def run_program(entry, variant, driver):
        mode = ("nodes" if entry.warm and graph._node_runner() is not None
                else "warm")
        entry.warm = True
        entry.cache.stats["replays"] += 1
        return graph._drive(entry, driver, mode)
    monkeypatch.setattr(graph, "capturable", lambda *a, **k: True)
    monkeypatch.setattr(graph, "CACHE", cache)
    monkeypatch.setattr(graph._Entry, "run", run)
    monkeypatch.setattr(graph._Entry, "run_program", run_program)
    return cache


@pytest.mark.parametrize("case", ["box_hybrid", "mixed_hybrid",
                                  "l1_hybrid_lane_q", "soc_f64_fallback",
                                  "single", "double", "data_axis_1rank"])
def test_buffered_solve_is_the_frozen_solve(case, monkeypatch):
    """solve_batch_shared through static buffers, twice on one cache
    (the second solve on other data of the same shapes reuses every
    entry) and once more on the first data: each bitwise the frozen
    solve. Stale or aliased buffers would show here."""
    qp, s, how, _ = _case(case)
    kw = dict(mesh=make_data_mesh(device="cpu")) if how == "mesh" else {}
    other = T.QPData(P=qp.P, q=qp.q, A=qp.A, l=qp.l * 0.9, u=qp.u * 0.9,
                     lam=qp.lam, cone=qp.cone)
    want = [ref._ref_solve_batch_shared(p, s, **kw) for p in (qp, other)]
    cache = _buffered(monkeypatch)
    for p, old in zip((qp, other, qp), want + want[:1]):
        _assert_bitwise(batch.solve_batch_shared(p, s, **kw), old)
    n_keys = len(cache.entries)
    assert n_keys >= 1 and cache.stats["replays"] > 0


# ---------------------------------------------------------------- (c)

def _keys(monkeypatch, fn, *args):
    """The cache key of every CheckLoop that fn(*args) builds."""
    keys = []
    real = graph.CheckLoop

    def spy(kind, step, state, settings, backend, mesh=None, **kw):
        static = {k: v for k, v in kw.items()
                  if k not in ("pre", "capture", "cache")}
        keys.append(graph.check_key(kind, backend, settings, state,
                                    **static))
        return real(kind, step, state, settings, backend, mesh=mesh, **kw)
    with monkeypatch.context() as m:
        m.setattr(graph, "CheckLoop", spy)
        fn(*args)
    return keys


def test_a_solve_holds_four_keys_and_a_rerun_the_same(monkeypatch):
    """Phase 1, the two rounds (one key), the f64 fallback and the
    re-centred driver: four entries, and a rerun on new data of the
    same shapes maps to the same four. Every key is built of plain
    values: it hashes, and holds no tensor and no mesh."""
    s = T.Settings(backend="inv", eps_abs=1e-9, eps_rel=1e-9)
    first = _keys(monkeypatch, batch.solve_batch_shared, _mc_batch(), s)
    again = _keys(monkeypatch, batch.solve_batch_shared, _mc_batch(seed=6),
                  s)
    assert len(first) == 5 and first[2] == first[3]      # two rounds
    assert len(set(first)) == 4 and first == again
    assert [k[0] for k in first] == [
        "solve_shared_recentered"] + ["run_admm_batch_shared"] * 4

    def plain(v):
        if isinstance(v, (tuple, list)):
            return all(plain(w) for w in v)
        return not isinstance(v, (torch.Tensor, batch.Mesh))
    for key in first:
        hash(key)
        assert plain(key)


def test_a_mesh_of_one_rank_keys_as_none(monkeypatch):
    """A 1-rank data mesh adds nothing to the keys: the solve on it
    shares the entries of the solve without one."""
    s = T.Settings(backend="inv")
    qp = _mc_batch()
    plain = _keys(monkeypatch, batch.solve_batch_shared, qp, s)
    meshed = _keys(monkeypatch, lambda: batch.solve_batch_shared(
        qp, s, mesh=make_data_mesh(device="cpu")))
    assert plain == meshed


# ---------------------------------------------------------------- (d)

def test_a_segment_adds_entries_with_buffers_of_their_own():
    cache = graph.CheckCache()
    raw = {"x0": torch.arange(3.0), "raw": {"A": torch.ones(2, 2)}}
    entry = cache.entry("k", None, raw)
    x0 = entry.buffers["x0"]
    # A new key aliasing a buffer gets its own copy; nested dicts too.
    entry.write({"x": x0, "fac": {"M": torch.eye(2)}})
    assert entry.buffers["x"] is not x0
    assert torch.equal(entry.buffers["x"], x0)
    assert torch.equal(entry.buffers["fac"]["M"], torch.eye(2))
    # An existing buffer is written in place; the same buffer is left.
    fac_m = entry.buffers["fac"]["M"]
    entry.write({"x": torch.full((3,), 5.0), "x0": x0,
                 "fac": {"M": torch.zeros(2, 2)}})
    assert entry.buffers["fac"]["M"] is fac_m and not fac_m.any()
    assert entry.buffers["x0"] is x0
    # A later loop of the key loads its raw entries by path; what the
    # segments added stays.
    assert cache.entry("k", None, {"x0": torch.full((3,), 2.0),
                                   "raw": {"A": torch.eye(2)}}) is entry
    assert torch.equal(entry.buffers["x0"], torch.full((3,), 2.0))
    assert torch.equal(entry.buffers["raw"]["A"], torch.eye(2))
    assert torch.equal(entry.buffers["x"], torch.full((3,), 5.0))


def test_a_new_entry_inside_a_capture_is_listed_not_allocated():
    """Inside a capture a new key, nested ones too, is only listed, for
    a buffer allocated outside the graph's pool; existing buffers are
    written in place as outside a capture."""
    buffers = {"x": torch.zeros(3), "fac": {"M": torch.zeros(2, 2)}}
    x = buffers["x"]
    grown = []
    new, inv = torch.ones(4), torch.eye(2)
    graph._write(buffers, {"x": torch.ones(3), "out": new,
                           "fac": {"M": torch.eye(2), "Minv": inv}}, grown)
    assert buffers["x"] is x and torch.equal(x, torch.ones(3))
    assert torch.equal(buffers["fac"]["M"], torch.eye(2))
    assert "out" not in buffers and "Minv" not in buffers["fac"]
    assert [(d is buffers["fac"], k, v is inv) for d, k, v in grown
            if k == "Minv"] == [(True, "Minv", True)]
    assert [(d is buffers, v is new) for d, k, v in grown
            if k == "out"] == [(True, True)]
    assert len(grown) == 2


@pytest.mark.parametrize("variant,check", [
    ((False, True), True), (("check", True, False), True),
    (("prologue",), False), (("cg", 8), False), (("setup", True), False)])
def test_is_check(variant, check):
    assert graph.is_check(variant) is check


def test_pre_runs_before_checks_only():
    """A pre runs before every check and before no other segment, inside
    the check: its updates reach the step and are not kept."""
    calls = []

    def pre(state):
        calls.append("pre")
        return dict(xn=state["x"] + 1.0)

    def step(state, variant):
        if graph.is_check(variant):
            return dict(x=state["xn"] * 2.0)
        return dict(x=state["x"] - 1.0)
    state = {"x": torch.ones(2)}
    loop = graph.CheckLoop("probe", step, state, T.Settings(), "inv",
                           pre=pre)
    loop(("prologue",))
    loop((False, False))
    loop(("refactor",))
    loop((True, True))
    assert calls == ["pre", "pre"]
    # x: 1, then 0, (0 + 1) * 2, 1, (1 + 1) * 2.
    assert torch.equal(loop.state["x"], torch.full((2,), 4.0))
    assert "xn" not in loop.state


def test_count_launch_outside_a_capture_counts_at_once():
    def kernel():
        pass
    kernel.launches = 0
    graph.count_launch(kernel)
    graph.count_launch(kernel)
    assert kernel.launches == 2


# ---------------------------------------------------------------- (e)

def test_slice_matches_jax_with_refactors():
    """The Monte-Carlo batch from rho 100x off (the shared rho refactors
    in phase 1 and the rounds) against the JAX package: the bars of
    tests/test_torch_batch.py."""
    from admm_library_tpu import Settings as JSettings
    from admm_library_tpu.models import monte_carlo as jmc
    from admm_library_tpu.parallel.batch import solve_batch_shared as jsolve
    from test_torch_batch import _compare

    qpj, _, s0 = jmc.monte_carlo_mpc(jax.random.key(3), batch=4, N=8,
                                     dim=2)
    s = JSettings(backend="inv", rho=10.0, history=8)
    jsol = jsolve(qpj, s)
    qpt, _, _ = tmc.monte_carlo_mpc_from_s0(np.asarray(s0), N=8, dim=2,
                                            device="cpu")
    tsol = batch.solve_batch_shared(qpt, T.Settings(**dataclasses.asdict(s)))
    _compare(jsol, tsol)
    assert bool((tsol.status == int(T.Status.SOLVED)).all())
