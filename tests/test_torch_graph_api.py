"""The single-problem programs as captured segments (admm_library_torch/
api.py, core/admm.run_phase, core/polish.polish_step) on the CPU.

- Every segment that `solve` and `solve_batch` run besides the shared
  batch's makes no host read: each runs under FakeTensorMode from the
  state it met in a real solve, where `.item()`, `float(t)`, `bool(t)`
  and `.tolist()` raise. A phase's prologue, checks, refactors and
  epilogue, one problem and lanes; `_solve_core`'s join (the second
  phase's cleaning prologue and joining epilogue); the staged rounds'
  set-up, join and final; polish on box, L1 and SOC rows; the
  warm-start check.
- `solve` and `solve_batch` are bitwise the frozen host code of
  tests/torch_loops_reference.py (`_ref_solve`, `_ref_solve_batch`):
  hybrid (the B=1 delegation and the two-phase batch), single, double,
  the staged L1 path with rounds and polish, an SOC problem that enters
  the f64 continuation, warm starts, on 'chol', 'inv' and 'cg'; and
  through the capture path's static buffers.
- The loops' keys: a rerun meets the same ones, the continuation's
  chunks share one, and each is built of plain values.
- One slice-level case against the JAX package's solve.

The card's side (each new segment replayed bitwise its eager run, a
rerun capturing nothing) is in tests/test_torch_gpu.py.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import admm_library_torch as T
from admm_library_torch import api
from admm_library_torch.core import admm, graph

import torch_loops_reference as ref
from test_torch_graph import _arrays, _qp
from test_torch_graph_solve import _buffered, _keys, _leaves

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
B = 3
# Restart every 3 checks, rho test every 2, rho far off: refactors,
# restarts and every check variant occur.
LOOPS = T.Settings(check_every=5, adaptive_rho_interval=10,
                   restart_every=15, history=3, max_iter=300, rho=10.0)


def _one(rows, dtype=F64, seed=0):
    return _qp(*_arrays(rows, seed), dtype)


def _lanes(rows, dtype=F64):
    """B independent problems, every leaf with a lane axis, unscaled."""
    qps = [_one(rows, dtype, s) for s in range(B)]
    return T.QPData(**{f: torch.stack([getattr(q, f) for q in qps])
                       for f in admm.QP_FIELDS}, cone=qps[0].cone)


def _warm(qp, seed=2):
    rng = np.random.default_rng(seed)
    lead = qp.P.shape[:-2]
    return {k: torch.as_tensor(0.1 * rng.standard_normal(lead + (w,)),
                               dtype=qp.dtype)
            for k, w in (("x0", qp.n), ("z0", qp.m), ("y0", qp.m))}


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

    def met(self):
        """{(kind, variant)}, every check variant as 'check'."""
        return {(k, "check" if graph.is_check(v) else v)
                for k, _, v, _ in self.runs}


# Every case: (solve function, problem, settings, solve kwargs).
def _case(name):
    tight = dict(eps_abs=1e-9, eps_rel=1e-9)
    cases = {
        # The B=1 delegation (solve_batch_shared's own segments).
        "box_hybrid": (T.solve, _one("box"), T.Settings(backend="chol"),
                       {}),
        "single_soc_f32": (T.solve, _one("soc", F32), LOOPS.replace(
            precision="single", backend="chol"), {}),
        "double_l1_inv": (T.solve, _one("l1", F32), LOOPS.replace(
            precision="double", backend="inv"), {}),
        "double_box_cg": (T.solve, _one("box"), LOOPS.replace(
            precision="double", backend="cg", max_iter=100), {}),
        # The staged path: f32 phase, polish, rounds, f64 phase, polish.
        "l1_staged_rounds": (T.solve, _one("l1"), T.Settings(
            backend="chol", **tight), {}),
        "l1_staged_rounds_inv": (T.solve, _one("l1", seed=2), T.Settings(
            backend="inv", **tight), {}),
        # recenter_rounds=0 sends a box problem down the staged path.
        "box_staged_polish": (T.solve, _one("box"), T.Settings(
            backend="chol", recenter_rounds=0, **tight), {}),
        # The shared pass leaves it unsolved: the f64 continuation.
        "soc_continuation": (T.solve, _one("soc"), T.Settings(
            backend="chol", max_iter=25), {}),
        "warm_start_staged": (T.solve, _one("l1"), T.Settings(
            backend="chol", **tight), "warm"),
        "warm_start_solved": (T.solve, _one("box"), T.Settings(
            backend="chol"), "solution"),
        "batch_hybrid": (T.solve_batch, _lanes("soc"), LOOPS.replace(
            backend="chol"), {}),
        "batch_single_inv": (T.solve_batch, _lanes("l1", F32),
                             LOOPS.replace(precision="single",
                                           backend="inv"), {}),
        "batch_double_warm": (T.solve_batch, _lanes("box"), LOOPS.replace(
            precision="double", backend="chol"), "warm"),
        "batch_hybrid_cg": (T.solve_batch, _lanes("box"), LOOPS.replace(
            backend="cg", max_iter=100), {}),
    }
    fn, qp, s, kw = cases[name]
    if kw == "warm":
        kw = _warm(qp)
    elif kw == "solution":
        sol = T.solve(qp, s.replace(eps_abs=1e-10, eps_rel=1e-10))
        kw = dict(x0=sol.x, z0=sol.z, y0=sol.y)
    return fn, qp, s, kw


def _ref_of(fn):
    return ref._ref_solve if fn is T.solve else ref._ref_solve_batch


# ---------------------------------------------------------------- (a)

# (case, the (kind, variant) pairs its solve must run).
_FAKE = {
    "single_soc_f32": {("run_admm", admm.PROLOGUE), ("run_admm", "check"),
                       ("run_admm", admm.REFACTOR),
                       ("run_admm", admm.EPILOGUE)},
    "double_l1_inv": {("run_admm", admm.REFACTOR)},
    "l1_staged_rounds": {("recentered_rounds", api.SETUP),
                         ("recentered_rounds", api.JOIN),
                         ("recentered_rounds", api.FINAL),
                         ("polish", ("polish",))},
    "box_staged_polish": {("polish", ("polish",))},
    "soc_continuation": {("run_admm", admm.PROLOGUE),
                         ("polish", ("polish",))},
    "warm_start_staged": {("warm_check", api.WARM_CHECK)},
    "batch_hybrid": {("run_admm_lanes", admm.PROLOGUE),
                     ("run_admm_lanes", "check"),
                     ("run_admm_lanes", admm.REFACTOR),
                     ("run_admm_lanes", admm.EPILOGUE)},
    "batch_single_inv": {("run_admm_lanes", admm.REFACTOR)},
}


@pytest.mark.parametrize("case", sorted(_FAKE))
def test_segments_make_no_host_read(case, monkeypatch):
    """Each distinct segment of a real solve (the shared batch's aside),
    from the state it met, under FakeTensorMode: no host read, and every
    update keeps the shape and dtype of the real run's."""
    fn, qp, s, kw = _case(case)
    rec = _Segments(monkeypatch)
    fn(qp, s, **kw)
    seen = set()
    for kind, step, variant, state in rec.runs:
        # The shared batch's segments: tests/test_torch_graph_solve.py.
        if kind in ("run_admm_batch_shared", "solve_shared_recentered"):
            continue
        # One problem's and the lanes' checks: tests/test_torch_graph.py
        # runs every variant; here the first met.
        tag = (kind, "p1" in state, step.keywords.get("dtype"),
               "check" if graph.is_check(variant) else variant)
        if tag in seen:
            continue
        seen.add(tag)
        real = step(state, variant)
        mode = FakeTensorMode()
        fake_state = graph._map(mode.from_tensor, state)
        with mode:
            fake = step(fake_state, variant)
        got = dict(_leaves(fake))
        for path, t in _leaves(real):
            assert tuple(got[path].shape) == tuple(t.shape), (variant, path)
            assert got[path].dtype == t.dtype, (variant, path)
    want = _FAKE[case]
    assert want <= rec.met(), want - rec.met()


def test_the_hybrid_join_makes_no_host_read(monkeypatch):
    """`_solve_core`'s join: the second phase's prologue cleans the first
    phase's f32 iterates into f64, its epilogue joins the two phases
    (under FakeTensorMode above, through the batch); both ran."""
    fn, qp, s, kw = _case("batch_hybrid")
    rec = _Segments(monkeypatch)
    fn(qp, s, **kw)
    joined = [(step, variant, state) for kind, step, variant, state
              in rec.runs if kind == "run_admm_lanes" and "p1" in state
              and variant in (admm.PROLOGUE, admm.EPILOGUE)]
    assert [v for _, v, _ in joined] == [admm.PROLOGUE, admm.EPILOGUE]
    for step, variant, state in joined:
        assert state["x0"].dtype == F32
        mode = FakeTensorMode()
        with mode:
            out = step(graph._map(mode.from_tensor, state), variant)
        if variant == admm.EPILOGUE:
            assert out["out"]["x"].dtype == F64
            assert out["out"]["iters"].dtype == torch.int32


# ---------------------------------------------------------------- (b)

def _assert_bitwise(new, old):
    for f in dataclasses.fields(old):
        a, b = getattr(new, f.name), getattr(old, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


_BITWISE = ["box_hybrid", "single_soc_f32", "double_l1_inv",
            "double_box_cg", "l1_staged_rounds", "l1_staged_rounds_inv",
            "box_staged_polish", "soc_continuation", "warm_start_staged",
            "warm_start_solved", "batch_hybrid", "batch_single_inv",
            "batch_double_warm", "batch_hybrid_cg"]


@pytest.mark.parametrize("case", _BITWISE)
def test_solve_is_bitwise_the_frozen_solve(case):
    fn, qp, s, kw = _case(case)
    old = _ref_of(fn)(qp, s, **kw)
    new = fn(qp, s, **kw)
    _assert_bitwise(new, old)
    if case == "warm_start_solved":
        assert int(new.iters) == 0 and int(new.status) == 1


@pytest.mark.parametrize("case", ["single_soc_f32", "l1_staged_rounds",
                                  "soc_continuation", "warm_start_staged",
                                  "batch_hybrid", "batch_double_warm"])
def test_buffered_solve_is_the_frozen_solve(case, monkeypatch):
    """solve and solve_batch through static buffers, twice on one cache
    (the second solve on other data of the same shapes reuses every
    entry) and once more on the first data: each bitwise the frozen
    solve. Stale or aliased buffers would show here."""
    fn, qp, s, kw = _case(case)
    other = T.QPData(P=qp.P, q=qp.q * 0.9, A=qp.A, l=qp.l, u=qp.u,
                     lam=qp.lam, cone=qp.cone)
    want = [_ref_of(fn)(p, s, **kw) for p in (qp, other)]
    cache = _buffered(monkeypatch)
    for p, old in zip((qp, other, qp), want + want[:1]):
        _assert_bitwise(fn(p, s, **kw), old)
    assert len(cache.entries) >= 1 and cache.stats["replays"] > 0


# ---------------------------------------------------------------- (c)

@pytest.mark.parametrize("case", ["l1_staged_rounds", "soc_continuation",
                                  "batch_hybrid"])
def test_a_rerun_meets_the_same_keys(case, monkeypatch):
    """A solve on new data of the same shapes builds loops of the same
    keys, in the same order; every key is made of plain values."""
    fn, qp, s, kw = _case(case)
    other = T.QPData(P=qp.P, q=qp.q * 0.9, A=qp.A, l=qp.l, u=qp.u,
                     lam=qp.lam, cone=qp.cone)
    first = _keys(monkeypatch, lambda: fn(qp, s, **kw))
    again = _keys(monkeypatch, lambda: fn(qp, s, **kw))
    assert first == again
    assert len(set(first)) <= graph.CACHE_SIZE

    def plain(v):
        if isinstance(v, (tuple, list)):
            return all(plain(w) for w in v)
        return not isinstance(v, torch.Tensor)
    for key in first + _keys(monkeypatch, lambda: fn(other, s, **kw)):
        hash(key)
        assert plain(key)


def test_the_continuation_chunks_and_polish_share_their_keys(monkeypatch):
    """Every chunk of the f64 continuation replays one phase loop, and
    every polish between them one polish loop."""
    qp = _one("soc")
    z = lambda *shape: torch.zeros(shape, dtype=F64)  # noqa: E731
    start = T.Solution(x=z(qp.n), z=z(qp.m), y=z(qp.m),
                       status=torch.tensor(2, dtype=torch.int32),
                       iters=torch.tensor(0, dtype=torch.int32), r_prim=z(),
                       r_dual=z(), obj=z(), rho=z() + 0.1, history=z(0, 3))
    s = T.Settings(eps_abs=1e-14, eps_rel=1e-14, max_iter=75,
                   backend="chol")
    keys = _keys(monkeypatch, api._f64_continuation, qp, start, s, "chol",
                 25)
    chunks = [k for k in keys if k[0] == "run_admm"]
    polish = [k for k in keys if k[0] == "polish"]
    assert len(chunks) == 3 and len(set(chunks)) == 1
    assert len(polish) == 3 and len(set(polish)) == 1


# ---------------------------------------------------------------- (d)

def test_slice_matches_jax_on_a_small_cw_problem():
    """A small CW min-fuel LP (L1 rows: the staged path, its polish and
    rounds) through the JAX package's solve and the port's: the same
    status, iterations within one check (25), x within 1e-6 (the bar of
    tests/test_torch_staged.py::test_config3_full_size_matches_jax)."""
    import admm_library_tpu as J
    from test_torch_staged import _compare, _settings, _small_cw, _to_torch
    qpj = _small_cw()
    js, ts = _settings(backend="chol")
    jsol = J.solve(qpj, js)
    tsol = T.solve(_to_torch(qpj), ts)
    _compare(jsol, tsol)
    assert int(tsol.status) == int(T.Status.SOLVED)
