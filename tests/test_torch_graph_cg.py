"""The CG backends' loops as captured segments (admm_library_torch/
ops/kkt.py, core/admm.py, parallel/batch.py, core/graph.py) on the CPU.

- (a) `ops.kkt.cg_solve` in blocks of `_CG_CHECK` steps, each run while
  the stop flag before it says a lane is still above its tolerance
  (`graph.while_blocks`' plain form), is bitwise the one-loop CG that
  the phases ran before (`_ref_cg_solve` of
  tests/torch_loops_reference.py): f32 and f64, a shared and a per-lane
  operator, lanes that freeze at different steps, a zero right-hand
  side, a NaN one (alone, x stays 0), max_iter no multiple of 8, a lane
  that ends unconverged.
- (b) Every segment of `solve`, `solve_batch` and `solve_batch_shared`
  on 'cg' and 'pallas_cg' makes no host read: each runs under
  FakeTensorMode from the state it met in a real solve, where `.item()`,
  `float(t)`, `bool(t)` and `.tolist()` raise, its CGs traced as
  conditional nodes (`TraceNodes`, as a capture builds them). The
  prologue, every check variant, the refactor (on 'cg' the new rho
  vector only) and the epilogue.
- (c) Those solves through the capture path's static buffers
  (`_buffered`), their CGs as conditional nodes (`HostNodes`), twice on
  one cache (other data the second time) and once more on the first
  data, are bitwise the frozen host-code solves `_ref_solve`,
  `_ref_solve_batch` and `_ref_solve_batch_shared`, over restarts and
  rho refactors.
- (d) The capture rule: 'cg' and 'pallas_cg' are captured for these
  loops on a CUDA device; not on the CPU, not on a mesh axis of size
  > 1 (the consensus drivers' loops: tests/test_torch_graph_cond.py).
- (e) `solve` on 'cg' against the JAX package's `solve` on 'cg'.

The card's side (captured == capture-off bitwise, kernel 2 inside the
check graphs and counted at replays) is in tests/test_torch_gpu.py and
chip_smoke.py's phases solve, slice_pcg, solve_l1_soc and cg_paths.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import admm_library_torch as T
from admm_library_torch.core import admm, graph
from admm_library_torch.ops import kkt
from admm_library_torch.parallel import consensus, consensus_mc
from admm_library_torch.parallel.runtime import Mesh

import torch_loops_reference as ref
from test_torch_graph import (HostNodes, TraceNodes, _arrays, _qp,
                              install_nodes)
from test_torch_graph_api import LOOPS, _Segments, _lanes, _one
from test_torch_graph_solve import _buffered, _leaves, _raw_batch

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64


def _same_bits(a, b):
    """Bitwise equality, NaNs included (torch.equal calls NaN != NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    if a.dtype in ints:
        return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))
    return torch.equal(a, b)


# ---------------------------------------------------------------- (a)

N, M, B = 10, 14, 5


def _operator(dtype, lanes):
    """The 'cg' factor of a small P, A, rho: shared, or one per lane."""
    rng = np.random.default_rng(3)
    lead = (B,) if lanes else ()
    R = rng.standard_normal(lead + (N, N))
    P = R @ np.swapaxes(R, -1, -2) / N + 0.1 * np.eye(N)
    A = rng.standard_normal(lead + (M, N))
    rho = 0.1 + rng.random(lead + (M,))
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    return kkt.factor_condensed(t(P), t(A), 1e-6, t(rho), "cg")


def _rhs(fac, dtype, kind):
    """(B, n) right-hand sides. 'mixed': a random lane, a lane that is
    an image of one column of M (it converges in one step), a small
    random lane, a zero lane and a large random lane, so lanes freeze at
    different steps; 'nan': one lane of NaN alone; 'nan_mixed': a NaN
    lane beside live ones."""
    rng = np.random.default_rng(4)
    if kind == "nan":
        return torch.full((1, N), float("nan"), dtype=dtype)
    rhs = torch.as_tensor(rng.standard_normal((B, N)), dtype=dtype)
    e0 = torch.zeros((B, N), dtype=dtype)
    e0[:, 0] = 1.0
    rhs[1] = kkt._matvec_M(fac, e0)[1]
    rhs[2] *= 1e-3
    rhs[3] = 0.0
    rhs[4] *= 1e3
    if kind == "nan_mixed":
        rhs[3] = float("nan")
    return rhs


@pytest.mark.parametrize("tol,max_iter", [(1e-9, 200), (1e-12, 13),
                                          (1e-14, 3), (1e-9, 0)])
@pytest.mark.parametrize("kind", ["mixed", "nan", "nan_mixed"])
@pytest.mark.parametrize("lanes", [False, True])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_block_cg_is_the_frozen_cg(dtype, lanes, kind, tol, max_iter):
    """kkt.cg_solve (the blocks with their host reads, as the loops'
    segments run them) is bitwise the one-loop CG, in x and in the
    state its blocks reach; the blocks that run are the ones the
    one-loop CG's reads let run."""
    fac = _operator(dtype, lanes)
    rhs = _rhs(fac, dtype, kind)
    if lanes and kind == "nan":
        fac = {k: v[:1] if v.dim() else v for k, v in fac.items()}
    want = ref._ref_cg_solve(fac, rhs, tol=tol, max_iter=max_iter)
    got = kkt.cg_solve(fac, rhs, tol=tol, max_iter=max_iter)
    assert _same_bits(got, want)
    # The blocks one by one: each runs where the flag says so.
    cg = kkt.cg_start(fac, rhs, tol=tol)
    ran = 0
    for steps in kkt.cg_blocks(max_iter):
        if not kkt.cg_live(cg).item():
            break
        cg = kkt.cg_steps(fac, cg, steps)
        ran += steps
    assert _same_bits(cg["x"], want)
    assert sum(kkt.cg_blocks(max_iter)) == max_iter
    if kind == "nan":
        # No lane is live: no block runs and x stays exactly 0.
        assert ran == 0 and torch.equal(got, torch.zeros_like(got))
    if kind == "mixed" and max_iter:
        rs = (cg["r"] * cg["r"]).sum(-1)
        assert float(rs[3]) == 0.0           # the zero lane never moved
        if max_iter == 3:
            # Unconverged at max_iter: a lane still above its tolerance.
            assert bool((rs > cg["tol2"]).any())


@pytest.mark.parametrize("max_iter,want", [(200, [8] * 25), (13, [8, 5]),
                                           (3, [3]), (0, [])])
def test_cg_blocks(max_iter, want):
    assert kkt.cg_blocks(max_iter) == want


# ---------------------------------------------------------------- (b)

# cg_max_iter 11: blocks of 8 and 3 (f32 CG never reaches 1e-9, so
# every solve runs both).
CG = LOOPS.replace(backend="cg", cg_max_iter=11)
PCG = LOOPS.replace(backend="pallas_cg", cg_max_iter=11)
CHECKS = {(False, False), (False, True), (True, False), (True, True)}
PHASE = {admm.PROLOGUE, admm.REFACTOR, admm.EPILOGUE}


def _fake_case(name):
    """(solve function, problem, settings, loop kind, the variants that
    loop must meet)."""
    cases = {
        "solve_cg_f32": (T.solve, _one("soc", F32), CG.replace(
            precision="single"), "run_admm", PHASE | CHECKS),
        "solve_cg_f64": (T.solve, _one("l1"), CG.replace(
            precision="double"), "run_admm", PHASE | CHECKS),
        "solve_batch_cg": (T.solve_batch, _lanes("box", F32), CG.replace(
            precision="single"), "run_admm_lanes", PHASE | CHECKS),
        "shared_cg": (T.solve_batch_shared, _raw_batch("box", F32),
                      CG.replace(precision="single"),
                      "run_admm_batch_shared", PHASE | CHECKS),
        "solve_pcg_f32": (T.solve, _one("soc", F32), PCG.replace(
            precision="single"), "run_admm", PHASE | CHECKS),
        "shared_pcg": (T.solve_batch_shared, _raw_batch("l1"),
                       PCG.replace(precision="double"),
                       "run_admm_batch_shared", PHASE | CHECKS),
    }
    return cases[name]


@pytest.mark.parametrize("case", ["solve_cg_f32", "solve_cg_f64",
                                  "solve_batch_cg", "shared_cg",
                                  "solve_pcg_f32", "shared_pcg"])
def test_segments_make_no_host_read(case, monkeypatch):
    """Each distinct segment of a real solve on a CG backend, from the
    state it met, under FakeTensorMode: no host read, and every update
    keeps the shape and dtype of the real run's. On 'cg' each check
    traces check_every CGs, each a WHILE node of one 8-step block and an
    IF node of 3 steps."""
    fn, qp, s, kind, want = _fake_case(case)
    rec = _Segments(monkeypatch)
    fn(qp, s)
    seen = set()
    nodes = TraceNodes()
    for k, step, variant, state in rec.runs:
        if (k, variant) in seen:
            continue
        seen.add((k, variant))
        real = step(state, variant)
        mode = FakeTensorMode()
        fake_state = graph._map(mode.from_tensor, state)
        before = len(nodes.nodes)
        with monkeypatch.context() as m, mode:
            install_nodes(m, nodes)
            fake = step(fake_state, variant)
        if k == kind and graph.is_check(variant) and s.backend == "cg":
            assert nodes.nodes[before:] == [1, 1] * s.check_every
        got = dict(_leaves(fake))
        for path, t in _leaves(real):
            assert tuple(got[path].shape) == tuple(t.shape), (variant, path)
            assert got[path].dtype == t.dtype, (variant, path)
        if k == kind and variant == admm.REFACTOR and s.backend == "cg":
            # The matrix-free factor takes the new rho vector only.
            assert set(real["fac"]) == {"P", "A", "rho", "sigma"}
            for f in ("P", "A", "sigma"):
                assert real["fac"][f] is state["fac"][f]
    met = {v for k, _, v, _ in rec.runs if k == kind}
    assert want <= met, want - met


# ---------------------------------------------------------------- (c)

def _assert_bitwise(new, old):
    for f in dataclasses.fields(old):
        a, b = getattr(new, f.name), getattr(old, f.name)
        assert _same_bits(a, b), f.name


def _bitwise_case(name):
    """(solve, frozen solve, problem, settings)."""
    tight = dict(eps_abs=1e-9, eps_rel=1e-9)
    cases = {
        # The B=1 delegation: phase 1, rounds, f64 fallback.
        "solve_box_hybrid_cg": (T.solve, ref._ref_solve, _one("box"),
                                LOOPS.replace(backend="cg", **tight)),
        # The staged path: f32 phase, polish, rounds, f64 phase, polish.
        "solve_l1_staged_cg": (T.solve, ref._ref_solve, _one("l1"),
                               T.Settings(backend="cg", cg_max_iter=13,
                                          **tight)),
        "solve_soc_double_cg": (T.solve, ref._ref_solve, _one("soc"),
                                CG.replace(precision="double")),
        # Kernel 2's twin runs all cg_max_iter steps of every solve.
        "solve_box_hybrid_pcg": (T.solve, ref._ref_solve, _one("box"),
                                 PCG.replace(cg_max_iter=20, **tight)),
        "solve_l1_staged_pcg": (T.solve, ref._ref_solve, _one("l1"),
                                PCG.replace(cg_max_iter=20, **tight)),
        "solve_batch_hybrid_cg": (T.solve_batch, ref._ref_solve_batch,
                                  _lanes("soc"), CG),
        "shared_hybrid_cg": (T.solve_batch_shared,
                             ref._ref_solve_batch_shared, _raw_batch("soc"),
                             CG.replace(**tight)),
        "shared_single_pcg": (T.solve_batch_shared,
                              ref._ref_solve_batch_shared,
                              _raw_batch("box", F32),
                              PCG.replace(precision="single")),
    }
    return cases[name]


@pytest.mark.parametrize("case", ["solve_box_hybrid_cg",
                                  "solve_l1_staged_cg",
                                  "solve_soc_double_cg",
                                  "solve_box_hybrid_pcg",
                                  "solve_l1_staged_pcg",
                                  "solve_batch_hybrid_cg",
                                  "shared_hybrid_cg", "shared_single_pcg"])
def test_buffered_solve_is_the_frozen_solve(case, monkeypatch):
    """The solve through static buffers, twice on one cache (the second
    on other data of the same shapes reuses every entry) and once more
    on the first data: each bitwise the frozen solve. Its phases met a
    restart and a rho refactor."""
    fn, frozen, qp, s = _bitwise_case(case)
    lead = qp.P.shape[:-2]
    other = T.QPData(P=qp.P, q=qp.q * 0.9, A=qp.A, l=qp.l, u=qp.u,
                     lam=qp.lam, cone=qp.cone)
    want = [frozen(p, s) for p in (qp, other)]
    rec = _Segments(monkeypatch)
    cache = _buffered(monkeypatch)
    nodes = install_nodes(monkeypatch, HostNodes())
    for p, old in zip((qp, other, qp), want + want[:1]):
        _assert_bitwise(fn(p, s), old)
    assert len(cache.entries) >= 1 and cache.stats["replays"] > 0
    # The checks and refactors ran inside the phases' nodes.
    met = {v for _, _, v, _ in rec.runs} | set(nodes.segments)
    assert admm.REFACTOR in met
    assert any(graph.is_check(v) and v[0] for v in met)     # a restart
    # On 'cg' the checks' CGs ran as conditional nodes.
    assert (nodes.cg_passes > 0) == (s.backend == "cg")
    assert lead == qp.P.shape[:-2]


@pytest.mark.parametrize("backend", ["cg", "pallas_cg"])
def test_a_rerun_meets_every_entry_again(backend, monkeypatch):
    """A rerun of a solve on a CG backend finds every loop's entry in
    the cache: it adds none."""
    cache = _buffered(monkeypatch)
    qp = _one("l1")
    s = LOOPS.replace(backend=backend, eps_abs=1e-9, eps_rel=1e-9,
                      cg_max_iter=20)
    T.solve(qp, s)
    keys = list(cache.entries)
    T.solve(qp, s)
    assert list(cache.entries) == keys


# ---------------------------------------------------------------- (d)

def _mesh(data, horizon):
    return Mesh(shape={"data": data, "horizon": horizon},
                coords={"data": 0, "horizon": 0},
                groups={"data": None, "horizon": None},
                ranks={"data": [0], "horizon": [0]},
                world=data * horizon, device=torch.device("cpu"))


_SOLVE_LOOPS = ["run_admm", "run_admm_lanes", "run_admm_batch_shared",
                "solve_shared_recentered", "recentered_rounds", "polish",
                "warm_check"]


@pytest.mark.parametrize("kind", _SOLVE_LOOPS)
@pytest.mark.parametrize("backend", ["cg", "pallas_cg"])
def test_the_solve_loops_on_cg_backends_are_captured(backend, kind):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert graph.capturable(cuda, backend, None, kind)
    assert graph.capturable(cuda, backend, _mesh(1, 1), kind)
    assert not graph.capturable(cpu, backend, None, kind)
    assert not graph.capturable(cuda, backend, _mesh(2, 1), kind)
    assert not graph.capturable(cuda, backend, _mesh(1, 2), kind)


def _consensus_kinds(monkeypatch, settings):
    """The kinds of the loops that both consensus drivers build on the
    CPU for a rendezvous MPC of 8 steps in 2 blocks (4 scenarios for the
    Monte-Carlo driver)."""
    from admm_library_torch.models.partitioned import (
        partition_mpc, partition_mpc_from_s0, reference_s0)
    from admm_library_torch.parallel import runtime
    kinds = []
    real = graph.CheckLoop

    def spy(kind, *a, **kw):
        kinds.append(kind)
        return real(kind, *a, **kw)
    monkeypatch.setattr(graph, "CheckLoop", spy)
    s0 = np.array([1.0, -0.5, 0.3, 0.02, -0.01, 0.0])
    mesh = runtime.make_mesh(device="cpu")
    qp, spec, _ = partition_mpc(s0, np.zeros(6), N=8, n_blocks=2, dim=3,
                                dtype=F64, device="cpu")
    consensus.consensus_solve(qp, spec, mesh, settings)
    qp, spec, _, _ = partition_mpc_from_s0(
        reference_s0()[:4], s0, np.zeros(6), N=8, n_blocks=2, dim=3,
        dtype=F64, device="cpu")
    consensus_mc.consensus_solve_mc(qp, spec, mesh, settings)
    return kinds


def test_a_loop_on_cg_is_captured_only_with_an_admitted_kind():
    """Every loop kind is admitted on 'cg' now; on the CPU none is
    captured, and asking for a capture raises."""
    qp = _one("box")
    state = dict(x=qp.q.clone())
    for kind in ("run_consensus", "run_consensus_mc", "solve_rowsharded"):
        loop = graph.CheckLoop(kind, None, state, None, "cg")
        assert not loop.capture
        with pytest.raises(ValueError, match="not captured"):
            graph.CheckLoop(kind, None, state, None, "cg", capture=True)


# ---------------------------------------------------------------- (e)

def test_solve_on_cg_matches_jax():
    """A small box problem through the JAX package's solve and the
    port's, both on 'cg' in f64: the same status, iterations within one
    check, x within tests/test_torch_cg.py's f64 bar (1e-8)."""
    import jax.numpy as jnp
    import admm_library_tpu as J
    arrays, cone = _arrays("box", 0)
    s = dict(backend="cg", precision="double", eps_abs=1e-8, eps_rel=1e-8)
    jqp = J.QPData(**{k: jnp.asarray(v, jnp.float64)
                      for k, v in arrays.items()},
                   cone=J.ConeSpec(m_box=cone.m_box))
    jsol = J.solve(jqp, J.Settings(**s))
    tsol = T.solve(_qp(arrays, cone, F64), T.Settings(**s))
    assert int(tsol.status) == int(jsol.status) == int(T.Status.SOLVED)
    assert abs(int(tsol.iters) - int(jsol.iters)) <= T.Settings().check_every
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x),
                               atol=1e-8)
