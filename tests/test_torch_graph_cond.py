"""The CG's loop test on the device (core/graph.py `while_blocks`,
csrc/graph_cond.cu) on the CPU.

- (a) `graph.while_blocks`' plain form (a host read of the flag before
  each block) runs exactly the blocks that a host loop runs: a budget
  that is a multiple of the block and one that is not (13 = 8 + 5), a
  short one (3), none, a frozen start, and an all-NaN right-hand side
  (no block, x = 0). Its captured form, run here by `HostNodes` (each
  node read on the host as the card would), is bitwise the plain form
  and builds a WHILE node for each run of equal blocks and an IF node
  for a run of one.
- (b) `ops.kkt.cg_solve` on seeded numpy data against the JAX package's
  `cg_solve` (f64: x within 1e-10).
- (c) `solve`, `solve_batch` and `solve_batch_shared` on 'cg', their
  CGs as conditional nodes (`HostNodes`) through the capture path's
  static buffers, bitwise the frozen host code of
  tests/torch_loops_reference.py.
- (d) `consensus_solve` and `consensus_solve_mc` on 'cg' the same way,
  bitwise their plain (eager) loops, and at the JAX package's
  iterations; their loops are now captured on the card; the row-sharded
  loop's CGs are conditional nodes too.

The card's side (the nodes replayed against the plain loop, a failed
body raising, captured solves bitwise the capture-off ones) is in
tests/test_torch_gpu.py and chip_smoke.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import admm_library_torch as T
from admm_library_torch.core import graph
from admm_library_torch.ops import kkt
from admm_library_torch.parallel import consensus, consensus_mc, rowshard
from admm_library_torch.parallel import runtime

import torch_loops_reference as ref
from test_torch_graph import HostNodes, TraceNodes, install_nodes
from test_torch_graph_api import LOOPS, _lanes, _one
from test_torch_graph_solve import _buffered, _raw_batch

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64


def _same_bits(a, b):
    """Bitwise equality, NaNs included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    if a.dtype in ints:
        return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))
    return torch.equal(a, b)


# ---------------------------------------------------------------- (a)

def _counter_loop(limit, start=0):
    """A loop of unit-valued blocks: each block adds its steps to 'n'
    and appends to a log; the flag is n < limit."""
    log = []

    def body(c, steps):
        log.append(steps)
        return dict(n=c["n"] + steps)
    carry = dict(n=torch.tensor(start), k=torch.tensor(limit))
    return carry, (lambda c: c["n"] < c["k"]), body, log


def _host_loop(blocks, limit, start=0):
    """The blocks a host loop runs: each while n < limit before it."""
    n, ran = start, []
    for steps in blocks:
        if not n < limit:
            break
        n += steps
        ran.append(steps)
    return ran


@pytest.mark.parametrize("max_iter,want_nodes", [
    (200, [25]), (13, [1, 1]), (3, [1]), (0, [])])
@pytest.mark.parametrize("limit", [0, 5, 16, 1000])
def test_while_blocks_runs_the_blocks_of_the_host_loop(max_iter, want_nodes,
                                                       limit, monkeypatch):
    blocks = kkt.cg_blocks(max_iter)
    want = _host_loop(blocks, limit)
    carry, live, body, log = _counter_loop(limit)
    out = graph.while_blocks(carry, live, body, blocks)
    assert log == want and int(out["n"]) == sum(want)
    # The captured form: one node a run of equal blocks, the carry
    # copied and written in place.
    nodes = install_nodes(monkeypatch, HostNodes())
    carry, live, body, log = _counter_loop(limit)
    out = graph.while_blocks(carry, live, body, blocks)
    assert log == want and int(out["n"]) == sum(want)
    assert nodes.nodes == want_nodes and nodes.passes == len(want)
    assert out["n"] is not carry["n"]            # a copy, never the input
    assert int(carry["n"]) == 0


def test_while_blocks_traced_reads_nothing(monkeypatch):
    """The captured form under FakeTensorMode with every body traced
    once (as a capture does): no host read."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    nodes = install_nodes(monkeypatch, TraceNodes())
    mode = FakeTensorMode()
    with mode:
        carry = dict(n=torch.zeros((), dtype=torch.int64),
                     k=torch.full((), 7, dtype=torch.int64))
        out = graph.while_blocks(carry, lambda c: c["n"] < c["k"],
                                 lambda c, s: dict(n=c["n"] + s),
                                 kkt.cg_blocks(13))
    assert nodes.nodes == [1, 1] and tuple(out["n"].shape) == ()


N, M, B = 10, 14, 4


def _operator(dtype=F64, seed=3):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((N, N))
    P = R @ R.T / N + 0.1 * np.eye(N)
    A = rng.standard_normal((M, N))
    rho = 0.1 + rng.random(M)
    return P, A, rho


def _fac(P, A, rho, dtype=F64):
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    return kkt.factor_condensed(t(P), t(A), 1e-6, t(rho), "cg")


@pytest.mark.parametrize("case", ["frozen_start", "all_nan"])
@pytest.mark.parametrize("nodes", [False, True])
def test_cg_solve_runs_no_block_where_no_lane_is_live(case, nodes,
                                                      monkeypatch):
    """A zero right-hand side is frozen from the start, and a NaN one
    counts as frozen: no block runs and x stays exactly 0, in the plain
    form and in the captured one."""
    P, A, rho = _operator()
    fac = _fac(P, A, rho)
    rhs = (torch.zeros((B, N), dtype=F64) if case == "frozen_start" else
           torch.full((B, N), float("nan"), dtype=F64))
    calls = []
    real = kkt.cg_steps
    monkeypatch.setattr(kkt, "cg_steps",
                        lambda *a: calls.append(a[2]) or real(*a))
    if nodes:
        built = install_nodes(monkeypatch, HostNodes())
    x = kkt.cg_solve(fac, rhs, tol=1e-9, max_iter=13)
    assert calls == [] and torch.equal(x, torch.zeros_like(x))
    if nodes:
        assert built.nodes == [1, 1] and built.passes == 0


@pytest.mark.parametrize("max_iter", [200, 13, 3])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_cg_solve_nodes_are_the_frozen_cg(dtype, max_iter, monkeypatch):
    """kkt.cg_solve's captured form (HostNodes) is bitwise the frozen
    one-loop CG: lanes that freeze at different steps and a NaN lane."""
    P, A, rho = _operator()
    fac = _fac(P, A, rho, dtype)
    rng = np.random.default_rng(4)
    rhs = torch.as_tensor(rng.standard_normal((B, N)), dtype=dtype)
    rhs[1] *= 1e-3
    rhs[2] = float("nan")
    want = ref._ref_cg_solve(fac, rhs, tol=1e-9, max_iter=max_iter)
    install_nodes(monkeypatch, HostNodes())
    assert _same_bits(kkt.cg_solve(fac, rhs, tol=1e-9, max_iter=max_iter),
                      want)


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("max_iter,tol", [(200, 1e-9), (13, 1e-12)])
def test_cg_solve_matches_jax(max_iter, tol):
    """The port's cg_solve and the JAX package's on the same f64 data: x
    within 1e-10 (both run the same steps; a frozen lane takes alpha 0)."""
    import jax.numpy as jnp
    from admm_library_tpu.ops import kkt as jkkt
    P, A, rho = _operator(seed=11)
    rng = np.random.default_rng(12)
    rhs = rng.standard_normal((B, N))
    rhs[3] *= 1e-4
    jfac = {"P": jnp.asarray(P), "A": jnp.asarray(A),
            "rho": jnp.asarray(rho), "sigma": jnp.asarray(1e-6)}
    want = np.asarray(jkkt.cg_solve(jfac, jnp.asarray(rhs), tol=tol,
                                    max_iter=max_iter))
    got = kkt.cg_solve(_fac(P, A, rho), torch.as_tensor(rhs), tol=tol,
                       max_iter=max_iter)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


# ---------------------------------------------------------------- (c)

def _assert_bitwise(new, old):
    fields = (old._fields if hasattr(old, "_fields")
              else [f.name for f in dataclasses.fields(old)])
    for f in fields:
        a, b = getattr(new, f), getattr(old, f)
        if isinstance(a, torch.Tensor):
            assert _same_bits(a, b), f
        else:
            assert a == b, f


# cg_max_iter 13: each CG a WHILE node of 8-step blocks and an IF node
# of 5 steps; 3: an IF node alone.
_SOLVES = {
    "solve_box_hybrid_13": (T.solve, ref._ref_solve, lambda: _one("box"),
                            LOOPS.replace(backend="cg", cg_max_iter=13,
                                          eps_abs=1e-9, eps_rel=1e-9)),
    "solve_l1_staged_3": (T.solve, ref._ref_solve, lambda: _one("l1"),
                          T.Settings(backend="cg", cg_max_iter=3)),
    "solve_batch_soc_13": (T.solve_batch, ref._ref_solve_batch,
                           lambda: _lanes("soc"),
                           LOOPS.replace(backend="cg", cg_max_iter=13)),
    "shared_box_f32_13": (T.solve_batch_shared,
                          ref._ref_solve_batch_shared,
                          lambda: _raw_batch("box", F32),
                          LOOPS.replace(backend="cg", cg_max_iter=13,
                                        precision="single")),
}


@pytest.mark.parametrize("case", sorted(_SOLVES))
def test_solves_with_cg_nodes_are_the_frozen_solves(case, monkeypatch):
    """The solve through static buffers with its CGs as conditional
    nodes (HostNodes), twice on one cache: bitwise the frozen host-code
    solve each time, and the nodes ran."""
    fn, frozen, make, s = _SOLVES[case]
    qp = make()
    want = frozen(qp, s)
    cache = _buffered(monkeypatch)
    nodes = install_nodes(monkeypatch, HostNodes())
    for _ in range(2):
        _assert_bitwise(fn(qp, s), want)
    assert cache.stats["replays"] > 0
    # Each CG: a WHILE node of one 8-step block and an IF node of 5
    # steps (13), or an IF node of 3 steps.
    per_cg = [c for _, c in graph._runs(kkt.cg_blocks(s.cg_max_iter))]
    cg = nodes.cg_nodes()
    assert cg == per_cg * (len(cg) // len(per_cg))
    assert cg and nodes.cg_passes > 0


# ---------------------------------------------------------------- (d)

S0 = np.array([1.0, -2.0, 0.3, -0.1])
TOL = dict(eps_abs=1e-7, eps_rel=1e-7, max_iter=20000)


def _mpc(N=8, n_blocks=4):
    from admm_library_torch.models.partitioned import partition_mpc
    return partition_mpc(S0, np.zeros(4), N=N, n_blocks=n_blocks, dim=2,
                         u_max=2.0, dtype=F64, device="cpu")


def _mc(batch=3):
    from admm_library_torch.models.partitioned import partition_mpc_mc
    qp, spec, _, _ = partition_mpc_mc(
        torch.Generator().manual_seed(1), batch, S0, np.zeros(4), N=8,
        n_blocks=4, dim=2, u_max=2.0, dtype=F64, device="cpu")
    return qp, spec


@pytest.mark.parametrize("precision", ["hybrid", "double"])
@pytest.mark.parametrize("driver", ["consensus", "consensus_mc"])
def test_consensus_on_cg_nodes_is_the_eager_solve(driver, precision,
                                                  monkeypatch):
    """consensus_solve and consensus_solve_mc on 'cg' through static
    buffers with their CGs as conditional nodes: bitwise the plain loop
    (the eager path), through rho updates."""
    s = T.Settings(backend="cg", precision=precision, **TOL)
    if driver == "consensus":
        qp, spec, _ = _mpc()
        fn = consensus.consensus_solve
    else:
        qp, spec = _mc()
        fn = consensus_mc.consensus_solve_mc
    mesh = runtime.make_mesh(device="cpu")
    want = fn(qp, spec, mesh, s)
    assert (want.status == int(T.Status.SOLVED)).all()
    kinds = []
    real = graph.CheckLoop

    def spy(kind, *a, **kw):
        kinds.append(kind)
        return real(kind, *a, **kw)
    monkeypatch.setattr(graph, "CheckLoop", spy)
    _buffered(monkeypatch)
    nodes = install_nodes(monkeypatch, HostNodes())
    _assert_bitwise(fn(qp, spec, mesh, s), want)
    assert {"run_" + driver} <= set(kinds) and nodes.cg_passes > 0
    assert float(want.rho.max()) != s.rho                  # rho moved


@pytest.mark.parametrize("driver", ["consensus", "consensus_mc"])
def test_consensus_on_cg_takes_the_jax_iterations(driver):
    """The port on 'cg' at the JAX package's iteration counts, on JAX's
    8-device horizon mesh (2x4 for the Monte-Carlo driver): f64, where
    both CGs meet their tolerance."""
    import jax
    import jax.numpy as jnp
    from admm_library_tpu import Settings as JSettings
    from admm_library_tpu.models.partitioned import (
        partition_mpc as jpartition_mpc, partition_mpc_mc as jpartition_mc)
    from admm_library_tpu.parallel import runtime as jruntime
    from admm_library_tpu.parallel.batch import make_data_mesh
    from admm_library_tpu.parallel.consensus import (
        consensus_solve as jconsensus_solve)
    from admm_library_tpu.parallel.consensus_mc import (
        consensus_solve_mc as jconsensus_solve_mc)
    from admm_library_torch.models.partitioned import partition_mpc_from_s0
    s = dict(backend="cg", precision="double", **TOL)
    mesh = runtime.make_mesh(device="cpu")
    if driver == "consensus":
        jqp, jspec, _ = jpartition_mpc(S0, np.zeros(4), N=16, n_blocks=8,
                                       dim=2, u_max=2.0, dtype=jnp.float64)
        jsol = jconsensus_solve(jqp, jspec,
                                make_data_mesh(8, axis="horizon"),
                                JSettings(**s))
        qp, spec, _ = _mpc(N=16, n_blocks=8)
        sol = consensus.consensus_solve(qp, spec, mesh, T.Settings(**s))
    else:
        jqp, jspec, _, s0s = jpartition_mc(jax.random.key(0), 4, S0,
                                           np.zeros(4), N=8, n_blocks=4,
                                           dim=2, dtype=jnp.float64,
                                           u_max=2.0)
        jsol = jconsensus_solve_mc(jqp, jspec,
                                   jruntime.make_mesh(data=2, horizon=4),
                                   JSettings(**s))
        qp, spec, _, _ = partition_mpc_from_s0(
            np.asarray(s0s), S0, np.zeros(4), N=8, n_blocks=4, dim=2,
            u_max=2.0, dtype=F64, device="cpu")
        sol = consensus_mc.consensus_solve_mc(qp, spec, mesh,
                                              T.Settings(**s))
    np.testing.assert_array_equal(sol.status.numpy(),
                                  np.asarray(jsol.status))
    assert (sol.status == int(T.Status.SOLVED)).all()
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(jsol.iters))
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(jsol.x),
                               atol=1e-6)


def _kinds(monkeypatch):
    from test_torch_graph_cg import _consensus_kinds
    return _consensus_kinds(monkeypatch, T.Settings(
        backend="cg", precision="single", max_iter=10, check_every=5))


def test_the_consensus_loops_on_cg_are_captured(monkeypatch):
    """The consensus drivers' loops on 'cg' are captured on the card
    like those on a dense backend (their CGs are conditional nodes); a
    mesh axis of two ranks stays eager."""
    from test_torch_graph_cg import _mesh
    kinds = _kinds(monkeypatch)
    assert {"run_consensus", "run_consensus_mc"} <= set(kinds)
    for kind in kinds:
        assert graph.capturable(torch.device("cuda"), "cg", None, kind)
        assert graph.capturable(torch.device("cuda"), "cg", _mesh(1, 1),
                                kind)
        assert not graph.capturable(torch.device("cuda"), "cg",
                                    _mesh(1, 2), kind)


@pytest.mark.parametrize("max_iter", [200, 13, 3, 0])
def test_rowshard_cgs_are_nodes_of_its_check(max_iter, monkeypatch):
    """A row-sharded solve with its CGs as conditional nodes (HostNodes)
    through static buffers: bitwise the frozen plain loop (a host read
    every 8 CG steps), each x-update a WHILE node of 8-step blocks and an
    IF node of the rest."""
    from test_torch_graph_rowshard import LOOP, _box, _mesh
    qp = _box(F64)
    s = LOOP.replace(cg_max_iter=max_iter, max_iter=60)
    want = ref._ref_solve_rowsharded(qp, _mesh(), s)
    _buffered(monkeypatch)
    nodes = install_nodes(monkeypatch, HostNodes())
    _assert_bitwise(rowshard.solve_rowsharded(qp, _mesh(), s), want)
    per_cg = [c for _, c in graph._runs(kkt.cg_blocks(max_iter))]
    cg = nodes.cg_nodes()
    assert cg == per_cg * (len(cg) // max(len(per_cg), 1))
    assert (len(cg) > 0) == (max_iter > 0)
