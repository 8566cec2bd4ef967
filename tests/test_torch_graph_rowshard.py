"""The row-sharded loop on core/graph.CheckLoop, on the CPU:
`parallel.rowshard.solve_rowsharded` and `solve_rowsharded_hybrid`.

- Both are bitwise the plain loop of tests/torch_loops_reference.py
  (`_ref_solve_rowsharded` with `_ref_cg_rowsharded`: host counters,
  rebinding, a host read every ops/kkt._CG_CHECK CG steps) in x, z, y,
  status, iterations, CG steps, residuals and rho: box, mixed-cone and
  interleaved rows, a warm start, primal and dual infeasibility
  certificates, restart and adaptive-rho boundaries, f32 and f64, and a
  CG cut at 200, 13 and 3 steps (a short last block).
- The cache key holds plain values: two solves on freshly built 1-rank
  meshes map to one entry; the hybrid's phase 1 and its rounds to two.
- On the CPU, and on a data axis of more than one rank, the loop is
  never captured, and the plain version holds the caller's tensors.

The steps make no host read: tests/test_torch_graph.py runs every
rowshard check under FakeTensorMode, its CGs traced as conditional
nodes; tests/test_torch_graph_cond.py holds the loop with its CGs as
nodes (read on the host as the card would) to the plain loop. No JAX here: the JAX parity
stays with tests/test_torch_rowshard.py. Small shapes (n ≤ 32).
"""
import numpy as np
import pytest
import torch

from admm_library_torch import ConeSpec, Settings, Status, qp_from_numpy
from admm_library_torch.core import graph
from admm_library_torch.parallel import rowshard, runtime
from admm_library_torch.parallel.batch import make_data_mesh

import torch_loops_reference as ref
from test_torch_graph import _Recorder
from test_torch_graph_partitioned import _assert_bitwise

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64

# Restart every 3 checks, rho test every 2, rho far off: restarts and
# rho updates within the first checks.
LOOP = Settings(check_every=5, adaptive_rho_interval=10, restart_every=15,
                rho=0.01, eps_abs=1e-7, eps_rel=1e-7, precision="single",
                max_iter=3000)


def _mesh(ndev=1, rank=0):
    """A data mesh of `ndev` ranks seen from `rank`, in one process: a
    collective is the identity, so a rank solves the problem of its own
    rows; beyond one rank the rows are interleaved."""
    if ndev == 1:
        return make_data_mesh(device="cpu")
    return runtime.Mesh(shape={"data": ndev, "horizon": 1},
                        coords={"data": rank, "horizon": 0},
                        groups={"data": None, "horizon": None},
                        ranks={"data": tuple(range(ndev)), "horizon": (0,)},
                        world=1, device=torch.device("cpu"))


def _box(dtype, seed=21, n=32, m=64):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    Ax = A @ rng.standard_normal(n)
    spread = np.abs(rng.standard_normal(m)) + 0.1
    l, u = Ax - spread, Ax + spread
    l[:4] = u[:4] = Ax[:4]                      # equality rows
    return qp_from_numpy(dict(P=R @ R.T + 0.1 * np.eye(n),
                              q=rng.standard_normal(n), A=A, l=l, u=u,
                              lam=np.zeros(0)),
                         ConeSpec(m_box=m), device="cpu", dtype=dtype)


def _mixed(dtype, seed=5):
    """Box, L1 and SOC(3) rows: 16 + 8 + 4 blocks of 3, n = 24."""
    rng = np.random.default_rng(seed)
    n, mb, ml, d, nb = 24, 16, 8, 3, 4
    m = mb + ml + d * nb
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    l = np.full(m, -np.inf)
    u = np.full(m, np.inf)
    l[:mb], u[:mb] = -1.0 - rng.random(mb), 1.0 + rng.random(mb)
    l[mb:mb + ml], u[mb:mb + ml] = -2.0, 2.0
    return qp_from_numpy(dict(P=R @ R.T + 0.1 * np.eye(n),
                              q=rng.standard_normal(n),
                              A=rng.standard_normal((m, n)) / np.sqrt(n),
                              l=l, u=u, lam=0.1 + rng.random(ml)),
                         ConeSpec(m_box=mb, m_l1=ml, soc_dims=(d,) * nb),
                         device="cpu", dtype=dtype)


def _primal_infeasible(dtype):
    n = 8
    rows = np.random.default_rng(3).standard_normal((8, n))
    # Rows i and i+8 share a'x but demand a'x <= -1 and a'x >= 1.
    l = np.concatenate([np.full(8, -np.inf), np.full(8, 1.0)])
    u = np.concatenate([np.full(8, -1.0), np.full(8, np.inf)])
    return qp_from_numpy(dict(P=np.eye(n), q=np.zeros(n),
                              A=np.vstack([rows, rows]), l=l, u=u,
                              lam=np.zeros(0)),
                         ConeSpec(m_box=16), device="cpu", dtype=dtype)


def _dual_infeasible(dtype):
    n, m = 8, 16
    A = np.eye(m, n)
    A[8:] = np.eye(8, n)
    return qp_from_numpy(dict(P=np.zeros((n, n)), q=-np.ones(n), A=A,
                              l=np.zeros(m), u=np.full(m, np.inf),
                              lam=np.zeros(0)),
                         ConeSpec(m_box=m), device="cpu", dtype=dtype)


# (problem, dtype, settings, mesh (ranks, rank), expected status)
_CASES = {
    "box_f64": (_box, F64, {}, (1, 0), Status.SOLVED),
    "box_f32": (_box, F32, dict(eps_abs=1e-4, eps_rel=1e-4), (1, 0),
                Status.SOLVED),
    "box_f64_cg13": (_box, F64, dict(cg_max_iter=13, max_iter=600), (1, 0),
                     None),
    "box_f64_cg3": (_box, F64, dict(cg_max_iter=3, max_iter=600), (1, 0),
                    None),
    "box_f64_no_restart_no_adaptive": (
        _box, F64, dict(restart_every=0, adaptive_rho=False, max_iter=300),
        (1, 0), None),
    "mixed_f64": (_mixed, F64, dict(max_iter=6000), (1, 0), Status.SOLVED),
    "mixed_f64_cg13": (_mixed, F64, dict(cg_max_iter=13, max_iter=600),
                       (1, 0), None),
    "mixed_interleaved_rank0": (_mixed, F64, dict(max_iter=600), (2, 0),
                                None),
    "mixed_interleaved_rank1": (_mixed, F64, dict(max_iter=600), (2, 1),
                                None),
    "primal_infeasible": (_primal_infeasible, F64, {}, (1, 0),
                          Status.PRIMAL_INFEASIBLE),
    "dual_infeasible": (_dual_infeasible, F64, {}, (1, 0),
                        Status.DUAL_INFEASIBLE),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_solve_rowsharded_is_bitwise_the_plain_loop(case, monkeypatch):
    make, dtype, kw, (ndev, rank), expect = _CASES[case]
    qp, s = make(dtype), LOOP.replace(**kw)
    if ndev > 1:
        # One process holds one rank's rows: the gather repeats them, so
        # that the rows' un-permutation runs.
        monkeypatch.setattr(runtime, "all_gather",
                            lambda v, mesh, axis: torch.cat([v] * ndev))
    new = rowshard.solve_rowsharded(qp, _mesh(ndev, rank), s)
    old = ref._ref_solve_rowsharded(qp, _mesh(ndev, rank), s)
    _assert_bitwise(new, old)
    assert bool(torch.isfinite(new.x).all())
    if expect is not None:
        assert int(new.status) == int(expect)
    if expect == Status.SOLVED:
        assert int(new.iters) >= 2 * s.restart_every      # restarts ran
        assert float(new.rho) != s.rho                    # rho adapted
    if "cg_max_iter" in kw:
        # The CG stops at its cap: a short last block ran.
        assert int(new.cg_steps) == int(new.iters) * s.cg_max_iter


def test_warm_start_is_bitwise_the_plain_loop():
    qp, mesh = _box(F64), _mesh()
    cold = ref._ref_solve_rowsharded(qp, mesh, LOOP.replace(max_iter=100))
    s = LOOP.replace(rho=float(cold.rho))
    new = rowshard.solve_rowsharded(qp, mesh, s, x0=cold.x, z0=cold.z,
                                    y0=cold.y)
    old = ref._ref_solve_rowsharded(qp, mesh, s, x0=cold.x, z0=cold.z,
                                    y0=cold.y)
    _assert_bitwise(new, old)
    assert int(new.status) == int(Status.SOLVED)


@pytest.mark.parametrize("max_iter", [25, 200],
                         ids=["two_rounds", "one_round"])
def test_solve_rowsharded_hybrid_is_bitwise_the_plain_loop(max_iter,
                                                           monkeypatch):
    """The hybrid path on f32 data: phase 1 (cut at max_iter) and the
    re-centred rounds."""
    qp = _box(F32).astype(F64)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=max_iter)
    new = rowshard.solve_rowsharded_hybrid(qp, _mesh(), s)
    with monkeypatch.context() as m:
        m.setattr(rowshard, "solve_rowsharded", ref._ref_solve_rowsharded)
        old = rowshard.solve_rowsharded_hybrid(qp, _mesh(), s)
    _assert_bitwise(new, old)
    assert int(new.status) == int(Status.SOLVED)


def test_fresh_meshes_map_to_one_cache_entry(monkeypatch):
    """Two hybrid solves, each on a freshly built 1-rank mesh: every
    loop's key is equal and hashable; phase 1 and the rounds (their
    certificates off) are two keys."""
    qp = _box(F32).astype(F64)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=25)
    keys = []
    for _ in range(2):
        rec = _Recorder(monkeypatch)
        rowshard.solve_rowsharded_hybrid(qp, make_data_mesh(device="cpu"),
                                         s)
        keys.append([key for _, _, _, key in rec.loops])
    assert keys[0] == keys[1] and len(keys[0]) >= 3
    cache = graph.CheckCache()
    for key in keys[0] + keys[1]:
        cache.entry(key, None, {"x": torch.zeros(1)})
    assert len(cache.entries) == 2
    assert keys[0][0] != keys[0][1] and len(set(keys[0][1:])) == 1


def test_the_key_splits_on_the_settings_a_segment_reads(monkeypatch):
    """max_iter is read by the host only; cg_tol by the CG's head."""
    qp = _box(F64)
    rec = _Recorder(monkeypatch)
    for kw in (dict(max_iter=5), dict(max_iter=10),
               dict(max_iter=5, cg_tol=1e-7)):
        rowshard.solve_rowsharded(qp, _mesh(), LOOP.replace(**kw))
    k = [key for _, _, _, key in rec.loops]
    assert k[0] == k[1] != k[2]


@pytest.mark.parametrize("ndev", [1, 2])
def test_a_rowshard_loop_on_the_cpu_or_a_wide_axis_is_never_captured(
        ndev, monkeypatch):
    qp = _box(F64)
    monkeypatch.setattr(runtime, "all_gather",
                        lambda v, mesh, axis: torch.cat([v] * ndev))
    rec = _Recorder(monkeypatch)
    rowshard.solve_rowsharded(qp, _mesh(ndev), LOOP.replace(max_iter=0))
    (kind, step, state, _), = rec.loops
    assert kind == "solve_rowsharded"
    loop = graph.CheckLoop(kind, step, state, LOOP, rowshard.BACKEND,
                           mesh=_mesh(ndev))
    assert not loop.capture
    # The plain version holds the caller's tensors; nothing is cloned.
    assert loop.state["A_loc"] is state["A_loc"]
    with pytest.raises(ValueError, match="not captured"):
        graph.CheckLoop(kind, step, state, LOOP, rowshard.BACKEND,
                        mesh=_mesh(ndev), capture=True)
    wide = _mesh(2)
    assert not graph.capturable(torch.device("cuda"), rowshard.BACKEND,
                                wide)
    assert graph.capturable(torch.device("cuda"), rowshard.BACKEND,
                            _mesh(1))
