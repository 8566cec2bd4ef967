"""The data-axis batch, the row-sharded driver and the horizon-sharded
SPIKE driver on gloo CPU ranks, against the same calls in one process.

Each mesh spawns its ranks once (a module fixture), as
tests/test_torch_runtime.py does: rendezvous through a file:// store
under the test's tmp dir, and a time limit per spawn, so a deadlock
kills the ranks and fails the tests instead of hanging the suite. No
JAX here, so the spawned ranks do not load it.

Meshes: 2 ranks as data 2 (rowshard, the batch); 4 ranks as data 4
(rowshard, which interleaves mixed-cone rows over the shards) and as
data 2 × horizon 2 (the horizon driver).

Tolerances. Splitting a sum over ranks rounds it differently (the row
shards' products, the shared rho's geometric mean over the data axis):
f64 solves are held to the same statuses and iterations and x within
1e-10. Solves with an f32 phase are held to the same statuses,
iterations within one check interval (25), and x within the scale their
own stopping test leaves open: 1e-6 for the batch's hybrid pipeline (as
the consensus drivers' f32 phase in test_torch_runtime.py), 1e-5 for
the row-sharded hybrid (its rounds stop at the first point within the
1e-6 mixed criterion, and λmin(P) = 0.1), 1e-4 for the plain f32 horizon
solve at eps 1e-4 (an ulp of its shared rho moves the f32 iterates).
"""
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from admm_library_torch import ConeSpec, Settings, Status, qp_from_numpy
from admm_library_torch.models import monte_carlo as mc
from admm_library_torch.parallel import runtime
from admm_library_torch.parallel.batch import (make_data_mesh, shard_batch,
                                               solve_batch_shared)
from admm_library_torch.parallel.horizon import (mpc_row_time, partition_qp,
                                                 solve_horizon_sharded)
from admm_library_torch.parallel.rowshard import (solve_rowsharded,
                                                  solve_rowsharded_hybrid)

torch.set_num_threads(1)

SPAWN_LIMIT_S = 150.0
F64 = torch.float64
X_F64 = 1e-10
CHECK = 25
# (iterations slack, x tolerance) of the cases with an f32 phase.
F32_BARS = {"rs_hybrid": (CHECK, 1e-5), "batch_hybrid": (CHECK, 1e-6),
            "hz_single": (CHECK, 1e-4)}
FIELDS = ("x", "z", "status", "iters")


def _box_soc():
    """Box rows then 8 SOC(4) blocks: over 2 or 4 shards the rows are
    interleaved."""
    rng = np.random.default_rng(7)
    n, m_box, nsoc, d = 24, 16, 8, 4
    A = rng.standard_normal((m_box + nsoc * d, n)) * 0.5
    l = np.concatenate([np.full(m_box, -3.0), np.full(nsoc * d, -np.inf)])
    u = np.concatenate([np.full(m_box, 3.0), np.full(nsoc * d, np.inf)])
    return qp_from_numpy(dict(P=np.eye(n), q=rng.standard_normal(n), A=A,
                              l=l, u=u, lam=np.zeros(0)),
                         ConeSpec(m_box=m_box, soc_dims=(d,) * nsoc),
                         device="cpu")


def _box_l1():
    rng = np.random.default_rng(5)
    n, m_box, m_l1 = 24, 32, 16
    A = rng.standard_normal((m_box + m_l1, n))
    l = np.concatenate([np.full(m_box, -2.0), np.full(m_l1, -np.inf)])
    return qp_from_numpy(dict(P=np.eye(n) * 0.5, q=rng.standard_normal(n),
                              A=A, l=l, u=-l, lam=np.full(m_l1, 0.3)),
                         ConeSpec(m_box=m_box, m_l1=m_l1), device="cpu")


def _box_f32():
    """f32 data with f64 outputs: the hybrid path solves in f32 and
    accumulates in f64, so x is compared without output rounding."""
    rng = np.random.default_rng(33)
    n, m = 32, 64
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    Ax = A @ rng.standard_normal(n)
    spread = np.abs(rng.standard_normal(m)) + 0.1
    return qp_from_numpy(dict(P=R @ R.T + 0.1 * np.eye(n),
                              q=rng.standard_normal(n), A=A, l=Ax - spread,
                              u=Ax + spread, lam=np.zeros(0)),
                         ConeSpec(m_box=m), device="cpu",
                         dtype=torch.float32).astype(F64)


def _rowshard(mesh):
    ndev = mesh.shape["data"]
    out = {}
    for name, make, kw in (
            ("rs_soc", _box_soc, dict(eps_abs=1e-7, eps_rel=1e-7,
                                      max_iter=50000)),
            ("rs_l1", _box_l1, dict(eps_abs=1e-8, eps_rel=1e-8))):
        sol = solve_rowsharded(make(), mesh,
                               Settings(precision="single", **kw))
        out[f"{name}_d{ndev}"] = {f: getattr(sol, f) for f in FIELDS}
    sol = solve_rowsharded_hybrid(_box_f32(), mesh,
                                  Settings(eps_abs=1e-6, eps_rel=1e-6))
    out[f"rs_hybrid_d{ndev}"] = {f: getattr(sol, f) for f in FIELDS}
    return out


def _mc_batch(per_lane_q):
    qp, _, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(4),
                                  batch=8, N=6, dim=2, dtype=F64,
                                  device="cpu")
    if per_lane_q:
        g = torch.Generator().manual_seed(1)
        q = qp.q + 0.1 * torch.randn((8, qp.n), generator=g, dtype=F64)
        qp = qp.__class__(P=qp.P, q=q, A=qp.A, l=qp.l, u=qp.u, lam=qp.lam,
                          cone=qp.cone)
    return qp


def _batch(mesh):
    out = {}
    for name, per_lane_q, s in (
            ("batch_double_q", True, Settings(eps_abs=1e-8, eps_rel=1e-8,
                                              precision="double")),
            ("batch_hybrid", False, Settings(eps_abs=1e-6, eps_rel=1e-6))):
        qp, *_ = shard_batch(_mc_batch(per_lane_q), mesh)
        sol = solve_batch_shared(qp, s, mesh=mesh)
        out[name] = {f: runtime.all_gather(getattr(sol, f), mesh, "data")
                     for f in FIELDS}
    return out


_PLAIN = Settings(eps_abs=1e-6, eps_rel=1e-6, precision="double",
                  scaling_iters=0, restart_every=0, stall_checks=0,
                  polish=False, eps_pinf=0.0, eps_dinf=0.0)


def _horizon(mesh):
    qp, spec, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(0),
                                     batch=4, N=8, dim=2, dtype=F64,
                                     device="cpu")
    hp, hspec = partition_qp(qp, spec.block, 4,
                             mpc_row_time(8, spec.ns, spec.nu))
    out = {}
    for name, s in (("hz_double", _PLAIN),
                    ("hz_single", _PLAIN.replace(precision="single",
                                                 eps_abs=1e-4,
                                                 eps_rel=1e-4))):
        sol = solve_horizon_sharded(hp, hspec, mesh, s)
        out[name] = {f: getattr(sol, f) for f in FIELDS}
    return out


def _worker(rank, world, store, out_dir):
    torch.set_num_threads(1)
    runtime.initialize(init_method=f"file://{store}", world_size=world,
                       rank=rank, backend="gloo")
    try:
        data_mesh = make_data_mesh(device="cpu")
        result = {"coords": dict(data_mesh.coords), **_rowshard(data_mesh)}
        if world == 2:
            result.update(_batch(data_mesh))
        else:
            result.update(_horizon(runtime.make_mesh(data=2, horizon=2,
                                                     device="cpu")))
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        runtime.shutdown()


def _spawn(tmp: Path, world: int):
    """Run `_worker` on `world` gloo ranks within SPAWN_LIMIT_S; kill
    them and fail on expiry. Returns each rank's results."""
    ctx = mp.start_processes(
        _worker, args=(world, str(tmp / "store"), str(tmp)), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                pytest.fail(f"{world} gloo ranks did not finish within "
                            f"{SPAWN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"gloo_sharded_{world}")
    return world, _spawn(tmp, world)


@pytest.fixture(scope="module")
def world1():
    """The same solves in this process, on a 1-rank mesh."""
    mesh = make_data_mesh(device="cpu")
    out = _rowshard(mesh)
    out.update(_batch(mesh))
    out.update(_horizon(runtime.make_mesh(device="cpu")))
    return out


def _bar(case):
    """(iterations slack, x tolerance) of a case: see the module
    docstring."""
    for prefix, bar in F32_BARS.items():
        if case.startswith(prefix):
            return bar
    return 0, X_F64


# Each world's cases, by kind: the row-sharded cases on the data mesh,
# then the batch (world 2) or the horizon driver (world 4).
KINDS = ("rs_soc", "rs_l1", "rs_hybrid", "solve_f64", "solve_f32")


def _case(kind, world):
    if kind.startswith("rs_"):
        return f"{kind}_d{world}"
    return {(2, "solve_f64"): "batch_double_q",
            (2, "solve_f32"): "batch_hybrid",
            (4, "solve_f64"): "hz_double",
            (4, "solve_f32"): "hz_single"}[world, kind]


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_solves_match_one_process(ranks, world1, kind):
    world, res = ranks
    case = _case(kind, world)
    slack, x_tol = _bar(case)
    ref = world1[case.replace(f"_d{world}", "_d1")]
    assert torch.all(ref["status"] == int(Status.SOLVED))
    for out in res:
        got = out[case]
        assert torch.equal(got["status"], ref["status"])
        assert int((got["iters"] - ref["iters"]).abs().max()) <= slack
        torch.testing.assert_close(got["x"], ref["x"], rtol=0, atol=x_tol)
        torch.testing.assert_close(got["z"], ref["z"], rtol=0, atol=x_tol)


@pytest.mark.parametrize("kind", KINDS)
def test_every_rank_returns_the_same_solution(ranks, kind):
    """The rows, scenarios and parts are gathered back: every rank holds
    the whole solution, bitwise the same."""
    world, res = ranks
    case = _case(kind, world)
    for out in res[1:]:
        for f in FIELDS:
            assert torch.equal(out[case][f], res[0][case][f]), f
