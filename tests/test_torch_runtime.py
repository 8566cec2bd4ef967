"""The torch.distributed runtime on gloo CPU ranks: the mesh, its
collectives against their single-process forms, and the consensus
drivers across ranks against the same drivers in one process.

Each case spawns its ranks once (a module fixture), rendezvous through a
file:// store under the test's tmp dir, and gives them their own time
limit: a deadlock kills the ranks and fails the tests instead of hanging
the suite. No JAX here, so the spawned ranks do not load it.

Tolerances. The ring exchange, the max reductions and the gathers move
values without arithmetic, so they are held bitwise. The sum reductions
and the drivers' shared-rho geometric mean (a float sum over the data
axis) may round differently from one process: solves are held to the
same statuses and iterations and x within 1e-10, except the Monte-Carlo
f32 phase split over the data axis (see _case_bar).
"""
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from admm_library_torch import Settings, Status
from admm_library_torch.models.partitioned import (partition_mpc,
                                                    partition_mpc_mc)
from admm_library_torch.parallel import runtime
from admm_library_torch.parallel.consensus import (Local, _neighbor_next,
                                                   _neighbor_prev,
                                                   consensus_solve)
from admm_library_torch.parallel.consensus_mc import consensus_solve_mc

torch.set_num_threads(1)

S0 = np.array([1.0, -2.0, 0.3, -0.1])
ST = np.zeros(4)
TOL = Settings(eps_abs=1e-7, eps_rel=1e-7, max_iter=20000)
X_SUM_TOL = 1e-10
SPAWN_LIMIT_S = 150.0
F64 = torch.float64

# Global test tensors for the collectives: (scenarios, blocks, width).
_B, _BLOCKS, _W = 4, 4, 3


def _global_edges():
    g = torch.Generator().manual_seed(7)
    return torch.randn((_B, _BLOCKS, _W), generator=g, dtype=F64)


def _mc_problem():
    return partition_mpc_mc(torch.Generator().manual_seed(0), 4, S0, ST,
                            N=8, n_blocks=4, dim=2, u_max=2.0, dtype=F64,
                            device="cpu")


def _chain_problem():
    return partition_mpc(S0, ST, N=8, n_blocks=4, dim=2, u_max=2.0,
                         dtype=F64, device="cpu")


def _local(mesh):
    """This rank's (scenarios, blocks) slices of the global edges and its
    consensus Local."""
    nd, nh = mesh.shape["data"], mesh.shape["horizon"]
    d, h = mesh.coords["data"], mesh.coords["horizon"]
    S, Bl = _BLOCKS // nh, _B // nd
    v = _global_edges()[d * Bl:(d + 1) * Bl, h * S:(h + 1) * S]
    loc = Local(mesh=mesh, n_blocks=_BLOCKS,
                block_ids=torch.arange(h * S, (h + 1) * S))
    return v, loc


def _collectives(mesh):
    v, loc = _local(mesh)
    rank_val = torch.tensor([float(mesh.coords["data"] * 10
                                   + mesh.coords["horizon"])], dtype=F64)
    out = {"prev": _neighbor_prev(v, loc), "next": _neighbor_next(v, loc),
           "shift_h": runtime.ring_shift(rank_val, mesh, "horizon", 1),
           "gather": runtime.all_gather(
               runtime.all_gather(v, mesh, "horizon", dim=1),
               mesh, "data", dim=0),
           "agree": runtime.agree(torch.tensor(
               [int(mesh.coords["horizon"] == 0)], dtype=torch.int32), mesh)}
    for axis in ("data", "horizon"):
        out[f"pmax_{axis}"] = runtime.pmax(v.amax(), mesh, axis)
        out[f"psum_{axis}"] = runtime.psum(v.sum(dim=(-2, -1)).sum(), mesh,
                                           axis)
    return out


def _solves(mesh):
    qp, spec, _, _ = _mc_problem()
    out = {}
    for name, s in (("mc_hybrid", TOL), ("mc_double",
                                         TOL.replace(precision="double"))):
        sol = consensus_solve_mc(qp, spec, mesh, s)
        out[name] = {f: getattr(sol, f) for f in ("x", "z", "status",
                                                   "iters")}
    # On a 2-D mesh every data row solves the chain problem whole.
    qp1, spec1, _ = _chain_problem()
    for name, s in (("chain_hybrid", TOL),
                    ("chain_single", TOL.replace(precision="single"))):
        sol = consensus_solve(qp1, spec1, mesh, s)
        out[name] = {f: getattr(sol, f) for f in ("x", "z", "status",
                                                   "iters")}
    return out


def _worker(rank, world, data, horizon, store, out_dir):
    torch.set_num_threads(1)
    runtime.initialize(init_method=f"file://{store}", world_size=world,
                       rank=rank, backend="gloo")
    try:
        mesh = runtime.make_mesh(data=data, horizon=horizon, device="cpu")
        result = {"coords": dict(mesh.coords), "shape": dict(mesh.shape),
                  **_collectives(mesh), **_solves(mesh)}
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    finally:
        runtime.shutdown()


def _spawn(tmp: Path, data: int, horizon: int):
    """Run `_worker` on data*horizon gloo ranks within SPAWN_LIMIT_S;
    kill them and fail on expiry. Returns each rank's results."""
    world = data * horizon
    ctx = mp.start_processes(
        _worker, args=(world, data, horizon, str(tmp / "store"), str(tmp)),
        nprocs=world, join=False, start_method="spawn")
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


@pytest.fixture(scope="module", params=[(2, 2), (1, 2)],
                ids=["data2_horizon2", "horizon2"])
def ranks(request, tmp_path_factory):
    data, horizon = request.param
    tmp = tmp_path_factory.mktemp(f"gloo_{data}x{horizon}")
    return data, horizon, _spawn(tmp, data, horizon)


@pytest.fixture(scope="module")
def world1():
    """The same computations in this process: a 1x1 mesh, no group."""
    mesh = runtime.make_mesh(device="cpu")
    assert mesh.groups == {"data": None, "horizon": None}
    return {**_collectives(mesh), **_solves(mesh)}


def test_mesh_layout(ranks):
    data, horizon, res = ranks
    for r, out in enumerate(res):
        # Horizon innermost: rank = d * horizon + h.
        assert out["coords"] == {"data": r // horizon, "horizon": r % horizon}
        assert out["shape"] == {"data": data, "horizon": horizon}


def test_ring_exchange_matches_one_process(ranks, world1):
    data, horizon, res = ranks
    S, Bl = _BLOCKS // horizon, _B // data
    for out in res:
        d, h = out["coords"]["data"], out["coords"]["horizon"]
        mine = (slice(d * Bl, (d + 1) * Bl), slice(h * S, (h + 1) * S))
        assert torch.equal(out["prev"], world1["prev"][mine])
        assert torch.equal(out["next"], world1["next"][mine])
        prev_h = (h - 1) % horizon
        assert out["shift_h"].item() == d * 10 + prev_h


def test_pmax_psum_gather_match_one_process(ranks):
    data, horizon, res = ranks
    glob = _global_edges()
    S, Bl = _BLOCKS // horizon, _B // data

    def part(d, h):
        return glob[d * Bl:(d + 1) * Bl, h * S:(h + 1) * S]

    for out in res:
        d, h = out["coords"]["data"], out["coords"]["horizon"]
        row = [part(d, hh) for hh in range(horizon)]
        col = [part(dd, h) for dd in range(data)]
        assert torch.equal(out["pmax_horizon"],
                           torch.stack([p.amax() for p in row]).amax())
        assert torch.equal(out["pmax_data"],
                           torch.stack([p.amax() for p in col]).amax())
        torch.testing.assert_close(out["psum_horizon"],
                                   sum(p.sum() for p in row),
                                   rtol=0, atol=1e-12)
        torch.testing.assert_close(out["psum_data"],
                                   sum(p.sum() for p in col),
                                   rtol=0, atol=1e-12)
        assert torch.equal(out["gather"], glob)
        assert out["agree"].item() == 1


_CASES = ("chain_hybrid", "chain_single", "mc_double", "mc_hybrid")


def _case_bar(case, data):
    """(iterations slack, x tolerance). Only the Monte-Carlo f32 phase
    ('hybrid') split over the data axis sums floats across ranks (its
    shared rho's geometric mean), and it amplifies a last-bit change of
    that rho: there the bar is the port-vs-reference one, one check
    interval and 1e-6 between two points solved to 1e-7. In f64, and
    where the data axis has size 1, the results are held to 1e-10."""
    if case == "mc_hybrid" and data > 1:
        return 25, 1e-6
    return 0, X_SUM_TOL


@pytest.mark.parametrize("case", _CASES)
def test_solves_across_ranks_match_world_one(ranks, world1, case):
    data, horizon, res = ranks
    slack, x_tol = _case_bar(case, data)
    ref = world1[case]
    assert torch.all(ref["status"] == int(Status.SOLVED))
    for out in res:
        got = out[case]
        assert torch.equal(got["status"], ref["status"])
        assert (got["iters"] - ref["iters"]).abs().max() <= slack
        torch.testing.assert_close(got["x"], ref["x"], rtol=0, atol=x_tol)


def test_boundary_copies_bitwise_across_ranks(ranks):
    """Both sides of a pair average the same two values, also where the
    pair straddles two ranks: the edge copies of z agree bitwise."""
    data, horizon, res = ranks
    _, spec, _ = _chain_problem()
    ml, ns = spec.m_local, spec.ns
    for out in res:
        z = out["chain_single"]["z"]
        assert torch.equal(z[1:, ml:ml + ns], z[:-1, ml + ns:])
