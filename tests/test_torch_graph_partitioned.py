"""Captured checks of the partitioned drivers (core/graph.py) on the CPU:
`parallel.consensus.run_consensus`, `consensus_mc.run_consensus_mc` and
`horizon._run_horizon`.

- Each driver's check (`consensus_check`, `consensus_mc_check`,
  `horizon_check`) in every variant makes no host read: it runs under
  FakeTensorMode, where `.item()`, `float(t)`, `bool(t)` and `.tolist()`
  raise. f32 and f64, box rows and box + L1 + SOC rows, with and
  without a re-centring offset, certificates on and off.
- Each driver is bitwise the plain loop of
  tests/torch_loops_reference.py (host counters, rebinding), over
  restart boundaries, rho refactors, scenarios that freeze early and
  infeasibility certificates, through the drivers' own entry points
  (the re-centred rounds included) or with an offset given directly.
- The cache key holds plain values: two solves on freshly built meshes
  map to one entry; the f32 phase and the offset rounds to two.
- On the CPU no partitioned loop is captured, and the plain version
  holds the caller's tensors.

No JAX here: the drivers' JAX parity stays with
tests/test_torch_consensus.py, test_torch_consensus_mc.py and
test_torch_horizon.py. Small shapes (4 blocks or parts, 3–4 lanes).
"""
import functools

import numpy as np
import pytest
import torch

from admm_library_torch import Settings, Status
from admm_library_torch.core import graph
from admm_library_torch.core.scaling import ruiz_equilibrate_blocks
from admm_library_torch.models import monte_carlo as mc
from admm_library_torch.models.clohessy_wiltshire import (
    build_cw_rendezvous_sparse, cw_sparse_bounds_for_s0)
from admm_library_torch.models.partitioned import (partition_mpc,
                                                    partition_mpc_from_s0)
from admm_library_torch.parallel import consensus, consensus_mc, horizon
from admm_library_torch.parallel import runtime
from admm_library_torch.parallel.consensus import ConsensusSpec, Local
from admm_library_torch.problem import ConeSpec, QPData

import torch_loops_reference as ref
from test_torch_graph import _Recorder, _run_without_host_read

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
S0 = np.array([1.0, -2.0, 0.3, -0.1])
ST = np.zeros(4)

# Restart every 3 checks, rho test every 2, rho far off: restarts and
# refactors within the first checks; the history wraps.
LOOP = Settings(check_every=5, adaptive_rho_interval=10, restart_every=15,
                history=3, rho=0.1, eps_abs=1e-6, eps_rel=1e-6,
                max_iter=4000)


def _mesh():
    return runtime.make_mesh(device="cpu")


def _local(mesh, n_blocks):
    return Local(mesh=mesh, n_blocks=n_blocks,
                 block_ids=torch.arange(n_blocks))


def _mpc_blocks(dtype, s_t=ST, u_max=2.0):
    qp, spec, _ = partition_mpc(S0, s_t, N=16, n_blocks=4, dim=2,
                                u_max=u_max, dtype=dtype, device="cpu")
    return qp, spec


def _mixed_blocks(dtype):
    """Random block data with box, L1 and SOC local rows: 3 blocks,
    nb=6, m_local = 3 + 2 + 2*3, ns=2; the edge rows are equalities
    (the end blocks hold their boundary values in l)."""
    rng = np.random.default_rng(5)
    S, nb, ns = 3, 6, 2
    cone = ConeSpec(m_box=3, m_l1=2, soc_dims=(3, 3))
    ml = cone.m
    mb = ml + 2 * ns
    R = rng.standard_normal((S, nb, nb))
    l = np.full((S, mb), -np.inf)
    u = np.full((S, mb), np.inf)
    l[:, :3], u[:, :3] = -rng.uniform(0.5, 2, (S, 3)), rng.uniform(0.5, 2,
                                                                  (S, 3))
    l[:, 3:5], u[:, 3:5] = -2.0, 2.0
    l[:, ml:] = u[:, ml:] = 0.2 * rng.standard_normal((S, 2 * ns))
    arrays = dict(P=R @ R.transpose(0, 2, 1) + 0.1 * np.eye(nb),
                  q=rng.standard_normal((S, nb)),
                  A=rng.standard_normal((S, mb, nb)) / np.sqrt(nb),
                  l=l, u=u, lam=rng.uniform(0.1, 1, (S, 2)))
    qp = QPData(**{k: torch.as_tensor(v, dtype=dtype)
                   for k, v in arrays.items()}, cone=cone)
    return qp, ConsensusSpec(n_blocks=S, nb=nb, m_local=ml, ns=ns,
                             cone=cone)


def _scenarios(qp, B=3, seed=2):
    """The block problem with B scenarios: each lane's bounds shifted
    on the finite local box rows."""
    rng = np.random.default_rng(seed)
    shift = torch.as_tensor(0.05 * rng.standard_normal((B,) + qp.l.shape),
                            dtype=qp.dtype)
    shift[:, :, qp.cone.m_box:] = 0.0
    shift[0] = 0.0
    return QPData(P=qp.P, q=qp.q, A=qp.A, l=qp.l + shift, u=qp.u + shift,
                  lam=qp.lam, cone=qp.cone)


def _scaled_args(qp, spec, lanes=None):
    """(scaled qp, scaling vectors, zero x0, z0, y0) of a block problem,
    with `lanes` scenarios where given."""
    qp_s, sc = ruiz_equilibrate_blocks(qp, spec, 10)
    lead = () if lanes is None else (lanes,)
    zeros = [torch.zeros(lead + (spec.n_blocks, w), dtype=qp.dtype)
             for w in (spec.nb, spec.mb, spec.mb)]
    return qp_s, (sc.d, sc.e, sc.c), zeros


def _offset(spec, lanes=None, dtype=F64, seed=3):
    """A re-centring offset on the agreement rows, zero on local rows."""
    rng = np.random.default_rng(seed)
    lead = () if lanes is None else (lanes,)
    off = torch.as_tensor(0.1 * rng.standard_normal(
        lead + (spec.n_blocks, spec.mb)), dtype=dtype)
    off[..., :spec.m_local] = 0.0
    return off


def _horizon_mpc(dtype, B=4):
    qp, spec, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(0),
                                     batch=B, N=8, dim=2, dtype=F64,
                                     device="cpu")
    hp, hs = horizon.partition_qp(qp, spec.block, 4, horizon.mpc_row_time(
        8, spec.ns, spec.nu))
    return horizon.HorizonParts(*(t.to(dtype) for t in hp)), hs


def _horizon_cw(dtype, B=3):
    s0 = np.array([5.0, -3.0, 1.0, 0.01, 0.02, -0.01])
    qp1, spec = build_cw_rendezvous_sparse(s0, N=8, dt=600.0, lam=0.1,
                                           dtype=F64, device="cpu")
    s0s = s0 + 0.1 * np.random.default_rng(3).standard_normal((B, 6))
    l, u = cw_sparse_bounds_for_s0(qp1, spec, s0s)
    qp = QPData(P=qp1.P, q=qp1.q, A=qp1.A, l=l, u=u, lam=qp1.lam,
                cone=qp1.cone)
    hp, hs = horizon.partition_qp(qp, 9, 4, horizon.cw_sparse_row_time(8))
    return horizon.HorizonParts(*(t.to(dtype) for t in hp)), hs


def _horizon_args(hp, hs, mesh):
    B, S = hp.l.shape[:2]
    zeros = [torch.zeros((B, S, w), dtype=hp.q.dtype)
             for w in (hs.npb, hs.mp, hs.mp)]
    return hp, hs, _local(mesh, hs.parts), zeros


# ---------------------------------------------------------------- (a)

def _blocks(rows, dtype):
    return _mpc_blocks(dtype) if rows == "box" else _mixed_blocks(dtype)


@pytest.mark.parametrize("cert", ["cert", "nocert"])
@pytest.mark.parametrize("off", ["off", "nooff"])
@pytest.mark.parametrize("rows", ["box", "box_l1_soc"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("loop", ["run_consensus", "run_consensus_mc"])
def test_consensus_check_makes_no_host_read(loop, dtype, rows, off, cert,
                                            monkeypatch):
    dtype = {"f32": F32, "f64": F64}[dtype]
    qp, spec = _blocks(rows, dtype)
    s = LOOP.replace(max_iter=0)
    if cert == "nocert":
        s = s.replace(eps_pinf=0.0, eps_dinf=0.0)
    lanes = None if loop == "run_consensus" else 3
    if lanes:
        qp = _scenarios(qp, lanes)
    qp_s, vecs, zeros = _scaled_args(qp, spec, lanes)
    z_off = _offset(spec, lanes, dtype) if off == "off" else None
    run = (consensus.run_consensus if lanes is None
           else consensus_mc.run_consensus_mc)
    rec = _Recorder(monkeypatch)
    run(qp_s, spec, s, _local(_mesh(), spec.n_blocks), *zeros, "chol", vecs,
        z_off=z_off)
    (kind, step, state, _), = rec.loops
    assert kind == loop and ("z_off" in state) == (z_off is not None)
    assert step.keywords["use_cert"] == (cert == "cert")
    _run_without_host_read(step, state)


@pytest.mark.parametrize("rows", ["box", "l1"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_horizon_check_makes_no_host_read(dtype, rows, monkeypatch):
    dtype = {"f32": F32, "f64": F64}[dtype]
    hp, hs = _horizon_mpc(dtype) if rows == "box" else _horizon_cw(dtype)
    hp, hs, loc, zeros = _horizon_args(hp, hs, _mesh())
    rec = _Recorder(monkeypatch)
    horizon._run_horizon(hp, hs, LOOP.replace(max_iter=0), loc, *zeros)
    (kind, step, state, _), = rec.loops
    assert kind == "run_horizon" and state["x"].dtype == dtype
    _run_without_host_read(step, state)


# ---------------------------------------------------------------- (b)

def _assert_bitwise(new, old):
    assert type(new) is type(old)
    for field in old._fields:
        a, b = getattr(new, field), getattr(old, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field


def _with_plain_loop(monkeypatch, module, name, plain, fn, *args):
    """fn(*args) with module.name replaced by its plain loop."""
    with monkeypatch.context() as m:
        m.setattr(module, name, plain)
        return fn(*args)


# (block problem, dtype, settings, lanes). Every case crosses restart
# boundaries; the feasible ones refactor, the scenario batches freeze a
# lane early, the infeasible ones end on a certificate.
_CONSENSUS_CASES = {
    "box_f64_single": ("box", F64, dict(precision="single"), None),
    "box_f32_hybrid_rounds": ("box", F32, {}, None),
    "box_f64_cg": ("box", F64, dict(precision="single", backend="cg"), None),
    "infeasible_f64": ("infeasible", F64, dict(precision="single"), None),
    "mc_box_f64_single": ("box", F64, dict(precision="single"), 3),
    "mc_box_f32_hybrid_rounds": ("box", F32, {}, 3),
    "mc_infeasible_lanes_f64": ("infeasible", F64,
                                dict(precision="single"), 3),
}


def _consensus_problem(name, dtype, lanes):
    if name == "infeasible":
        # No control authority: only a scenario that starts at the
        # target is feasible (the rest get the certificate).
        if lanes is None:
            return _mpc_blocks(dtype, s_t=np.array([50.0, 40.0, 0, 0]),
                               u_max=0.0)
        s0s = np.stack([np.zeros(4), S0, 0.5 * S0])
        qp, spec, _, _ = partition_mpc_from_s0(s0s, S0, ST, N=16,
                                               n_blocks=4, dim=2, u_max=0.0,
                                               dtype=dtype, device="cpu")
        return qp, spec
    qp, spec = _mpc_blocks(dtype)
    if lanes is None:
        return qp, spec
    s0s = np.stack([S0, 0.5 * S0, 1.5 * S0])
    qp, spec, _, _ = partition_mpc_from_s0(s0s, S0, ST, N=16, n_blocks=4,
                                           dim=2, u_max=2.0, dtype=dtype,
                                           device="cpu")
    return qp, spec


@pytest.mark.parametrize("case", sorted(_CONSENSUS_CASES))
def test_consensus_drivers_are_bitwise_the_plain_loops(case, monkeypatch):
    name, dtype, kw, lanes = _CONSENSUS_CASES[case]
    qp, spec = _consensus_problem(name, dtype, lanes)
    s = LOOP.replace(**kw)
    if lanes is None:
        module, loop, plain = (consensus, "run_consensus",
                               ref._ref_run_consensus)
        solve = consensus.consensus_solve
    else:
        module, loop, plain = (consensus_mc, "run_consensus_mc",
                               ref._ref_run_consensus_mc)
        solve = consensus_mc.consensus_solve_mc
    new = solve(qp, spec, _mesh(), s)
    old = _with_plain_loop(monkeypatch, module, loop, plain, solve, qp, spec,
                           _mesh(), s)
    _assert_bitwise(new, old)
    it = new.iters.reshape(-1)
    status = new.status.reshape(-1)
    assert int(it.max()) >= 2 * s.restart_every     # restarts ran
    if name == "infeasible":
        assert int(Status.PRIMAL_INFEASIBLE) in status
    else:
        assert torch.all(status == int(Status.SOLVED))
        assert float(new.rho) != s.rho              # refactored
    if lanes is not None:
        assert int(it.min()) < int(it.max())        # a lane froze early


@pytest.mark.parametrize("rows", ["box", "box_l1_soc"])
@pytest.mark.parametrize("loop", ["run_consensus", "run_consensus_mc"])
def test_consensus_loops_with_an_offset_are_bitwise_the_plain_loops(
        loop, rows):
    """The rounds' form, given directly: an offset on the agreement rows,
    f64, certificates on, a warm rho."""
    qp, spec = _blocks(rows, F64)
    lanes = None if loop == "run_consensus" else 3
    if lanes:
        qp = _scenarios(qp, lanes)
    qp_s, vecs, zeros = _scaled_args(qp, spec, lanes)
    args = (qp_s, spec, LOOP.replace(max_iter=300),
            _local(_mesh(), spec.n_blocks), *zeros, "chol", vecs)
    kw = dict(z_off=_offset(spec, lanes), rho0=torch.tensor(1e-3, dtype=F64))
    run = getattr(consensus if lanes is None else consensus_mc, loop)
    plain = getattr(ref, "_ref_" + loop)
    new = run(*args, **kw)
    _assert_bitwise(new, plain(*args, **kw))
    assert bool(torch.isfinite(new.x).all())
    assert float(new.rho_bar) != 1e-3               # refactored


# (problem, dtype of the solve, settings, a lane freezes early)
_HORIZON_CASES = {
    "mpc_f64": (_horizon_mpc, F64, dict(precision="double", rho=10.0), True),
    "mpc_f32": (_horizon_mpc, F32, dict(eps_abs=1e-4, eps_rel=1e-4,
                                        rho=10.0), False),
    "cw_l1_f64": (_horizon_cw, F64, dict(precision="double", rho=10.0,
                                         max_iter=300), False),
}


@pytest.mark.parametrize("case", sorted(_HORIZON_CASES))
def test_horizon_driver_is_bitwise_the_plain_loop(case, monkeypatch):
    make, dtype, kw, frozen = _HORIZON_CASES[case]
    hp, hs = make(F64)
    s = LOOP.replace(**kw)
    new = horizon.solve_horizon_sharded(hp, hs, _mesh(), s)
    old = _with_plain_loop(monkeypatch, horizon, "_run_horizon",
                           ref._ref_run_horizon,
                           horizon.solve_horizon_sharded, hp, hs, _mesh(), s)
    _assert_bitwise(new, old)
    assert new.x.dtype == dtype
    assert bool(torch.isfinite(new.x).all())
    assert float(new.rho) != s.rho                  # refactored
    if frozen:
        assert torch.all(new.status == int(Status.SOLVED))
        assert int(new.iters.min()) < int(new.iters.max())


# ---------------------------------------------------------------- (c)

def _keys(monkeypatch, fn, *args):
    rec = _Recorder(monkeypatch)
    fn(*args)
    return [(kind, key) for kind, _, _, key in rec.loops]


def test_fresh_meshes_map_to_one_cache_entry(monkeypatch):
    """Two solves, each on a freshly built mesh (a new Local each phase):
    every loop's key is equal and hashable, so a cache holds one entry
    per key; the f32 phase and the offset rounds are two keys."""
    qp, spec = _mpc_blocks(F32)
    qp_mc, spec_mc = _consensus_problem("box", F32, 3)
    hp, hs = _horizon_mpc(F64)
    # max_iter cuts the phases short: the rounds still run.
    s = LOOP.replace(max_iter=200)
    runs = [
        (consensus.consensus_solve, qp, spec, s),
        (consensus_mc.consensus_solve_mc, qp_mc, spec_mc, s),
        (horizon.solve_horizon_sharded, hp, hs, s)]
    for fn, problem, sp, s in runs:
        first = _keys(monkeypatch, fn, problem, sp, _mesh(), s)
        second = _keys(monkeypatch, fn, problem, sp, _mesh(), s)
        assert first == second
        cache = graph.CheckCache()
        for _, key in first + second:
            cache.entry(key, None, {"x": torch.zeros(1)})
        kinds = {kind for kind, _ in first}
        distinct = len({key for _, key in first})
        assert len(cache.entries) == distinct
        if fn is horizon.solve_horizon_sharded:
            assert kinds == {"run_horizon"} and distinct == 1
        else:
            # The f32 phase, then the rounds with their offset.
            assert len(first) >= 2 and distinct == 2


def test_the_key_splits_on_the_mesh_coordinates(monkeypatch):
    """The same blocks at another horizon coordinate (another rank's
    share) get another key."""
    qp, spec = _mpc_blocks(F64)
    qp_s, vecs, zeros = _scaled_args(qp, spec)
    s = LOOP.replace(max_iter=0)
    keys = []
    for h in (0, 1):
        mesh = runtime.Mesh(shape={"data": 1, "horizon": 2},
                            coords={"data": 0, "horizon": h},
                            groups={"data": None, "horizon": None},
                            ranks={"data": (0,), "horizon": (0, 1)}, world=1,
                            device=torch.device("cpu"))
        loc = Local(mesh=mesh, n_blocks=8,
                    block_ids=torch.arange(4 * h, 4 * h + 4))
        keys += _keys(monkeypatch, consensus.run_consensus, qp_s, spec, s,
                      loc, *zeros, "chol", vecs)
    assert keys[0] != keys[1]


@pytest.mark.parametrize("driver", ["consensus", "consensus_mc", "horizon"])
def test_a_partitioned_loop_on_the_cpu_is_never_captured(driver,
                                                         monkeypatch):
    if driver == "horizon":
        hp, hs, loc, zeros = _horizon_args(*_horizon_mpc(F64), _mesh())
        fn = functools.partial(horizon._run_horizon, hp, hs,
                               LOOP.replace(max_iter=0), loc, *zeros)
    else:
        lanes = None if driver == "consensus" else 3
        qp, spec = _consensus_problem("box", F64, lanes)
        qp_s, vecs, zeros = _scaled_args(qp, spec, lanes)
        run = (consensus.run_consensus if lanes is None
               else consensus_mc.run_consensus_mc)
        fn = functools.partial(run, qp_s, spec, LOOP.replace(max_iter=0),
                               _local(_mesh(), spec.n_blocks), *zeros,
                               "chol", vecs)
    rec = _Recorder(monkeypatch)
    fn()
    (kind, step, state, _), = rec.loops
    loop = graph.CheckLoop(kind, step, state, LOOP, "spike",
                           mesh=_mesh())
    assert not loop.capture
    assert loop.state["x"] is state["x"]
    with pytest.raises(ValueError, match="not captured"):
        graph.CheckLoop(kind, step, state, LOOP, "chol", mesh=_mesh(),
                        capture=True)
