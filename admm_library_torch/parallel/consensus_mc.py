"""Monte-Carlo consensus ADMM over a 2-D (data x horizon) mesh: consensus
ADMM over B dispersed scenarios, horizon-block partitioned (BASELINE
config 5 as specified, the consensus_mc_1024 cell).

Scenarios split over the 'data' axis, horizon blocks over the 'horizon'
axis (parallel/runtime.make_mesh); each rank holds (B_loc, S, .)
iterates. The per-block matrices (P, A, q) and their KKT factors are
shared across scenarios (dispersions enter only the bounds), so the
x-update is one batched product per block against a shared factor. Per
iteration the ranks exchange the ns-sized edges along 'horizon'; per
check they reduce scalars: a max along 'horizon' for the residuals, a
sum along 'data' for the shared-rho statistics, and the loop predicate
over every rank.

Per-scenario convergence masking freezes finished scenarios in lockstep,
with honest per-scenario iteration counts, as
parallel.batch.run_admm_batch_shared does. Scaling and precision follow
parallel/consensus.py.
"""
from __future__ import annotations

import functools

import torch

from ..core import admm, graph
from ..core.scaling import ruiz_equilibrate_blocks
from ..problem import QPData, mv, vm
from ..settings import Settings
from ..solution import Status
from . import runtime
from .batch import _geomean_masked
from .consensus import (ConsensusSolution, ConsensusSpec, Local,
                        PhaseResult, _backend, _balance, _l1_scale,
                        _linf_scen, _pmax, _ratio, _rho_vec, _Rho,
                        _scaled_inputs, _status, consensus_body,
                        consensus_step, infeasibility_blocks, loop_static,
                        phase_carry, phase_state, recentered_rounds_blocks,
                        restart_cadence, solve_pipeline)
from .runtime import DATA_AXIS, HORIZON_AXIS, Mesh

_UNSOLVED = int(Status.UNSOLVED)


def consensus_mc_check(state, variant, *, spec: ConsensusSpec,
                       settings: Settings, backend: str, mesh: Mesh,
                       n_blocks: int, edge_scale: float, use_cert: bool,
                       restart_checks: int):
    """One residual check of `run_consensus_mc`: check_every iterations
    with finished scenarios frozen, the per-scenario residuals and
    certificates (pre-restart deltas), the per-scenario restarted
    averaging, the status and, in the rho-test variant, the shared rho
    from the still-active scenarios' geometric mean. Returns the state
    entries it changes; 'flags' holds (any scenario UNSOLVED, refactor)
    as int32, agreed over the ranks by the host."""
    restart, rho_test = variant
    loc = Local(mesh=mesh, block_ids=state["block_ids"], n_blocks=n_blocks)
    qp_blk = QPData(**state["qp"], cone=spec.cone)
    sc = state["scaling"]
    vecs = (sc["d"], sc["e"], sc["c"])
    einv = 1.0 / sc["e"]
    cd_inv = 1.0 / (sc["c"] * sc["d"])
    nq = state["nq"]
    k = settings.check_every

    def scen_res(x, z, y):
        """Per-scenario unscaled residual norms (7-tuple of (B_loc,))."""
        Ax = mv(qp_blk.A, x)
        Px = mv(qp_blk.P, x)
        Aty = vm(y, qp_blk.A)
        return (_linf_scen(einv * (Ax - z), loc),
                _linf_scen(cd_inv * (Px + qp_blk.q + Aty), loc),
                _linf_scen(einv * Ax, loc), _linf_scen(einv * z, loc),
                _linf_scen(cd_inv * Px, loc), _linf_scen(cd_inv * Aty, loc),
                nq)

    def pick(mask, a, b):
        return torch.where(mask[:, None, None], a, b)

    rho_bar, status = state["rho_bar"], state["status"]
    rho_vec = _rho_vec(rho_bar, state["box_eq"], state["edge"],
                       settings.rho_eq_scale, edge_scale)
    active = status == _UNSOLVED
    x, z, y = state["x"], state["z"], state["y"]
    xn, zn, yn = x, z, y
    for _ in range(k):
        xn, zn, yn = consensus_body(qp_blk, spec, settings, loc,
                                    state["fac"], xn, zn, yn, rho_vec,
                                    backend, z_off=state.get("z_off"))
    x, z, y = pick(active, xn, x), pick(active, zn, z), pick(active, yn, y)
    iters = state["iters"] + active.to(torch.int32) * k
    res = scen_res(x, z, y)
    # Per-scenario certificates from PRE-restart deltas.
    cert = (infeasibility_blocks(qp_blk, spec, settings, loc, vecs,
                                 x - state["x_chk"], y - state["y_chk"])
            if use_cert else None)
    x_chk, y_chk = x, y

    # Per-scenario restarted averaging; the norms are reduced over the
    # horizon axis, so every horizon rank takes the same per-scenario
    # decision. The window always holds restart_checks checks.
    sums = [state[n] + t for n, t in (("x_sum", x), ("z_sum", z),
                                      ("y_sum", y))]
    if restart:
        xa, za, ya = (s / float(restart_checks) for s in sums)
        res_a = scen_res(xa, za, ya)
        take = active & (_ratio(res_a, settings) < _ratio(res, settings))
        x, z, y = pick(take, xa, x), pick(take, za, z), pick(take, ya, y)
        res = tuple(torch.where(take, ra, rc)
                    for ra, rc in zip(res_a[:6], res[:6])) + (res[6],)
        sums = [torch.zeros_like(s) for s in sums]

    status = torch.where(active, _status(res, settings, cert), status)
    r_p = torch.where(active, res[0], state["r_prim"])
    r_d = torch.where(active, res[1], state["r_dual"])

    still = status == _UNSOLVED
    do = torch.zeros((), dtype=torch.bool, device=x.device)
    new_rho = state["new_rho"]
    if rho_test:
        def geomean(v):
            return _geomean_masked(v, still, mesh)
        new_rho, changed = _balance((r_p, r_d) + res[2:], rho_bar, settings,
                                    geomean=geomean)
        do = changed & still.any()
    it = state["it"] + k
    out = dict(x=x, z=z, y=y, x_chk=x_chk, y_chk=y_chk, x_sum=sums[0],
               z_sum=sums[1], y_sum=sums[2], iters=iters, status=status,
               r_prim=r_p, r_dual=r_d, new_rho=new_rho, it=it,
               flags=torch.stack([still.any(), do]).to(torch.int32))
    hist = state["hist"]
    if hist.shape[0]:
        row = torch.stack([
            it.to(hist.dtype),
            runtime.pmax(r_p.amax(), mesh, DATA_AXIS).to(hist.dtype),
            runtime.pmax(r_d.amax(), mesh, DATA_AXIS).to(hist.dtype)])
        out["hist"] = admm.hist_write(hist, state["it"] // k, row)
    return out


def run_consensus_mc(qp_blk: QPData, spec: ConsensusSpec,
                     settings: Settings, loc: Local, x0, z0, y0,
                     backend: str, scaling_vecs, z_off=None,
                     rho0=None) -> PhaseResult:
    """Rank-local driver over both axes: a lockstep loop over residual
    checks (`consensus_mc_check`) and refactors
    (`consensus.consensus_refactor`), `graph.CheckLoop.run_checks`: on
    the card one CUDA graph whose WHILE node runs them where
    `graph.capturable` allows, else the host loop that reads one agreed
    flag tensor a check.

    qp_blk: block-local data with SCENARIO-BATCHED l/u of shape (B_loc,
    S, mb); P (S, nb, nb), A (S, mb, nb) and q (S, nb) shared (q may be
    (B_loc, S, nb) in the re-centred rounds). x0/z0/y0: (B_loc, S, .).
    scaling_vecs = (d, e, c) of the block-shared Ruiz scaling;
    residuals and termination are UNSCALED.
    """
    dtype, dev = qp_blk.dtype, qp_blk.device
    B_loc = x0.shape[0]
    d_s, e_s, c_s = scaling_vecs
    cd_inv = 1.0 / (c_s * d_s)
    # Equality boost from lane 0's bounds (dispersions change values,
    # not the equality pattern) plus all edge rows.
    idx = torch.arange(spec.mb, device=dev)
    l0, u0 = qp_blk.l[0], qp_blk.u[0]
    box_eq = (l0 == u0) & torch.isfinite(l0) & (idx < spec.cone.m_box)
    rho = _Rho(qp_blk, spec, settings, backend, box_eq)
    rho_bar = (torch.tensor(settings.rho, dtype=dtype, device=dev)
               if rho0 is None else rho0.to(dtype))
    state = phase_state(qp_blk, rho, scaling_vecs, rho.factor(rho_bar), loc,
                        z_off)
    nlam = _l1_scale(qp_blk, spec, cd_inv, loc)
    # The q scale is a max over this rank's scenarios and the horizon
    # axis, as the reference's (per-scenario q in the re-centred rounds).
    state["nq"] = torch.maximum(
        _pmax((cd_inv * qp_blk.q).abs().amax(), loc), nlam)
    state.update(phase_carry(
        x0, z0, y0, rho_bar,
        torch.full((B_loc,), _UNSOLVED, dtype=torch.int32, device=dev),
        torch.full((B_loc,), float("inf"), dtype=dtype, device=dev),
        max(settings.history, 0)))
    state["iters"] = torch.zeros(B_loc, dtype=torch.int32, device=dev)
    restart_checks = restart_cadence(settings)
    args, key = loop_static(spec, settings, loc, restart_checks)
    step = functools.partial(consensus_step, check=consensus_mc_check,
                             settings=settings, backend=backend,
                             mesh=loc.mesh, **args)
    loop = graph.CheckLoop("run_consensus_mc", step, state, settings,
                           backend, mesh=loc.mesh, **key)
    # flags: (liveness over every scenario of the mesh, the shared rho
    # decision), agreed over every rank by the plain loop.
    loop.run_checks(settings, restart_checks,
                    agree=functools.partial(runtime.agree, mesh=loc.mesh))
    x, z, y, status, iters, r_p, r_d, rho_bar, hist = loop.result(
        "x", "z", "y", "status", "iters", "r_prim", "r_dual", "rho_bar",
        "hist")
    status = torch.where(status == _UNSOLVED, int(Status.MAX_ITER),
                         status).to(torch.int32)
    return PhaseResult(x, z, y, status, iters, r_p, r_d, rho_bar, hist)


def _mc_phase(qp_blk: QPData, spec: ConsensusSpec, loc: Local,
              settings: Settings, scaling, backend: str, x0, z0, y0,
              z_off=None, rho0=None) -> ConsensusSolution:
    """One scaled phase on this rank's (scenarios, blocks); inputs and
    outputs UNSCALED and local."""
    vecs, xs, zs, ys, offs = _scaled_inputs(scaling, qp_blk.dtype, x0, z0,
                                            y0, z_off)
    d_s, e_s, c_s = vecs
    r = run_consensus_mc(qp_blk, spec, settings, loc, xs, zs, ys, backend,
                         vecs, z_off=offs, rho0=rho0)
    return ConsensusSolution(
        x=d_s * r.x, z=r.z / e_s, y=(e_s / c_s) * r.y, status=r.status,
        iters=r.iters, r_prim=r.r_prim, r_dual=r.r_dual, rho=r.rho_bar,
        history=r.hist)


def consensus_solve_mc(qp_blk: QPData, spec: ConsensusSpec, mesh: Mesh,
                       settings: Settings = Settings(),
                       x0=None, z0=None, y0=None, rho0=None
                       ) -> ConsensusSolution:
    """Solve B dispersed scenarios of a block-partitioned problem over a
    2-D (data, horizon) mesh.

    qp_blk: P (n_blocks, nb, nb), A, q per-block and shared; l, u
    scenario-batched (B, n_blocks, mb); lam (n_blocks, m_l1) shared —
    the same global problem on every rank. B must divide by the data
    axis, n_blocks by the horizon axis. Each rank solves its scenarios'
    blocks on mesh.device and returns the gathered global solution.
    Optional UNSCALED (x0, z0, y0) warm start, (B, n_blocks, .) layout.
    Returns x/z/y (B, n_blocks, .) and per-scenario status, iters,
    r_prim, r_dual (B,).
    """
    Bb = spec.n_blocks
    B = qp_blk.l.shape[0]
    nd, nh = mesh.shape[DATA_AXIS], mesh.shape[HORIZON_AXIS]
    if B % nd or Bb % nh:
        raise ValueError(f"batch {B} x blocks {Bb} not divisible by mesh "
                         f"({nd} x {nh})")
    dev = mesh.device
    backend = _backend(settings, dev)
    dtype = qp_blk.dtype
    S, Bl = Bb // nh, B // nd
    h, d = mesh.coords[HORIZON_AXIS], mesh.coords[DATA_AXIS]
    blk = slice(h * S, (h + 1) * S)
    scn = slice(d * Bl, (d + 1) * Bl)
    loc = Local(mesh=mesh, n_blocks=Bb,
                block_ids=torch.arange(h * S, (h + 1) * S, device=dev))

    def mine(t, width):
        if t is None:
            return torch.zeros((Bl, S, width), dtype=dtype, device=dev)
        return torch.as_tensor(t)[scn, blk].to(device=dev, dtype=dtype)

    qp_loc = QPData(P=qp_blk.P[blk], q=qp_blk.q[blk], A=qp_blk.A[blk],
                    l=qp_blk.l[scn, blk], u=qp_blk.u[scn, blk],
                    lam=qp_blk.lam[blk], cone=qp_blk.cone).to(dev)
    x0, z0, y0 = mine(x0, spec.nb), mine(z0, spec.mb), mine(y0, spec.mb)
    qp_s, scaling = ruiz_equilibrate_blocks(
        qp_loc, spec, settings.scaling_iters,
        reduce_max=lambda t: _pmax(t, loc))
    rho_start = None if rho0 is None else torch.as_tensor(rho0).to(dev)

    def phase(qp_p, s, x_p, z_p, y_p, off=None, rho0=rho_start,
              scaling=scaling):
        return _mc_phase(qp_p, spec, loc, s, scaling, backend, x_p, z_p,
                         y_p, z_off=off, rho0=rho0)

    def gather(t, dim_h, dim_d):
        t = runtime.all_gather(t, mesh, HORIZON_AXIS, dim=dim_h)
        return runtime.all_gather(t, mesh, DATA_AXIS, dim=dim_d)

    def finish(x, z, y, status, iters, r_p, r_d, rho, hist):
        per_scen = [runtime.all_gather(t, mesh, DATA_AXIS, dim=0)
                    for t in (status, iters, r_p, r_d)]
        return ConsensusSolution(gather(x, 1, 0), gather(z, 1, 0),
                                 gather(y, 1, 0), *per_scen, rho, hist)

    def rounds(sol32, phase_c):
        return recentered_rounds_blocks(qp_loc, spec, settings, sol32,
                                        phase_c, loc)

    return solve_pipeline(qp_s, qp_loc, spec, settings, scaling, phase,
                          rounds, finish, x0, z0, y0)
