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

import torch

from ..core.scaling import ruiz_equilibrate_blocks
from ..problem import QPData, mv, vm
from ..settings import Settings
from ..solution import Status
from . import runtime
from .batch import _geomean_masked
from .consensus import (ConsensusSolution, ConsensusSpec, Local,
                        PhaseResult, _backend, _balance, _l1_scale,
                        _linf_scen, _pmax, _ratio, _record, _Rho,
                        _scaled_inputs, _status, consensus_body,
                        infeasibility_blocks, recentered_rounds_blocks,
                        solve_pipeline)
from .runtime import DATA_AXIS, HORIZON_AXIS, Mesh

_UNSOLVED = int(Status.UNSOLVED)


def run_consensus_mc(qp_blk: QPData, spec: ConsensusSpec,
                     settings: Settings, loc: Local, x0, z0, y0,
                     backend: str, scaling_vecs, z_off=None,
                     rho0=None) -> PhaseResult:
    """Rank-local driver over both axes.

    qp_blk: block-local data with SCENARIO-BATCHED l/u of shape (B_loc,
    S, mb); P (S, nb, nb), A (S, mb, nb) and q (S, nb) shared (q may be
    (B_loc, S, nb) in the re-centred rounds). x0/z0/y0: (B_loc, S, .).
    scaling_vecs = (d, e, c) of the block-shared Ruiz scaling;
    residuals and termination are UNSCALED.
    """
    dtype, dev = qp_blk.dtype, qp_blk.device
    mesh = loc.mesh
    B_loc = x0.shape[0]
    d_s, e_s, c_s = scaling_vecs
    einv = 1.0 / e_s
    cd_inv = 1.0 / (c_s * d_s)
    # Equality boost from lane 0's bounds (dispersions change values,
    # not the equality pattern) plus all edge rows.
    idx = torch.arange(spec.mb, device=dev)
    l0, u0 = qp_blk.l[0], qp_blk.u[0]
    box_eq = (l0 == u0) & torch.isfinite(l0) & (idx < spec.cone.m_box)
    rho = _Rho(qp_blk, spec, settings, backend, box_eq)
    rho_bar = (torch.tensor(settings.rho, dtype=dtype, device=dev)
               if rho0 is None else rho0.to(dtype))
    fac = rho.factor(rho_bar)
    nlam = _l1_scale(qp_blk, spec, cd_inv, loc)
    # The q scale is a max over this rank's scenarios and the horizon
    # axis, as the reference's (per-scenario q in the re-centred rounds).
    nq = torch.maximum(_pmax((cd_inv * qp_blk.q).abs().amax(), loc), nlam)
    use_cert = settings.eps_pinf > 0 or settings.eps_dinf > 0
    k = settings.check_every
    interval_checks = max(1, settings.adaptive_rho_interval // k)
    restart_checks = settings.restart_every and max(
        1, settings.restart_every // k)
    hist = torch.full((max(settings.history, 0), 3), -1.0, dtype=dtype,
                      device=dev)

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

    def geomean(v):
        return _geomean_masked(v, still, mesh)

    def pick(mask, a, b):
        return torch.where(mask[:, None, None], a, b)

    x, z, y = x0, z0, y0
    x_chk, y_chk = x0, y0
    sums = [torch.zeros_like(t) for t in (x0, z0, y0)]
    cnt = 0
    it = 0
    iters_sc = torch.zeros(B_loc, dtype=torch.int32, device=dev)
    status = torch.full((B_loc,), _UNSOLVED, dtype=torch.int32, device=dev)
    r_p = r_d = torch.full((B_loc,), float("inf"), dtype=dtype, device=dev)
    alive = True
    while alive and it < settings.max_iter:
        check = it // k
        rho_vec = rho.vec(rho_bar)
        active = status == _UNSOLVED
        xn, zn, yn = x, z, y
        for _ in range(k):
            xn, zn, yn = consensus_body(qp_blk, spec, settings, loc, fac,
                                        xn, zn, yn, rho_vec, backend,
                                        z_off=z_off)
        x, z, y = pick(active, xn, x), pick(active, zn, z), pick(active, yn, y)
        it += k
        iters_sc = iters_sc + active.to(torch.int32) * k
        res = scen_res(x, z, y)
        # Per-scenario certificates from PRE-restart deltas.
        cert = (infeasibility_blocks(qp_blk, spec, settings, loc,
                                     scaling_vecs, x - x_chk, y - y_chk)
                if use_cert else None)
        x_chk, y_chk = x, y

        # Per-scenario restarted averaging; the norms are reduced over
        # the horizon axis, so every horizon rank takes the same
        # per-scenario decision.
        sums = [s + t for s, t in zip(sums, (x, z, y))]
        cnt += 1
        if restart_checks and check % restart_checks == restart_checks - 1:
            xa, za, ya = (s / float(cnt) for s in sums)
            res_a = scen_res(xa, za, ya)
            take = active & (_ratio(res_a, settings) < _ratio(res, settings))
            x, z, y = pick(take, xa, x), pick(take, za, z), pick(take, ya, y)
            res = tuple(torch.where(take, ra, rc)
                        for ra, rc in zip(res_a[:6], res[:6])) + (res[6],)
            sums = [torch.zeros_like(s) for s in sums]
            cnt = 0

        status = torch.where(active, _status(res, settings, cert), status)
        r_p = torch.where(active, res[0], r_p)
        r_d = torch.where(active, res[1], r_d)

        still = status == _UNSOLVED
        do = torch.zeros((), dtype=torch.bool, device=dev)
        if (settings.adaptive_rho
                and check % interval_checks == interval_checks - 1):
            new_rho, changed = _balance((r_p, r_d) + res[2:], rho_bar,
                                        settings, geomean=geomean)
            do = changed & still.any()
        if hist.shape[0]:
            _record(hist, check, it,
                    runtime.pmax(r_p.amax(), mesh, DATA_AXIS),
                    runtime.pmax(r_d.amax(), mesh, DATA_AXIS))
        # The one device-to-host read of this check: liveness over every
        # scenario of the mesh, and the shared rho decision.
        flags = runtime.agree(
            torch.stack([still.any(), do]).to(torch.int32), mesh)
        alive, do = (bool(f) for f in flags.tolist())
        if do:
            rho_bar = new_rho
            fac = rho.refresh(fac, rho_bar)
    status = torch.where(status == _UNSOLVED, int(Status.MAX_ITER),
                         status).to(torch.int32)
    return PhaseResult(x, z, y, status, iters_sc, r_p, r_d, rho_bar, hist)


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
