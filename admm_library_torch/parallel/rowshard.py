"""Row-sharded single problem: one QP too large for one card, its
constraint rows split over the ranks of the mesh's data axis.

The x-update runs matrix-free conjugate gradient on

    M v = P v + σ v + Aᵀ diag(ρ) (A v),

which splits by rows: each rank applies its rows of A (A_loc v, then
A_locᵀ(ρ_loc ∘ A_loc v)) and one sum over the data axis assembles the
n-vector, one collective per CG step. P and every n-vector stay whole
on every rank, so the CG iterates stay bitwise the same everywhere. The
z- and y-updates and the prox are row-local; the residual norms are max
reductions over the axis. ρ enters the operator directly, so adaptive ρ
needs no refactorisation: every rank computes the same update from the
same reduced norms.

Ruiz scaling runs on the whole problem before the split; the loop
computes UNSCALED residuals from the scaling vectors. Every rank holds
the whole problem and keeps its rows.

Each shard needs the same cone layout. Where the global [box | L1 | SOC]
layout does not split evenly in order, the rows are interleaved so that
every shard holds the same (m_box/ndev | m_l1/ndev | n_soc/ndev) mix,
and z and y are permuted back at the end.

The loop runs on `core/graph.CheckLoop.run_checks`, a check its
check_every iterations (each the CG of its x-update in blocks of
`ops.kkt._CG_CHECK` steps through `core.graph.while_blocks`, the
iteration's tail and the next CG start) and the residual check. On the
card with a data axis of one rank the checks are one CUDA graph replay:
a WHILE node over the checks, each check variant an IF node in it and
its CGs WHILE nodes inside that, three deep, every stop flag tested on
the card. With more ranks the collectives stay eager, the same checks
run as plain tensor code, and the host reads the CG's stop flag,
agreed over every rank, before each block, and the check's status once
a check, agreed over every rank.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import graph
from ..core.scaling import ruiz_equilibrate
from ..ops.kkt import cg_blocks
from ..ops.prox import project_cone
from ..precision import clean64
from ..problem import ConeSpec, QPData
from ..settings import Settings
from ..solution import Status
from . import runtime
from .runtime import DATA_AXIS, Mesh

_UNSOLVED = int(Status.UNSOLVED)
_SOLVED = int(Status.SOLVED)


def uniform_row_permutation(cone: ConeSpec, m: int, ndev: int):
    """Row permutation making the shards cone-uniform.

    Returns (perm, cone_local): perm[new_row] = old_row such that the
    permuted rows split into ndev contiguous shards, each laid out
    [box | L1 | SOC] with identical counts. Requires the per-type row
    counts to divide ndev (SOC: uniform block dims, block count % ndev).
    Returns (None, cone_local) when the layout is already shard-uniform.
    """
    mb, ml1 = cone.m_box, cone.m_l1
    n_soc = cone.n_soc if cone.m_soc else 0
    if mb % ndev or ml1 % ndev:
        raise ValueError(
            f"box rows {mb} / L1 rows {ml1} must divide {ndev} devices")
    if cone.m_soc:
        if not cone.soc_uniform:
            raise ValueError("row sharding needs uniform SOC block dims")
        if n_soc % ndev:
            raise ValueError(
                f"{n_soc} SOC blocks not divisible by {ndev} devices")
    per_box, per_l1 = mb // ndev, ml1 // ndev
    per_soc = n_soc // ndev
    d = cone.soc_dims[0] if cone.m_soc else 0
    cone_loc = ConeSpec(m_box=per_box, m_l1=per_l1,
                        soc_dims=(d,) * per_soc)
    if ndev == 1 or (ml1 == 0 and n_soc == 0) or (mb == 0 and n_soc == 0) \
            or (mb == 0 and ml1 == 0):
        # Single row type (or single device): already uniform in order.
        return None, cone_loc
    perm = []
    for dev in range(ndev):
        perm.extend(range(dev * per_box, (dev + 1) * per_box))
        perm.extend(mb + dev * per_l1 + i for i in range(per_l1))
        base = mb + ml1 + dev * per_soc * d
        perm.extend(base + i for i in range(per_soc * d))
    return np.asarray(perm, np.int32), cone_loc


class RowShardSolution(NamedTuple):
    x: torch.Tensor          # (n,)
    z: torch.Tensor          # (m,) in the caller's row order
    y: torch.Tensor          # (m,)
    status: torch.Tensor
    iters: torch.Tensor
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    rho: torch.Tensor
    cg_steps: torch.Tensor   # CG steps taken over every x-update


# The name under which core/graph.capturable admits this loop: the
# matrix-free CG, whose blocks are conditional nodes in a capture.
BACKEND = "rowshard_cg"


def _op(st, v, sigma: float, mesh: Mesh):
    """M v = P v + σ v + Aᵀ diag(ρ) (A v): this rank's rows of A, one sum
    over the data axis."""
    A = st["A_loc"]
    At = runtime.psum((st["rho_loc"] * (A @ v)) @ A, mesh, DATA_AXIS)
    return st["P"] @ v + sigma * v + At


def cg_head(st, settings: Settings, mesh: Mesh):
    """The start of an x-update from the carry (x, z, y, rho_bar): the
    row-local ρ, and CG on M xt = rhs from xt = 0 (xt, r, p, rs, tol2).
    The CG stops once ‖r‖² ≤ tol²·max(‖rhs‖², 1) or after cg_max_iter
    steps."""
    s = settings
    rb = st["rho_bar"]
    rho_loc = torch.where(st["eq_loc"], s.rho_eq_scale * rb, rb)
    rhs = s.sigma * st["x"] - st["q"] + runtime.psum(
        (rho_loc * st["z"] - st["y"]) @ st["A_loc"], mesh, DATA_AXIS)
    xt = torch.zeros_like(rhs)
    r = rhs - _op(dict(st, rho_loc=rho_loc), xt, s.sigma, mesh)
    rs = torch.dot(r, r)
    tol2 = (s.cg_tol * s.cg_tol) * torch.clamp(torch.dot(rhs, rhs), min=1.0)
    return dict(rho_loc=rho_loc, xt=xt, r=r, p=r, rs=rs, tol2=tol2)


def cg_block(st, steps: int, sigma: float, mesh: Mesh):
    """`steps` CG steps from the state's (xt, r, p, rs). A step taken
    once the stop test holds has α = 0 and leaves xt and r as they were,
    so the result is the one of a stop at that very step (as
    ops/kkt.cg_solve). Counts the steps taken in cg_steps."""
    tiny = torch.finfo(st["rs"].dtype).tiny
    xt, r, p, rs, tol2 = (st[k] for k in ("xt", "r", "p", "rs", "tol2"))
    count = st["cg_steps"]
    for _ in range(steps):
        live = rs > tol2
        Mp = _op(st, p, sigma, mesh)
        alpha = torch.where(
            live, rs / torch.clamp(torch.dot(p, Mp), min=tiny), 0.0)
        xt = xt + alpha * p
        r = r - alpha * Mp
        rs_new = torch.dot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=tiny)) * p
        rs = torch.where(live, rs_new, rs)
        count = count + live.to(torch.int32)
    return dict(xt=xt, r=r, p=p, rs=rs, cg_steps=count)


def _cg(st, settings: Settings, mesh: Mesh):
    """The CG of one x-update from the head in `st`: the blocks of
    ops/kkt.cg_blocks(cg_max_iter), each while the stop flag, agreed
    over every rank, says the residual is above its tolerance
    (`graph.while_blocks`). Returns xt, r, p, rs, tol2 and cg_steps."""
    def live(c):
        return runtime.agree((c["rs"] > c["tol2"]).to(torch.int32)[None],
                             mesh)

    def block(c, steps):
        return cg_block(dict(st, **c), steps, settings.sigma, mesh)
    return graph.while_blocks(
        {k: st[k] for k in ("xt", "r", "p", "rs", "tol2", "cg_steps")},
        live, block, cg_blocks(settings.cg_max_iter))


def _tail(st, settings: Settings, cone: ConeSpec):
    """The rest of one ADMM iteration after its CG: x, z and y."""
    a = settings.alpha
    rho_loc, x, z, y = st["rho_loc"], st["x"], st["z"], st["y"]
    zt = st["A_loc"] @ st["xt"]
    w = a * zt + (1 - a) * z
    v = w + y / rho_loc
    lo, hi = cone.m_box, cone.m_box + cone.m_l1
    lam_r = st["lam_loc"][lo:hi] / rho_loc[lo:hi]
    z_new = project_cone(v, st["l_loc"], st["u_loc"], lam_r, cone)
    return dict(x=a * st["xt"] + (1 - a) * x, z=z_new,
                y=y + rho_loc * (w - z_new))


def _pmax_abs(mesh: Mesh, *vs):
    """Max |v| of each row-local v over the axis (one collective)."""
    return runtime.pmax(torch.stack([v.abs().max() for v in vs]), mesh,
                        DATA_AXIS)


def _row_res(st, mesh: Mesh, x, z, y):
    """Globally reduced unscaled residual norms (7-tuple)."""
    A, einv, cd_inv, q = st["A_loc"], st["einv_loc"], st["cd_inv"], st["q"]
    Ax = A @ x
    Aty = runtime.psum(y @ A, mesh, DATA_AXIS)
    Px = st["P"] @ x
    r_p, nAx, nz = _pmax_abs(mesh, einv * (Ax - z), einv * Ax, einv * z)
    r_d = (cd_inv * (Px + q + Aty)).abs().max()
    nPx = (cd_inv * Px).abs().max()
    nAty = (cd_inv * Aty).abs().max()
    nq = torch.maximum((cd_inv * q).abs().max(), st["nlam"])
    return r_p, r_d, nAx, nz, nPx, nAty, nq


def _eps(res, s: Settings):
    _, _, nAx, nz, nPx, nAty, nq = res
    eps_p = s.eps_abs + s.eps_rel * torch.maximum(nAx, nz)
    eps_d = s.eps_abs + s.eps_rel * torch.maximum(
        nPx, torch.maximum(nAty, nq))
    return eps_p, eps_d


def _ratio(res, s: Settings):
    ep, ed = _eps(res, s)
    return torch.maximum(res[0] / ep, res[1] / ed)


def _count_bad(ok, mesh: Mesh):
    return runtime.psum((~ok).to(torch.int32).sum(), mesh, DATA_AXIS)


def _infeasibility(st, dx_s, dy_s, s: Settings, cone: ConeSpec,
                   mesh: Mesh):
    """OSQP §3.4 certificates on row-sharded data (cf. core.admm.
    infeasibility): dx_s whole (n,), dy_s row-local; every cross-shard
    quantity is reduced over the axis, so every rank reaches the same
    verdicts."""
    eps_pi, eps_di = s.eps_pinf, s.eps_dinf
    tiny = torch.finfo(dx_s.dtype).tiny
    inf = float("inf")
    A_loc, e_loc, einv_loc = st["A_loc"], st["e_loc"], st["einv_loc"]
    c_v, d_v, cd_inv = st["c"], st["d"], st["cd_inv"]
    mbl_box, nl = cone.m_box, cone.m_l1
    mbl = mbl_box + nl

    # ---- primal infeasibility from dy ----
    dy = (e_loc / c_v) * dy_s
    ndy = _pmax_abs(mesh, dy)[0]
    dyn = dy / torch.clamp(ndy, min=tiny)
    Aty = runtime.psum(((c_v / e_loc) * dyn) @ A_loc, mesh,
                       DATA_AXIS) * cd_inv
    cond_A = Aty.abs().max() <= eps_pi
    lu_l = st["l_loc"][:mbl] * einv_loc[:mbl]
    lu_u = st["u_loc"][:mbl] * einv_loc[:mbl]
    dyb = dyn[:mbl]
    up = torch.where(dyb > eps_pi, torch.where(
        torch.isfinite(lu_u), lu_u * dyb, inf), 0.0)
    lo = torch.where(dyb < -eps_pi, torch.where(
        torch.isfinite(lu_l), lu_l * dyb, inf), 0.0)
    sup = runtime.psum((up + lo).sum(), mesh, DATA_AXIS)
    if cone.m_soc:
        d_soc = cone.soc_dims[0]
        blk = dyn[mbl:].reshape(cone.n_soc, d_soc)
        ok = (torch.linalg.vector_norm(blk[:, 1:], dim=-1)
              <= -blk[:, 0] + eps_pi)
        sup = torch.where(_count_bad(ok, mesh) > 0, inf, sup)
    pinf = (ndy > 0) & cond_A & (sup <= eps_pi)

    # ---- dual infeasibility from dx (whole) ----
    dx = d_v * dx_s
    ndx = dx.abs().max()
    dxn = dx / torch.clamp(ndx, min=tiny)
    Pdx = (st["P"] @ (dxn / d_v)) * cd_inv
    Adx = einv_loc * (A_loc @ (dxn / d_v))
    cond_P = Pdx.abs().max() <= eps_di
    qdx = ((cd_inv * st["q"]) * dxn).sum()
    if nl:
        sl = slice(mbl_box, mbl)
        lam_u = st["lam_loc"][sl] * e_loc[sl] / c_v
        qdx = qdx + runtime.psum((lam_u * Adx[sl].abs()).sum(), mesh,
                                 DATA_AXIS)
    cond_q = qdx <= -eps_di
    av = Adx[:mbl]
    ok_up = (av <= eps_di) | ~torch.isfinite(lu_u)
    ok_lo = (av >= -eps_di) | ~torch.isfinite(lu_l)
    cond_box = _count_bad(ok_up & ok_lo, mesh) == 0
    cond_soc = True
    if cone.m_soc:
        d_soc = cone.soc_dims[0]
        blk = Adx[mbl:].reshape(cone.n_soc, d_soc)
        ok = (torch.linalg.vector_norm(blk[:, 1:], dim=-1)
              <= blk[:, 0] + eps_di)
        cond_soc = _count_bad(ok, mesh) == 0
    dinf = (ndx > 0) & cond_P & cond_q & cond_box & cond_soc
    return pinf, dinf


def _check(st, restart: bool, rho_test: bool, *, settings: Settings,
           mesh: Mesh, cone: ConeSpec, use_cert: bool, restart_checks: int):
    """The residual check after a check's last iteration: the reduced
    residuals, the restarted averaging, the status, the certificates
    from the deltas since the last check and, in the rho-test variant,
    adaptive ρ. 'flags' holds (status left UNSOLVED) as int32 (1,)."""
    s = settings
    x, z, y = st["x"], st["z"], st["y"]
    res = _row_res(st, mesh, x, z, y)

    # Restarted averaging (Settings.restart_every): the decision uses
    # globally reduced norms, so every rank takes the same one. The
    # window always holds restart_checks checks: the loop starts at
    # check 0.
    sums = [st[n] + t for n, t in (("x_sum", x), ("z_sum", z),
                                   ("y_sum", y))]
    if restart:
        xa, za, ya = (t / float(restart_checks) for t in sums)
        res_a = _row_res(st, mesh, xa, za, ya)
        take = _ratio(res_a, s) < _ratio(res, s)
        x, z, y = (torch.where(take, a, b)
                   for a, b in ((xa, x), (za, z), (ya, y)))
        res = tuple(torch.where(take, ra, rc)
                    for ra, rc in zip(res_a[:6], res[:6])) + (res[6],)
        sums = [torch.zeros_like(t) for t in sums]

    r_p, r_d = res[0], res[1]
    eps_p, eps_d = _eps(res, s)
    status = torch.where((r_p <= eps_p) & (r_d <= eps_d), _SOLVED,
                         _UNSOLVED).to(torch.int32)
    if use_cert:
        pinf, dinf = _infeasibility(st, x - st["x_chk"], y - st["y_chk"],
                                    s, cone, mesh)
        status = torch.where(
            status == _SOLVED, status,
            torch.where(pinf, int(Status.PRIMAL_INFEASIBLE),
                        torch.where(dinf, int(Status.DUAL_INFEASIBLE),
                                    status))).to(torch.int32)
    out = dict(x=x, z=z, y=y, x_chk=x, y_chk=y, x_sum=sums[0],
               z_sum=sums[1], y_sum=sums[2], status=status, r_p=r_p,
               r_d=r_d, flags=(status != _UNSOLVED).to(torch.int32)[None])
    # Adaptive rho: free under CG, and every input is a reduced scalar,
    # so every rank computes the same new rho.
    if rho_test:
        tiny = torch.finfo(r_p.dtype).tiny
        _, _, nAx, nz, nPx, nAty, nq = res
        sp = r_p / torch.clamp(torch.maximum(nAx, nz), min=tiny)
        sd = r_d / torch.clamp(torch.maximum(torch.maximum(nPx, nAty), nq),
                               min=tiny)
        ratio = torch.sqrt(sp / torch.clamp(sd, min=tiny))
        new_rho = torch.clamp(st["rho_bar"] * ratio, s.rho_min, s.rho_max)
        tol = s.adaptive_rho_tol
        changed = (ratio > tol) | (ratio < 1.0 / tol)
        out["rho_bar"] = torch.where(changed & (status == _UNSOLVED),
                                     new_rho, st["rho_bar"])
    return out


def rowshard_step(st, variant, *, settings: Settings, mesh: Mesh,
                  cone: ConeSpec, use_cert: bool, restart_checks: int):
    """One check of the loop of `solve_rowsharded`, a step of
    core/graph.CheckLoop, `variant` = ("check", restart, rho_test):
    check_every iterations, each the CG of its x-update from the head in
    the state (`_cg`), the rest of the iteration and the head of the
    next, and the residual check after the last one's rest. Returns the
    state entries it changes."""
    st = dict(st)
    out = {}
    k = settings.check_every
    for i in range(k):
        new = _cg(st, settings, mesh)
        new.update(_tail(dict(st, **new), settings, cone))
        if i == k - 1:
            new.update(_check(dict(st, **new), *variant[1:],
                              settings=settings, mesh=mesh, cone=cone,
                              use_cert=use_cert,
                              restart_checks=restart_checks))
        new.update(cg_head(dict(st, **new), settings, mesh))
        st.update(new)
        out.update(new)
    out["it"] = st["it"] + k
    return out


def solve_rowsharded(qp: QPData, mesh: Mesh, settings: Settings = Settings(),
                     x0=None, z0=None, y0=None) -> RowShardSolution:
    """Solve ONE QP with A, l, u and ρ split by constraint rows over the
    ranks of the mesh's data axis, in qp's dtype, on the mesh's device.

    Mixed cones are supported through the row interleaving (module
    docstring); optional UNSCALED (x0, z0, y0) warm start. The backend
    is the matrix-free row-sharded CG, so ρ adapts for free. Every rank
    passes the whole problem and gets the whole solution.
    """
    ndev = mesh.shape[DATA_AXIS]
    rank = mesh.coords[DATA_AXIS]
    m, n = qp.m, qp.n
    if m % ndev != 0:
        raise ValueError(f"m={m} rows not divisible by {ndev} devices")
    perm, cone_loc = uniform_row_permutation(qp.cone, m, ndev)
    dev = mesh.device
    qp = qp.to(dev)
    dtype = qp.dtype
    s = settings
    m_loc = m // ndev
    rows = slice(rank * m_loc, (rank + 1) * m_loc)

    # Global Ruiz scaling, in the original row order.
    qps, scaling = ruiz_equilibrate(qp, s.scaling_iters)
    mb, ml1 = qp.cone.m_box, qp.cone.m_l1
    lam_full = torch.zeros(m, dtype=dtype, device=dev)
    lam_full[mb:mb + ml1] = qps.lam
    eq = ((qps.l == qps.u) & torch.isfinite(qps.l)
          & (torch.arange(m, device=dev) < mb))

    def as_dev(t, k):
        return (torch.zeros(k, dtype=dtype, device=dev) if t is None
                else torch.as_tensor(t).to(dev, dtype))

    # Warm starts: scale, then permute into shard order.
    x = scaling.scale_x(as_dev(x0, n))
    z = scaling.scale_z(as_dev(z0, m))
    y = scaling.scale_y(as_dev(y0, m))
    row_leaves = [qps.A, qps.l, qps.u, lam_full, eq, scaling.e, z, y]
    if perm is not None:
        pidx = torch.as_tensor(perm, dtype=torch.long, device=dev)
        row_leaves = [t[pidx] for t in row_leaves]
    A_loc, l_loc, u_loc, lam_loc, eq_loc, e_loc, z, y = (
        t[rows] for t in row_leaves)
    d_v, c_v = scaling.d, scaling.c
    cd_inv = 1.0 / (c_v * d_v)
    k = s.check_every
    restart_checks = s.restart_every and max(1, s.restart_every // k)
    use_cert = s.eps_pinf > 0 or s.eps_dinf > 0
    mbl_box, mbl = cone_loc.m_box, cone_loc.m_box + cone_loc.m_l1

    # L1 gradient scale in the dual-norm reference (core.admm.
    # l1_grad_scale): L1 rows are row-local, so the column max takes a
    # max over the axis.
    if cone_loc.m_l1:
        lamA = (lam_loc[mbl_box:mbl, None]
                * A_loc[mbl_box:mbl].abs()).amax(dim=0)
        nlam = _pmax_abs(mesh, cd_inv * lamA)[0]
    else:
        nlam = torch.zeros((), dtype=dtype, device=dev)

    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    state = dict(
        A_loc=A_loc, l_loc=l_loc, u_loc=u_loc, lam_loc=lam_loc,
        eq_loc=eq_loc, e_loc=e_loc, einv_loc=1.0 / e_loc, P=qps.P, q=qps.q,
        d=d_v, c=c_v, cd_inv=cd_inv, nlam=nlam,
        x=x, z=z, y=y, x_chk=x, y_chk=y,
        x_sum=torch.zeros_like(x), z_sum=torch.zeros_like(z),
        y_sum=torch.zeros_like(y),
        rho_bar=torch.tensor(s.rho, dtype=dtype, device=dev),
        status=torch.tensor(_UNSOLVED, dtype=torch.int32, device=dev),
        r_p=inf, r_d=inf,
        flags=torch.zeros(1, dtype=torch.int32, device=dev),
        it=torch.zeros((), dtype=torch.int64, device=dev),
        cg_steps=torch.zeros((), dtype=torch.int32, device=dev))
    state.update(cg_head(state, s, mesh))
    step = functools.partial(rowshard_step, settings=s, mesh=mesh,
                             cone=cone_loc, use_cert=use_cert,
                             restart_checks=restart_checks)
    # The key holds plain values (cf. consensus.loop_static).
    loop = graph.CheckLoop(
        "solve_rowsharded", step, state, s, BACKEND, mesh=mesh,
        cone=cone_loc, use_cert=use_cert, restart_checks=restart_checks,
        interval_checks=max(1, s.adaptive_rho_interval // k),
        permuted=perm is not None,
        mesh_shape=tuple(sorted(mesh.shape.items())),
        mesh_coords=tuple(sorted(mesh.coords.items())))
    # flags: (status left UNSOLVED), agreed over every rank by the plain
    # loop.
    loop.run_checks(s, restart_checks, tag=("check",), refactor=False,
                    done=True, agree=functools.partial(runtime.agree,
                                                       mesh=mesh))
    x, z, y, status, r_p, r_d, rho_bar, cg_steps, it = loop.result(
        "x", "z", "y", "status", "r_p", "r_d", "rho_bar", "cg_steps", "it")
    status = torch.where(status == _UNSOLVED, int(Status.MAX_ITER),
                         status).to(torch.int32)

    # Gather the rows, unscale, and undo the row permutation.
    z = runtime.all_gather(z, mesh, DATA_AXIS)
    y = runtime.all_gather(y, mesh, DATA_AXIS)
    if perm is not None:
        inv = torch.argsort(pidx)
        z, y = z[inv], y[inv]
    return RowShardSolution(
        x=scaling.unscale_x(x), z=scaling.unscale_z(z),
        y=scaling.unscale_y(y), status=status,
        iters=it.to(torch.int32),
        r_prim=r_p, r_dual=r_d, rho=rho_bar, cg_steps=cg_steps)


def solve_rowsharded_hybrid(qp: QPData, mesh: Mesh,
                            settings: Settings = Settings()
                            ) -> RowShardSolution:
    """Hybrid-precision row-sharded solve: an f32 phase, then re-centred
    f32 rounds to the caller's eps on the original data (box cones).

    Phase 1 solves the f32 problem at the caller's eps. Each round then
    re-solves the same row-sharded program with data shifted around the
    accumulated iterate (q <- P x + q, bounds <- bounds - A x, computed
    in f64 and cast to f32), duals warm-started and replaced. Every
    iteration stays f32; the true residuals and the shifts are f64
    products on the device. The rounds solve correction problems that
    are feasible by construction, so they run without infeasibility
    certificates. The rounds' exit is a host branch on the true
    residuals, agreed over every rank.

    Problems with L1 or SOC rows take a single f32 phase at the relaxed
    hybrid_eps. Any other precision than 'hybrid' is solve_rowsharded.
    """
    if settings.precision != "hybrid":
        return solve_rowsharded(qp, mesh, settings)
    f32, f64 = torch.float32, torch.float64
    s1 = settings.replace(
        precision="single",
        sigma=max(settings.sigma, 1e-5),
        rho_eq_scale=min(settings.rho_eq_scale, 1e2),
        stall_checks=max(settings.stall_checks, 16))
    if qp.cone.m_l1 or qp.cone.m_soc:
        s_relaxed = s1.replace(
            eps_abs=max(settings.hybrid_eps, settings.eps_abs),
            eps_rel=max(settings.hybrid_eps, settings.eps_rel))
        return solve_rowsharded(qp.astype(f32), mesh, s_relaxed)

    qp = qp.to(mesh.device)
    sol = solve_rowsharded(qp.astype(f32), mesh, s1)
    qp64 = qp.astype(f64)
    A64, P64, q64 = qp64.A, qp64.P, qp64.q

    def true_resid(x_t, y_t, z_t):
        Ax = A64 @ x_t
        Px = P64 @ x_t
        Aty = y_t @ A64
        r_p = (Ax - z_t).abs().max()
        r_d = (Px + q64 + Aty).abs().max()
        eps_p = settings.eps_abs + settings.eps_rel * torch.maximum(
            Ax.abs().max(), z_t.abs().max())
        eps_d = settings.eps_abs + settings.eps_rel * torch.maximum(
            torch.maximum(Px.abs().max(), Aty.abs().max()),
            q64.abs().max())
        solved = (r_p <= eps_p) & (r_d <= eps_d)
        agreed = runtime.agree(solved.to(torch.int32)[None], mesh)
        return Ax, Px, r_p, r_d, bool(agreed)

    x_t, y_t, z_t = clean64(sol.x), clean64(sol.y), clean64(sol.z)
    iters, cg_steps, rho = sol.iters, sol.cg_steps, sol.rho
    # Correction problems are feasible by construction; certificates
    # there would judge shifted data.
    s_c = s1.replace(eps_pinf=0.0, eps_dinf=0.0)
    solved = False
    r_p, r_d = sol.r_prim, sol.r_dual
    for _ in range(max(settings.recenter_rounds, 0)):
        Ax, Px, r_p, r_d, solved = true_resid(x_t, y_t, z_t)
        if solved:
            break
        qp_c = QPData(P=qp.P.to(f32), q=(Px + q64).to(f32),
                      A=qp.A.to(f32), l=(qp64.l - Ax).to(f32),
                      u=(qp64.u - Ax).to(f32), lam=qp.lam.to(f32),
                      cone=qp.cone)
        solc = solve_rowsharded(qp_c, mesh, s_c,
                                x0=torch.zeros_like(qp_c.q),
                                z0=(z_t - Ax).to(f32), y0=y_t.to(f32))
        x_t = x_t + clean64(solc.x)
        y_t = clean64(solc.y)
        z_t = Ax + clean64(solc.z)
        iters = iters + solc.iters
        cg_steps = cg_steps + solc.cg_steps
        rho = solc.rho
    if not solved:
        _, _, r_p, r_d, solved = true_resid(x_t, y_t, z_t)
    d = qp.dtype
    return RowShardSolution(
        x=x_t.to(d), z=z_t.to(d), y=y_t.to(d),
        status=torch.tensor(int(Status.SOLVED if solved
                                else Status.MAX_ITER),
                            dtype=torch.int32, device=mesh.device),
        iters=iters, r_prim=r_p.to(d), r_dual=r_d.to(d), rho=rho,
        cg_steps=cg_steps)
