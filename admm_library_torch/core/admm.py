"""ADMM core: one iteration, residuals, termination and infeasibility
tests (OSQP, arXiv:1711.08013) on

    min ½xᵀPx + qᵀx + g(z)   s.t.  Ax = z,

with g the product-cone indicator/penalty (ops/prox). One iteration
(diagonal penalty R = diag(rho_vec)):

    x̃   = (P + σI + AᵀRA)⁻¹ (σx − q + Aᵀ(Rz − y))
    z̃   = A x̃
    x⁺  = α x̃ + (1−α) x
    w   = α z̃ + (1−α) z
    z⁺  = Π_g(w + y/R)
    y⁺  = y + R (w − z⁺)

Iterates are lane-batched rows: x (B, n), z and y (B, m), against one
shared (P, A) or, for a batch of independent problems, against one
(P, A) per lane (problem.mv / vm take both). The iterations and checks
work on the Ruiz-scaled problem; residuals and termination use unscaled
quantities through the Scaling vectors. `run_phase` runs a whole phase
from the raw data (cast, Ruiz scaling, factor, checks, refactors,
unscale) as the segments of one loop (core/graph.py).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import kkt
from ..ops.prox import project_cone
from ..precision import clean64
from ..problem import QPData, is_equality_row, mv, objective, vm
from ..settings import Settings
from ..solution import Status
from ..utils import trace
from . import graph
from .scaling import Scaling, ruiz_equilibrate

_UNSOLVED = int(Status.UNSOLVED)


def linf(v):
    return v.abs().amax(dim=-1)


def rho_vec_of(rho_bar, eq_mask, settings: Settings, cone=None):
    """Per-row penalty: rho_bar, boosted on equality rows (OSQP §5.2)
    and, with Settings.rho_soc_scale != 1, uniformly on SOC rows."""
    rv = torch.where(eq_mask, settings.rho_eq_scale * rho_bar, rho_bar)
    if cone is not None and cone.m_soc and settings.rho_soc_scale != 1.0:
        m = rv.shape[-1]
        soc = torch.arange(m, device=rv.device) >= (m - cone.m_soc)
        rv = torch.where(soc, settings.rho_soc_scale * rho_bar, rv)
    return rv


def is_equality_row_shared(qp: QPData):
    """Equality-row mask shared across a bound-batched problem: a
    dispersion perturbs bound values, not which rows are equalities, so
    lane 0's mask holds for every lane and the factor stays shared."""
    eq = is_equality_row(qp)
    return eq[0] if eq.dim() > 1 else eq


def admm_iteration(qp: QPData, fac, x, z, y, rho_vec, settings: Settings,
                   backend: str, z_off=None):
    """One ADMM iteration on the scaled problem (the plain body).

    z_off: optional shifted-prox offset for L1/SOC rows (re-centred
    refinement; see ops/prox.project_cone).
    """
    rhs = settings.sigma * x - qp.q + vm(rho_vec * z - y, qp.A)
    xt = kkt.solve_condensed(fac, rhs, backend,
                             refine_steps=settings.refine_steps,
                             cg_tol=settings.cg_tol,
                             cg_max_iter=settings.cg_max_iter)
    zt = mv(qp.A, xt)
    a = settings.alpha
    x_new = a * xt + (1.0 - a) * x
    w = a * zt + (1.0 - a) * z
    v = w + y / rho_vec
    mb, ml = qp.cone.m_box, qp.cone.m_l1
    lam_over_rho = (qp.lam / rho_vec[..., mb:mb + ml]) if ml else qp.lam
    z_new = project_cone(v, qp.l, qp.u, lam_over_rho, qp.cone,
                         offset=z_off)
    y_new = y + rho_vec * (w - z_new)
    return x_new, z_new, y_new


def iterate_block(qp, fac, x, z, y, rho_vec, settings, backend, k: int,
                  z_off=None):
    """Run k plain iterations, inside the span 'iterate_block'."""
    with trace.span("iterate_block"):
        for _ in range(k):
            x, z, y = admm_iteration(qp, fac, x, z, y, rho_vec, settings,
                                     backend, z_off=z_off)
    return x, z, y


def l1_grad_scale(qp: QPData, scaling: Scaling):
    """Unscaled L1 objective gradient bound max_j max_i λᵢ|A_l1[i, j]|,
    folded into the dual-residual scale: on min-fuel LPs (P ≈ 0, q = 0)
    the objective lives entirely in λ. 0 when m_l1 == 0."""
    cone = qp.cone
    if not cone.m_l1:
        return torch.zeros((), dtype=qp.dtype, device=qp.device)
    mb, ml = cone.m_box, cone.m_l1
    cd_inv = 1.0 / (scaling.c * scaling.d)
    lamA = (qp.lam[..., :, None] * qp.A[..., mb:mb + ml, :].abs()).amax(-2)
    return linf(cd_inv * lamA)


def l1_grad_scale_raw(qp: QPData):
    """l1_grad_scale for unscaled data (the f64 acceptance checks of the
    re-centred path use the same eps_d reference as the solver loop)."""
    cone = qp.cone
    if not cone.m_l1:
        return torch.zeros((), dtype=qp.dtype, device=qp.device)
    mb, ml = cone.m_box, cone.m_l1
    return (qp.lam[..., :, None] * qp.A[..., mb:mb + ml, :].abs()).amax()


def unscaled_criterion(qp: QPData, x, z, y, eps_abs: float, eps_rel: float):
    """Residuals of an unscaled point (x, z, y) on unscaled data, and the
    solver loop's mixed stopping criterion (eps_d includes the L1
    gradient scale, or min-fuel points that the loop calls SOLVED would
    fail it): (Ax, Px, r_p, r_d, eps_p, eps_d, solved)."""
    Ax = x @ qp.A.mT
    Px = x @ qp.P.mT
    Aty = y @ qp.A
    r_p = linf(Ax - z)
    r_d = linf(Px + qp.q + Aty)
    eps_p = eps_abs + eps_rel * torch.maximum(linf(Ax), linf(z))
    eps_d = eps_abs + eps_rel * torch.maximum(
        torch.maximum(linf(Px), linf(Aty)),
        torch.maximum(linf(qp.q), l1_grad_scale_raw(qp)))
    return Ax, Px, r_p, r_d, eps_p, eps_d, (r_p <= eps_p) & (r_d <= eps_d)


def residuals(qp: QPData, scaling: Scaling, x, z, y, nlam=None):
    """Unscaled residual norms and eps_rel scale factors:
    (r_prim, r_dual, norm_Ax, norm_z, norm_Px, norm_Aty, norm_q), where
    norm_q includes the L1 gradient scale. Inputs are SCALED iterates."""
    einv = 1.0 / scaling.e
    cd_inv = 1.0 / (scaling.c * scaling.d)
    Ax = mv(qp.A, x)
    Px = mv(qp.P, x)
    Aty = vm(y, qp.A)
    r_prim = linf(einv * (Ax - z))
    r_dual = linf(cd_inv * (Px + qp.q + Aty))
    if nlam is None:
        nlam = l1_grad_scale(qp, scaling)
    return (r_prim, r_dual,
            linf(einv * Ax), linf(einv * z),
            linf(cd_inv * Px), linf(cd_inv * Aty),
            torch.maximum(linf(cd_inv * qp.q), nlam))


def eps_thresholds(res, settings: Settings):
    (_, _, nAx, nz, nPx, nAty, nq) = res
    eps_p = settings.eps_abs + settings.eps_rel * torch.maximum(nAx, nz)
    eps_d = settings.eps_abs + settings.eps_rel * torch.maximum(
        torch.maximum(nPx, nAty), nq)
    return eps_p, eps_d


def _support_box(dy, l, u, eps):
    """sup_{z in [l,u]} zᵀdy; +inf where an unbounded side is reached."""
    inf = torch.full_like(dy, float("inf"))
    up = torch.where(dy > eps, torch.where(torch.isfinite(u), u * dy, inf),
                     0.0)
    lo = torch.where(dy < -eps, torch.where(torch.isfinite(l), l * dy, inf),
                     0.0)
    return (up + lo).sum(-1)


def _soc_all_within(v, cone, t_sign: float, eps):
    """Per lane: every SOC block (t, u) of v has ||u|| <= t_sign*t + eps."""
    def ok(blk):
        return (torch.linalg.vector_norm(blk[..., 1:], dim=-1)
                <= t_sign * blk[..., 0] + eps)

    if cone.soc_uniform:
        d = cone.soc_dims[0]
        return ok(v.reshape(v.shape[:-1] + (cone.n_soc, d))).all(-1)
    oks = []
    off = 0
    for d in cone.soc_dims:
        oks.append(ok(v[..., off:off + d]))
        off += d
    return torch.stack(oks, dim=-1).all(-1)


def infeasibility(qp: QPData, scaling: Scaling, dx_s, dy_s, settings):
    """OSQP §3.4 infeasibility certificates from the SCALED iterate
    deltas across the last check interval, extended to L1 rows (a dual
    ray needs dy = 0 there) and SOC rows (support 0 iff -dy in the cone;
    a recession direction must lie in the cone).
    Returns (primal_infeasible, dual_infeasible) per lane."""
    cone = qp.cone
    mb, ml = cone.m_box, cone.m_l1
    dtype = dx_s.dtype
    tiny = torch.finfo(dtype).tiny
    eps_p = settings.eps_pinf
    eps_d = settings.eps_dinf

    # ---- primal infeasibility from dy ----
    dy = scaling.unscale_y(dy_s)
    ndy = linf(dy)
    dyn = dy / torch.clamp(ndy, min=tiny)[..., None]
    Aty = vm(scaling.scale_y(dyn), qp.A) / (scaling.c * scaling.d)
    cond_A = linf(Aty) <= eps_p
    mbl = mb + ml
    lu_l = qp.l[..., :mbl] / scaling.e[..., :mbl]
    lu_u = qp.u[..., :mbl] / scaling.e[..., :mbl]
    sup = _support_box(dyn[..., :mbl], lu_l, lu_u, eps_p)
    if cone.m_soc:
        # The SOC indicator's support is 0 iff -dy lies in the cone.
        bad_soc = ~_soc_all_within(dyn[..., mbl:], cone, -1.0, eps_p)
        sup = torch.where(bad_soc, float("inf"), sup)
    primal_infeas = (ndy > 0) & cond_A & (sup <= eps_p)

    # ---- dual infeasibility (unboundedness) from dx ----
    dx = scaling.unscale_x(dx_s)
    ndx = linf(dx)
    dxn = dx / torch.clamp(ndx, min=tiny)[..., None]
    Pdx = mv(qp.P, dxn / scaling.d) / (scaling.c * scaling.d)
    Adx = mv(qp.A, dxn / scaling.d) / scaling.e
    cond_P = linf(Pdx) <= eps_d
    qdx = ((qp.q / (scaling.c * scaling.d)) * dxn).sum(-1)
    if ml:
        lam_unscaled = qp.lam * scaling.e[..., mb:mb + ml] / scaling.c
        qdx = qdx + (lam_unscaled * Adx[..., mb:mb + ml].abs()).sum(-1)
    cond_q = qdx <= -eps_d
    # Recession of the constraint domain over box + bounded-L1 rows.
    bl = qp.l[..., :mbl] / scaling.e[..., :mbl]
    bu = qp.u[..., :mbl] / scaling.e[..., :mbl]
    av = Adx[..., :mbl]
    ok_up = (av <= eps_d) | ~torch.isfinite(bu)
    ok_lo = (av >= -eps_d) | ~torch.isfinite(bl)
    dual_infeas = ((ndx > 0) & cond_P & cond_q
                   & (ok_up & ok_lo).all(-1))
    if cone.m_soc:
        # A recession direction must lie in the cone.
        dual_infeas = dual_infeas & _soc_all_within(Adx[..., mbl:], cone,
                                                    1.0, eps_d)
    return primal_infeas, dual_infeas


def restart_cadence_checks(settings: Settings) -> int:
    """Restart boundary in units of residual checks (0 disables)."""
    if settings.restart_every <= 0:
        return 0
    return max(1, settings.restart_every // settings.check_every)


def scaled_resid_ratio(res, settings: Settings):
    """max(r_p/eps_p, r_d/eps_d): the termination criterion as one
    number, so 'better' means 'closer to stopping'."""
    eps_p, eps_d = eps_thresholds(res, settings)
    return torch.maximum(res[0] / eps_p, res[1] / eps_d)


def status_of(numerr, solved, pinf, dinf, like):
    """Status codes from the check's verdicts: a NaN residual first,
    then solved, primal and dual infeasibility, else UNSOLVED."""
    st = torch.full_like(like, _UNSOLVED)
    st = torch.where(dinf, int(Status.DUAL_INFEASIBLE), st)
    st = torch.where(pinf, int(Status.PRIMAL_INFEASIBLE), st)
    st = torch.where(solved, int(Status.SOLVED), st)
    return torch.where(numerr, int(Status.NUMERICAL_ERROR), st)


def adapt_rho(rho_bar, res, settings: Settings):
    """OSQP §5.2 residual-balancing rho update; returns (new_rho,
    changed)."""
    r_prim, r_dual, nAx, nz, nPx, nAty, nq = res
    tiny = torch.finfo(rho_bar.dtype).tiny
    sp = r_prim / torch.clamp(torch.maximum(nAx, nz), min=tiny)
    sd = r_dual / torch.clamp(torch.maximum(torch.maximum(nPx, nAty), nq),
                              min=tiny)
    ratio = torch.sqrt(sp / torch.clamp(sd, min=tiny))
    new = torch.clamp(rho_bar * ratio, settings.rho_min, settings.rho_max)
    tol = settings.adaptive_rho_tol
    changed = (ratio > tol) | (ratio < 1.0 / tol)
    return torch.where(changed, new, rho_bar), changed


class AdmmCarry(NamedTuple):
    """Final state of `run_admm` (scaled iterates)."""
    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    rho_bar: torch.Tensor       # scalar penalty level
    fac: dict                   # the KKT factor of the last rho
    it: torch.Tensor            # iterations run (int32)
    status: torch.Tensor        # int32 Status
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    hist: torch.Tensor          # (slots, 3) residual ring buffer


def check_variant(check: int, settings: Settings, restart_checks: int):
    """(restart, rho_test) of check number `check`: whether it ends a
    restart window and whether it runs the adaptive-rho test
    (`graph.variant_at`, which the phase's nodes evaluate on the card on
    the device's iteration counter)."""
    return graph.variant_at(check, restart_checks,
                            graph.interval_checks(settings))


def problem_state(qp: QPData, scaling: Scaling, fac, eq_mask, z_off):
    """The read-only part of a check's state: the scaled problem, its
    scaling, the KKT factor (rewritten by a refactor), the equality-row
    mask and, where given, the shifted-prox offset."""
    state = dict(qp=dict(P=qp.P, q=qp.q, A=qp.A, l=qp.l, u=qp.u,
                         lam=qp.lam),
                 scaling=dict(d=scaling.d, e=scaling.e, c=scaling.c),
                 fac=fac, eq_mask=eq_mask)
    if z_off is not None:
        state["z_off"] = z_off
    return state


def problem_of(state, cone):
    """(QPData, Scaling) of a check's state."""
    return (QPData(**state["qp"], cone=cone),
            Scaling(**state["scaling"]))


def hist_write(hist, check, row, lanes=None):
    """hist (…, slots, 3) with `row` (…, 3) in slot check % slots, only
    on `lanes` where given: a select against a one-hot mask, since the
    check count is a device counter."""
    slots = hist.shape[-2]
    hit = torch.arange(slots, device=hist.device) == check % slots
    if lanes is None:
        return torch.where(hit[:, None], row, hist)
    return torch.where(hit[None, :, None] & lanes[:, None, None],
                       row[:, None, :], hist)


def carry_state(x0, z0, y0, rho_bar, status, big, since_best, hist):
    """The starting carry every loop shares: iterates, rho and its
    proposal, the iteration counter, status and residuals (`big`), the
    last check's iterates, the restart sums, the stall counter, the
    history and the flags."""
    dev = x0.device
    return dict(x=x0, z=z0, y=y0, rho_bar=rho_bar, new_rho=rho_bar,
                it=torch.zeros((), dtype=torch.int64, device=dev),
                status=status, r_prim=big, r_dual=big, x_chk=x0, y_chk=y0,
                x_sum=torch.zeros_like(x0), z_sum=torch.zeros_like(z0),
                y_sum=torch.zeros_like(y0), best_ratio=big,
                since_best=since_best, hist=hist,
                flags=torch.ones(2, dtype=torch.bool, device=dev))


def admm_check(state, variant, *, cone, settings: Settings, backend: str,
               restart_checks: int):
    """One residual check of `run_admm`: check_every iterations, the
    restarted averaging, the termination and infeasibility tests, the
    NaN tripwire, the stall exit and, in the rho-test variant, the
    adaptive-rho proposal. Returns the state entries it changes; 'flags'
    holds (status is UNSOLVED, refactor)."""
    restart, rho_test = variant
    qp, scaling = problem_of(state, cone)
    k = settings.check_every
    rho_bar = state["rho_bar"]
    rho_vec = rho_vec_of(rho_bar, state["eq_mask"], settings, cone)
    x, z, y = iterate_block(qp, state["fac"], state["x"], state["z"],
                            state["y"], rho_vec, settings, backend, k,
                            z_off=state.get("z_off"))
    res = residuals(qp, scaling, x, z, y)

    # Restarted averaging: at each restart boundary adopt the running
    # average of the check-cadence iterates iff its scaled residuals
    # beat the current iterate's. The window always holds
    # restart_checks checks: the loop starts at check 0.
    x_sum, z_sum, y_sum = (state["x_sum"] + x, state["z_sum"] + z,
                           state["y_sum"] + y)
    if restart:
        denom = float(restart_checks)
        xa, za, ya = x_sum / denom, z_sum / denom, y_sum / denom
        res_a = residuals(qp, scaling, xa, za, ya)
        take = (scaled_resid_ratio(res_a, settings)
                < scaled_resid_ratio(res, settings))
        x, z, y = (torch.where(take, a, b)
                   for a, b in ((xa, x), (za, z), (ya, y)))
        res = tuple(torch.where(take, ra, rc) for ra, rc in zip(res_a, res))
        x_sum, z_sum, y_sum = (torch.zeros_like(t)
                               for t in (x_sum, z_sum, y_sum))

    r_prim, r_dual = res[0], res[1]
    eps_p, eps_d = eps_thresholds(res, settings)
    solved = (r_prim <= eps_p) & (r_dual <= eps_d)
    pinf, dinf = infeasibility(qp, scaling, x - state["x_chk"],
                               y - state["y_chk"], settings)
    # NaN tripwire: a failed factorisation or a divergent iterate
    # poisons the residuals; stop instead of spinning to max_iter.
    numerr = ~(torch.isfinite(r_prim) & torch.isfinite(r_dual))
    status = status_of(numerr, solved, pinf, dinf, state["status"])

    # Stall exit: no new best scaled ratio for a whole window.
    ratio_now = scaled_resid_ratio(res, settings)
    improved = ratio_now < state["best_ratio"]
    best_ratio = torch.minimum(ratio_now, state["best_ratio"])
    since_best = torch.where(improved, 0, state["since_best"] + 1)
    if settings.stall_checks > 0:
        stalled = since_best >= settings.stall_checks
        status = torch.where((status == _UNSOLVED) & stalled,
                             int(Status.STALLED), status)

    do_t = torch.zeros((), dtype=torch.bool, device=x.device)
    new_rho = state["new_rho"]
    if rho_test:
        new_rho, changed = adapt_rho(rho_bar, res, settings)
        do_t = changed & (status == _UNSOLVED)

    it = state["it"] + k
    out = dict(x=x, z=z, y=y, x_sum=x_sum, z_sum=z_sum, y_sum=y_sum,
               status=status, r_prim=r_prim, r_dual=r_dual,
               best_ratio=best_ratio, since_best=since_best,
               new_rho=new_rho, it=it, x_chk=x, y_chk=y,
               flags=torch.stack([status == _UNSOLVED, do_t]))
    hist = state["hist"]
    if hist.shape[-2] > 0:
        row = torch.stack([it.to(hist.dtype), r_prim, r_dual])
        out["hist"] = hist_write(hist, state["it"] // k, row)
    return out


def _select(mask, new, old):
    """Per-lane select between two tensors that lead with the lane axis."""
    return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def lanes_check(state, variant, *, cone, settings: Settings, backend: str,
                restart_checks: int):
    """One residual check of `run_admm_lanes`, each lane against its own
    state; lanes that left UNSOLVED keep theirs. Returns the state
    entries it changes; 'do_t' holds the lanes whose rho test fired,
    'flags' (any lane UNSOLVED, any refactor)."""
    restart, rho_test = variant
    qp, scaling = problem_of(state, cone)
    k = settings.check_every
    x, z, y = state["x"], state["z"], state["y"]
    status, rho_bar = state["status"], state["rho_bar"]
    B = x.shape[0]
    active = status == _UNSOLVED
    rho_vec = rho_vec_of(rho_bar[:, None], state["eq_mask"], settings, cone)
    xn, zn, yn = iterate_block(qp, state["fac"], x, z, y, rho_vec, settings,
                               backend, k, z_off=state.get("z_off"))
    res = residuals(qp, scaling, xn, zn, yn)

    # Restarted averaging, each lane against its own average (live
    # lanes all share the check count, hence the boundary).
    x_sum, z_sum, y_sum = (state["x_sum"] + xn, state["z_sum"] + zn,
                           state["y_sum"] + yn)
    if restart:
        denom = float(restart_checks)
        xa, za, ya = x_sum / denom, z_sum / denom, y_sum / denom
        res_a = residuals(qp, scaling, xa, za, ya)
        take = (scaled_resid_ratio(res_a, settings)
                < scaled_resid_ratio(res, settings))
        xn, zn, yn = (_select(take, a, b)
                      for a, b in ((xa, xn), (za, zn), (ya, yn)))
        res = tuple(torch.where(take, ra, rc) for ra, rc in zip(res_a, res))
        x_sum, z_sum, y_sum = (torch.zeros_like(t)
                               for t in (x_sum, z_sum, y_sum))

    rp_now, rd_now = res[0], res[1]
    eps_p, eps_d = eps_thresholds(res, settings)
    solved = (rp_now <= eps_p) & (rd_now <= eps_d)
    pinf, dinf = infeasibility(qp, scaling, xn - state["x_chk"],
                               yn - state["y_chk"], settings)
    numerr = ~(torch.isfinite(rp_now) & torch.isfinite(rd_now))
    new_status = status_of(numerr, solved, pinf, dinf, status)

    ratio_now = scaled_resid_ratio(res, settings)
    best = state["best_ratio"]
    improved = ratio_now < best
    best_ratio = torch.where(active, torch.minimum(ratio_now, best), best)
    since = state["since_best"]
    since_best = torch.where(active, torch.where(improved, 0, since + 1),
                             since)
    if settings.stall_checks > 0:
        stalled = since_best >= settings.stall_checks
        new_status = torch.where((new_status == _UNSOLVED) & stalled,
                                 int(Status.STALLED), new_status)

    do_t = torch.zeros(B, dtype=torch.bool, device=x.device)
    new_rho = state["new_rho"]
    if rho_test:
        new_rho, changed = adapt_rho(rho_bar, res, settings)
        do_t = active & changed & (new_status == _UNSOLVED)

    it = state["it"] + k
    out = dict(x_sum=x_sum, z_sum=z_sum, y_sum=y_sum, best_ratio=best_ratio,
               since_best=since_best, new_rho=new_rho, do_t=do_t, it=it)
    hist = state["hist"]
    if hist.shape[-2] > 0:
        row = torch.stack([it.to(hist.dtype).expand_as(rp_now), rp_now,
                           rd_now], dim=-1)
        out["hist"] = hist_write(hist, state["it"] // k, row, active)

    # Frozen lanes keep their state.
    x, z, y = (_select(active, a, b) for a, b in ((xn, x), (zn, z), (yn, y)))
    status = torch.where(active, new_status, status)
    out.update(x=x, z=z, y=y, x_chk=x, y_chk=y, status=status,
               r_prim=torch.where(active, rp_now, state["r_prim"]),
               r_dual=torch.where(active, rd_now, state["r_dual"]),
               iters=state["iters"] + active.to(torch.int32) * k,
               flags=torch.stack([(status == _UNSOLVED).any(),
                                  do_t.any()]))
    return out


# The named segments of a phase loop besides its checks.
PROLOGUE, EPILOGUE = ("prologue",), ("epilogue",)
REFACTOR = graph.REFACTOR
# Settings the prologue reads besides graph.CHECK_FIELDS: they enter the
# loop's key.
PROLOGUE_FIELDS = ("scaling_iters", "warm_start", "rho", "band_block",
                   "spike_parts")
QP_FIELDS = ("P", "q", "A", "l", "u", "lam")
_PINF = int(Status.PRIMAL_INFEASIBLE)
_DINF = int(Status.DUAL_INFEASIBLE)
# The floating leaves of a Solution.
FLOAT_LEAVES = ("x", "z", "y", "r_prim", "r_dual", "obj", "rho", "history")


def qp_leaves(qp: QPData) -> dict:
    return {f: getattr(qp, f) for f in QP_FIELDS}


def _rho_vec(rho_bar, eq_mask, settings: Settings, cone, lanes: bool):
    return rho_vec_of(rho_bar[:, None] if lanes else rho_bar, eq_mask,
                      settings, cone)


def factor(P, A, rho_bar, eq_mask, settings: Settings, backend: str, cone,
           lanes: bool = False):
    """The KKT factor of rho-bar (one value, or one a lane with
    `lanes`)."""
    return kkt.factor_condensed(
        P, A, settings.sigma, _rho_vec(rho_bar, eq_mask, settings, cone,
                                       lanes),
        backend, settings.band_block, settings.spike_parts)


def phase_prologue(state, *, cone, settings: Settings, backend: str, dtype,
                   scale: str, lanes: bool):
    """A phase's start from its raw entries (problem 'raw', warm start
    'x0', 'z0', 'y0', and where given the scaling 'sc', the warm rho-bar
    'rho0' and the unscaled shifted-prox offset 'z_off0'), cast to
    `dtype` (the warm start of a second phase, which holds the first's
    'p1', through precision.clean64): the scaled problem (`scale`
    'ruiz': Ruiz equilibration; 'scaled': the data is already scaled by
    'sc'), the scaled warm start and offset, the equality rows, rho, the
    KKT factor and the starting carry."""
    qp = QPData(**state["raw"], cone=cone).astype(dtype)
    if "p1" in state:
        x0, z0, y0 = (clean64(state[k]) for k in ("x0", "z0", "y0"))
    else:
        x0, z0, y0 = (state[k].to(dtype) for k in ("x0", "z0", "y0"))
    z_off = state.get("z_off0")
    if scale == "scaled":
        qps, scaling = qp, Scaling(**state["sc"])
        xs, zs, ys = x0, z0, y0
    else:
        qps, scaling = ruiz_equilibrate(qp, settings.scaling_iters)
        if settings.warm_start:
            xs = scaling.scale_x(x0)
            zs = scaling.scale_z(z0)
            ys = scaling.scale_y(y0)
        else:
            xs, zs, ys = x0, z0, y0
        if z_off is not None:
            z_off = scaling.scale_z(z_off)  # offsets live in z-space
    dev = x0.device
    eq_mask = is_equality_row(qps)
    rho_bar = (state["rho0"] if "rho0" in state else
               torch.full((), settings.rho, dtype=dtype, device=dev))
    slots = max(settings.history, 0)
    lead = (qps.P.shape[0],) if lanes else ()
    if lanes:
        rho_bar = rho_bar.expand(lead).clone()
    out = problem_state(qps, scaling, factor(qps.P, qps.A, rho_bar, eq_mask,
                                             settings, backend, cone, lanes),
                        eq_mask, z_off)
    out.update(carry_state(
        xs, zs, ys, rho_bar,
        torch.full(lead, _UNSOLVED, dtype=torch.int32, device=dev),
        torch.full(lead, float("inf"), dtype=dtype, device=dev),
        torch.zeros(lead, dtype=torch.int32, device=dev),
        torch.full(lead + (slots, 3), -1.0, dtype=dtype, device=dev)))
    if lanes:
        out.update(iters=torch.zeros(lead, dtype=torch.int32, device=dev),
                   do_t=torch.zeros(lead, dtype=torch.bool, device=dev))
    return out


def phase_refactor(state, *, cone, settings: Settings, backend: str,
                   lanes: bool):
    """The factor of the rho the last check proposed ('new_rho'); lanes
    take it only where their own rho test fired ('do_t'). The matrix-free
    'cg' factor takes the new rho vectors only."""
    eq_mask, fac = state["eq_mask"], state["fac"]
    if lanes:
        do_t = state["do_t"]
        rho_bar = torch.where(do_t, state["new_rho"], state["rho_bar"])
    else:
        rho_bar = state["new_rho"]
    if backend == "cg":
        fac = dict(fac, rho=_rho_vec(rho_bar, eq_mask, settings, cone,
                                     lanes))
    else:
        d = state["qp"]
        new_fac = factor(d["P"], d["A"], rho_bar, eq_mask, settings,
                         backend, cone, lanes)
        fac = ({key: _select(do_t, new_fac[key], fac[key]) for key in fac}
               if lanes else new_fac)
    return dict(rho_bar=rho_bar, fac=fac)


def join_phases(out: dict, p1: dict, out_dtype) -> dict:
    """Two phases' result: the second phase's leaves `out` cast to
    `out_dtype`, a first-phase infeasibility verdict kept, the
    iterations of both phases summed (`p1` holds the first phase's
    'status' and 'iters')."""
    p1_inf = (p1["status"] == _PINF) | (p1["status"] == _DINF)
    out = {k: v.to(out_dtype) if k in FLOAT_LEAVES else v
           for k, v in out.items()}
    out.update(status=torch.where(p1_inf, p1["status"], out["status"]),
               iters=p1["iters"] + out["iters"])
    return out


def phase_epilogue(state, *, cone, dtype, scale: str, lanes: bool):
    """'out': the Solution's leaves, UNSOLVED reported as MAX_ITER;
    unless the loop was given scaled data (`scale` 'scaled'), the
    iterates unscaled and the objective on the raw data; where the loop
    holds a first phase's 'p1', the two phases joined in the raw data's
    dtype (`join_phases`)."""
    status = state["status"]
    out = dict(status=torch.where(status == _UNSOLVED, int(Status.MAX_ITER),
                                  status),
               iters=(state["iters"] if lanes
                      else state["it"].to(torch.int32)),
               r_prim=state["r_prim"], r_dual=state["r_dual"],
               rho=state["rho_bar"], history=state["hist"])
    x, z, y = state["x"], state["z"], state["y"]
    if scale != "scaled":
        scaling = Scaling(**state["scaling"])
        x = scaling.unscale_x(x)
        z = scaling.unscale_z(z)
        y = scaling.unscale_y(y)
        out["obj"] = objective(QPData(**state["raw"], cone=cone).astype(dtype),
                               x, z)
    out.update(x=x, z=z, y=y)
    if "p1" in state:
        out = join_phases(out, state["p1"], state["raw"]["P"].dtype)
    return dict(out=out)


def phase_step(state, variant, *, cone, settings: Settings, backend: str,
               restart_checks: int, dtype, scale: str, lanes: bool):
    """A segment of a phase loop: PROLOGUE, REFACTOR, EPILOGUE, or the
    check `variant` = (restart, rho_test) (`admm_check`, or
    `lanes_check` for a batch of independent problems)."""
    if variant == PROLOGUE:
        return phase_prologue(state, cone=cone, settings=settings,
                              backend=backend, dtype=dtype, scale=scale,
                              lanes=lanes)
    if variant == REFACTOR:
        return phase_refactor(state, cone=cone, settings=settings,
                              backend=backend, lanes=lanes)
    if variant == EPILOGUE:
        return phase_epilogue(state, cone=cone, dtype=dtype, scale=scale,
                              lanes=lanes)
    check = lanes_check if lanes else admm_check
    return check(state, variant, cone=cone, settings=settings,
                 backend=backend, restart_checks=restart_checks)


def run_phase(qp: QPData, x0, z0, y0, settings: Settings, backend: str, *,
              dtype=None, scaling=None, rho0=None, z_off=None, p1=None):
    """One ADMM phase from raw data, the counterpart of the JAX package's
    compiled `_solve_one_phase`: PROLOGUE, the loop over residual
    checks with a REFACTOR wherever a check asks for one
    (`graph.CheckLoop.run_checks`), EPILOGUE. Each is a segment of one
    `graph.CheckLoop` (`phase_step`), on the card a CUDA graph replay
    where `graph.capturable` allows: the checks and refactors one graph
    whose WHILE node runs them with no host read, the counterpart of the
    reference's `lax.while_loop`; elsewhere the host loop reads one small
    tensor a check (liveness and the refactor flag). On 'cg' each
    iteration's CG is conditional nodes inside the check's body
    (ops/kkt.cg_solve); on 'pallas_cg' kernel 2's library and plan are
    resolved before the prologue (ops/kkt.prepare).

    Every check runs check_every iterations, then the restarted
    averaging, the termination and infeasibility tests, the NaN
    tripwire, the stall exit and, on its cadence, the adaptive rho. A
    run that ends UNSOLVED reports MAX_ITER. `qp` with a lane axis on
    every leaf (P (B, n, n), A (B, m, n)) runs B independent problems in
    lockstep (`lanes_check`): each lane with its own rho, factor,
    restart averaging, stall counter, status and history; a lane that
    leaves UNSOLVED freezes with its own iteration count, and the loop
    runs while any lane is live.

    dtype: the phase's dtype (default qp's); scaling: where given, qp is
    already scaled by it (no Ruiz, the iterates stay scaled); rho0: warm
    rho-bar (a float or a tensor: held in the state, so a loop keeps its
    key whatever the value); z_off: shifted-prox offset for L1/SOC rows
    (unscaled, or scaled with `scaling`); p1: the first phase's 'status'
    and 'iters' where this is the second phase of a hybrid solve: its
    warm start (the first phase's iterates) goes through clean64, and
    the epilogue joins the two phases in qp's dtype. Returns the loop;
    its state 'out' holds the Solution's leaves ('iters' the iterations
    it ran, on the device).
    """
    lanes = qp.P.dim() == 3
    dtype = qp.dtype if dtype is None else dtype
    cone = qp.cone
    state = dict(raw=qp_leaves(qp), x0=x0, z0=z0, y0=y0)
    if scaling is not None:
        state["sc"] = dict(d=scaling.d, e=scaling.e, c=scaling.c)
    if rho0 is not None:
        state["rho0"] = torch.as_tensor(rho0, dtype=dtype, device=qp.device)
    if z_off is not None:
        state["z_off0"] = z_off
    if p1 is not None:
        state["p1"] = dict(status=p1["status"], iters=p1["iters"])
    restart_checks = restart_cadence_checks(settings)
    static = dict(cone=cone, restart_checks=restart_checks, dtype=dtype,
                  scale="ruiz" if scaling is None else "scaled")
    step = functools.partial(phase_step, settings=settings, backend=backend,
                             lanes=lanes, **static)
    loop = graph.CheckLoop(
        "run_admm_lanes" if lanes else "run_admm", step, state, settings,
        backend, **static,
        **{f: getattr(settings, f) for f in PROLOGUE_FIELDS})
    if not lanes:
        kkt.prepare(backend, 1, qp.n, dtype, qp.device)
    loop(PROLOGUE)
    loop.run_checks(settings, restart_checks)
    loop(EPILOGUE)
    return loop


def run_admm(qp: QPData, scaling: Scaling, settings: Settings,
             x0, z0, y0, backend: str, z_off=None, rho0=None) -> AdmmCarry:
    """Solve one scaled problem (`run_phase` on data already scaled by
    `scaling`, iterates left scaled). z_off: optional scaled
    shifted-prox offset for L1/SOC rows; rho0: optional initial rho-bar
    (warm rho)."""
    return _carry(run_phase(qp, x0, z0, y0, settings, backend,
                            scaling=scaling, rho0=rho0, z_off=z_off))


def run_admm_lanes(qp: QPData, scaling: Scaling, settings: Settings,
                   x0, z0, y0, backend: str, z_off=None,
                   rho0=None) -> AdmmCarry:
    """`run_admm` over B independent scaled problems in lockstep: every
    leaf of `qp` leads with the lane axis (P (B, n, n), A (B, m, n)),
    and so do the iterates (`run_phase`). Returns an AdmmCarry whose
    rho_bar, it, status, r_prim and r_dual are (B,) and hist (B,
    slots, 3)."""
    return _carry(run_phase(qp, x0, z0, y0, settings, backend,
                            scaling=scaling, rho0=rho0, z_off=z_off))


def _carry(loop) -> AdmmCarry:
    out, fac = loop.result("out", "fac")
    return AdmmCarry(x=out["x"], z=out["z"], y=out["y"], rho_bar=out["rho"],
                     fac=fac, it=out["iters"],
                     status=out["status"], r_prim=out["r_prim"],
                     r_dual=out["r_dual"], hist=out["history"])
