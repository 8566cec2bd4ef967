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
(P, A) per lane (problem.mv / vm take both). Everything here works on
the Ruiz-scaled problem; residuals and termination use unscaled
quantities through the Scaling vectors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import kkt
from ..ops.prox import project_cone
from ..problem import QPData, is_equality_row, mv, vm
from ..settings import Settings
from ..solution import Status
from .scaling import Scaling

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
    """Run k plain iterations."""
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
    it: int                     # iterations run
    status: torch.Tensor        # int32 Status
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    hist: torch.Tensor          # (slots, 3) residual ring buffer


def run_admm(qp: QPData, scaling: Scaling, settings: Settings,
             x0, z0, y0, backend: str, z_off=None, rho0=None) -> AdmmCarry:
    """Solve one scaled problem: a host loop over residual checks, each
    of which reads one small tensor from the device (liveness and the
    refactor flag).

    Every check runs check_every iterations, then the restarted
    averaging, the termination and infeasibility tests, the NaN
    tripwire, the stall exit and, on its cadence, the adaptive rho
    (a refactorisation, or for the matrix-free 'cg' backend only a new
    rho in the operator). A run that ends UNSOLVED reports MAX_ITER.
    z_off: optional scaled shifted-prox offset for L1/SOC rows.
    rho0: optional initial rho-bar (warm rho).
    """
    dtype, dev = qp.dtype, qp.device
    eq_mask = is_equality_row(qp)
    rho_bar = torch.as_tensor(settings.rho if rho0 is None else rho0,
                              dtype=dtype, device=dev)

    def factor(rho_bar):
        rv = rho_vec_of(rho_bar, eq_mask, settings, qp.cone)
        return kkt.factor_condensed(qp.P, qp.A, settings.sigma, rv, backend,
                                    settings.band_block,
                                    settings.spike_parts)

    fac = factor(rho_bar)
    slots = max(settings.history, 0)
    hist = torch.full((slots, 3), -1.0, dtype=dtype, device=dev)
    hist_ptr = 0
    big = torch.tensor(float("inf"), dtype=dtype, device=dev)
    x, z, y = x0, z0, y0
    it = 0
    status = torch.tensor(_UNSOLVED, dtype=torch.int32, device=dev)
    r_prim, r_dual = big, big
    x_chk, y_chk = x0, y0
    x_sum, z_sum, y_sum = (torch.zeros_like(t) for t in (x0, z0, y0))
    avg_cnt = 0
    best_ratio = big
    since_best = torch.zeros((), dtype=torch.int32, device=dev)

    k = settings.check_every
    interval_checks = max(1, settings.adaptive_rho_interval // k)
    restart_checks = restart_cadence_checks(settings)
    alive = True

    while alive and it < settings.max_iter:
        check = it // k
        rho_vec = rho_vec_of(rho_bar, eq_mask, settings, qp.cone)
        x, z, y = iterate_block(qp, fac, x, z, y, rho_vec, settings,
                                backend, k, z_off=z_off)
        it += k
        res = residuals(qp, scaling, x, z, y)

        # Restarted averaging: at each restart boundary adopt the running
        # average of the check-cadence iterates iff its scaled residuals
        # beat the current iterate's.
        x_sum, z_sum, y_sum = x_sum + x, z_sum + z, y_sum + y
        avg_cnt += 1
        if restart_checks and check % restart_checks == restart_checks - 1:
            denom = float(max(avg_cnt, 1))
            xa, za, ya = x_sum / denom, z_sum / denom, y_sum / denom
            res_a = residuals(qp, scaling, xa, za, ya)
            take = (scaled_resid_ratio(res_a, settings)
                    < scaled_resid_ratio(res, settings))
            x, z, y = (torch.where(take, a, b)
                       for a, b in ((xa, x), (za, z), (ya, y)))
            res = tuple(torch.where(take, ra, rc)
                        for ra, rc in zip(res_a, res))
            x_sum, z_sum, y_sum = (torch.zeros_like(t)
                                   for t in (x_sum, z_sum, y_sum))
            avg_cnt = 0

        r_prim, r_dual = res[0], res[1]
        eps_p, eps_d = eps_thresholds(res, settings)
        solved = (r_prim <= eps_p) & (r_dual <= eps_d)
        pinf, dinf = infeasibility(qp, scaling, x - x_chk, y - y_chk,
                                   settings)
        # NaN tripwire: a failed factorisation or a divergent iterate
        # poisons the residuals; stop instead of spinning to max_iter.
        numerr = ~(torch.isfinite(r_prim) & torch.isfinite(r_dual))
        status = status_of(numerr, solved, pinf, dinf, status)

        # Stall exit: no new best scaled ratio for a whole window.
        ratio_now = scaled_resid_ratio(res, settings)
        improved = ratio_now < best_ratio
        best_ratio = torch.minimum(ratio_now, best_ratio)
        since_best = torch.where(improved, 0, since_best + 1)
        if settings.stall_checks > 0:
            stalled = since_best >= settings.stall_checks
            status = torch.where((status == _UNSOLVED) & stalled,
                                 int(Status.STALLED), status)

        do_t = torch.zeros((), dtype=torch.bool, device=dev)
        if settings.adaptive_rho and check % interval_checks == (
                interval_checks - 1):
            new_rho, changed = adapt_rho(rho_bar, res, settings)
            do_t = changed & (status == _UNSOLVED)

        if slots > 0:
            row = hist[hist_ptr % slots]
            row[0] = float(it)
            row[1] = r_prim
            row[2] = r_dual
            hist_ptr += 1
        x_chk, y_chk = x, y

        # The one device-to-host read of this check.
        alive, do = torch.stack([status == _UNSOLVED, do_t]).tolist()
        if do:
            rho_bar = new_rho
            if backend == "cg":
                # Matrix-free: rho enters the operator, no refactorisation.
                fac = dict(fac, rho=rho_vec_of(rho_bar, eq_mask, settings,
                                               qp.cone))
            else:
                fac = factor(rho_bar)

    status = torch.where(status == _UNSOLVED, int(Status.MAX_ITER), status)
    return AdmmCarry(x=x, z=z, y=y, rho_bar=rho_bar, fac=fac, it=it,
                     status=status, r_prim=r_prim, r_dual=r_dual, hist=hist)


def _select(mask, new, old):
    """Per-lane select between two tensors that lead with the lane axis."""
    return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def run_admm_lanes(qp: QPData, scaling: Scaling, settings: Settings,
                   x0, z0, y0, backend: str, z_off=None,
                   rho0=None) -> AdmmCarry:
    """`run_admm` over B independent scaled problems in lockstep: every
    leaf of `qp` leads with the lane axis (P (B, n, n), A (B, m, n)),
    and so do the iterates.

    Each lane has its own rho-bar, KKT factor, restart averaging, stall
    counter, adaptive-rho decision, status and residual history. A lane
    runs while its status is UNSOLVED and freezes once it leaves it: its
    state stays as it was from then on, and its `it` counts only the
    iterations it ran. The host loop runs while any lane is live and
    reads one small tensor per check. When any live lane changes rho,
    every lane is refactored and each takes the new factor only if its
    own rho changed (the matrix-free 'cg' factor just takes the new rho
    vectors). Returns an AdmmCarry whose rho_bar, it, status, r_prim and
    r_dual are (B,) and hist (B, slots, 3).
    """
    dtype, dev = qp.dtype, qp.device
    cone = qp.cone
    B = qp.P.shape[0]
    eq_mask = is_equality_row(qp)
    rho_bar = torch.as_tensor(settings.rho if rho0 is None else rho0,
                              dtype=dtype, device=dev).expand(B).clone()

    def rho_vec(rho_bar):
        return rho_vec_of(rho_bar[:, None], eq_mask, settings, cone)

    def factor(rho_bar):
        return kkt.factor_condensed(qp.P, qp.A, settings.sigma,
                                    rho_vec(rho_bar), backend,
                                    settings.band_block,
                                    settings.spike_parts)

    fac = factor(rho_bar)
    slots = max(settings.history, 0)
    hist = torch.full((B, slots, 3), -1.0, dtype=dtype, device=dev)
    big = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    x, z, y = x0, z0, y0
    it = 0
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    status = torch.full((B,), _UNSOLVED, dtype=torch.int32, device=dev)
    r_prim, r_dual = big, big
    x_chk, y_chk = x0, y0
    x_sum, z_sum, y_sum = (torch.zeros_like(t) for t in (x0, z0, y0))
    avg_cnt = 0
    best_ratio = big
    since_best = torch.zeros(B, dtype=torch.int32, device=dev)

    k = settings.check_every
    interval_checks = max(1, settings.adaptive_rho_interval // k)
    restart_checks = restart_cadence_checks(settings)
    alive = True

    while alive and it < settings.max_iter:
        check = it // k
        active = status == _UNSOLVED
        xn, zn, yn = iterate_block(qp, fac, x, z, y, rho_vec(rho_bar),
                                   settings, backend, k, z_off=z_off)
        it += k
        res = residuals(qp, scaling, xn, zn, yn)

        # Restarted averaging, each lane against its own average (live
        # lanes all share the check count, hence the boundary).
        x_sum, z_sum, y_sum = x_sum + xn, z_sum + zn, y_sum + yn
        avg_cnt += 1
        if restart_checks and check % restart_checks == restart_checks - 1:
            denom = float(max(avg_cnt, 1))
            xa, za, ya = x_sum / denom, z_sum / denom, y_sum / denom
            res_a = residuals(qp, scaling, xa, za, ya)
            take = (scaled_resid_ratio(res_a, settings)
                    < scaled_resid_ratio(res, settings))
            xn, zn, yn = (_select(take, a, b)
                          for a, b in ((xa, xn), (za, zn), (ya, yn)))
            res = tuple(torch.where(take, ra, rc)
                        for ra, rc in zip(res_a, res))
            x_sum, z_sum, y_sum = (torch.zeros_like(t)
                                   for t in (x_sum, z_sum, y_sum))
            avg_cnt = 0

        rp_now, rd_now = res[0], res[1]
        eps_p, eps_d = eps_thresholds(res, settings)
        solved = (rp_now <= eps_p) & (rd_now <= eps_d)
        pinf, dinf = infeasibility(qp, scaling, xn - x_chk, yn - y_chk,
                                   settings)
        numerr = ~(torch.isfinite(rp_now) & torch.isfinite(rd_now))
        new_status = status_of(numerr, solved, pinf, dinf, status)

        ratio_now = scaled_resid_ratio(res, settings)
        improved = ratio_now < best_ratio
        best_ratio = torch.where(active, torch.minimum(ratio_now,
                                                       best_ratio),
                                 best_ratio)
        since_best = torch.where(
            active, torch.where(improved, 0, since_best + 1), since_best)
        if settings.stall_checks > 0:
            stalled = since_best >= settings.stall_checks
            new_status = torch.where((new_status == _UNSOLVED) & stalled,
                                     int(Status.STALLED), new_status)

        do_t = torch.zeros(B, dtype=torch.bool, device=dev)
        if settings.adaptive_rho and check % interval_checks == (
                interval_checks - 1):
            new_rho, changed = adapt_rho(rho_bar, res, settings)
            do_t = active & changed & (new_status == _UNSOLVED)

        if slots > 0:
            row = torch.stack([torch.full_like(rp_now, float(it)), rp_now,
                               rd_now], dim=-1)
            slot = hist[:, (check % slots)]
            hist[:, check % slots] = _select(active, row, slot)

        # Frozen lanes keep their state.
        x, z, y = (_select(active, a, b)
                   for a, b in ((xn, x), (zn, z), (yn, y)))
        status = torch.where(active, new_status, status)
        r_prim = torch.where(active, rp_now, r_prim)
        r_dual = torch.where(active, rd_now, r_dual)
        iters = iters + active.to(torch.int32) * k
        x_chk, y_chk = x, y

        # The one device-to-host read of this check.
        alive, do = torch.stack([(status == _UNSOLVED).any(),
                                 do_t.any()]).tolist()
        if do:
            rho_bar = torch.where(do_t, new_rho, rho_bar)
            if backend == "cg":
                # Matrix-free: rho enters the operator, no refactorisation.
                fac = dict(fac, rho=rho_vec(rho_bar))
            else:
                new_fac = factor(rho_bar)
                fac = {key: _select(do_t, new_fac[key], fac[key])
                       for key in fac}

    status = torch.where(status == _UNSOLVED, int(Status.MAX_ITER), status)
    return AdmmCarry(x=x, z=z, y=y, rho_bar=rho_bar, fac=fac, it=iters,
                     status=status, r_prim=r_prim, r_dual=r_dual, hist=hist)
