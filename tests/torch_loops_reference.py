"""The host loops of admm_library_torch written with host-side counters
and rebinding, one iterate at a time: `run_admm`, `run_admm_lanes` and
`run_admm_batch_shared`, the partitioned drivers' `run_consensus`,
`run_consensus_mc` and `_run_horizon`, and the row-sharded
`solve_rowsharded` with its CG, as plain loops whose check is inline.
tests/test_torch_graph.py, test_torch_graph_partitioned.py and
test_torch_graph_rowshard.py hold the package's loops, whose checks are
carry-to-carry steps (core/graph.py), bitwise to these on the CPU.
`_ref_solve_batch_shared` is the whole shared-batch solve (Ruiz
scaling, phases, re-centred rounds, f64 fallback) as host code around
`_ref_run_admm_batch_shared`: tests/test_torch_graph_solve.py holds
`solve_batch_shared`, whose work between host reads is segments of its
loops, bitwise to it. `_ref_solve` and `_ref_solve_batch` are `solve`
and `solve_batch` (phases, staged path, re-centred rounds, f64
continuation, polish, warm-start check) as host code around
`_ref_run_admm`, `_ref_run_admm_lanes`, `core.polish.polish` and
`_ref_solve_batch_shared`: tests/test_torch_graph_api.py holds the
package's, whose work between host reads is segments, bitwise to them.
Every loop here iterates through `_ref_iterate_block`, whose 'cg' solve
is the frozen one-loop `_ref_cg_solve` (tests/test_torch_graph_cg.py
holds the package's 'cg' segments to it).

`HOST_LOOPS` holds the six loops over checks as they ran on the host
before `graph.CheckLoop.run_checks` (a host counter, the variant picked
on the host, one read of the flags a check; the partitioned drivers'
refactor rebuilt on the host and written with `loop.set`), by loop
kind: tests/test_torch_phase_loop.py runs the package's drivers with
these in place of `run_checks` and holds the helper's plain and node
forms bitwise to them.
"""
import dataclasses
import math

import torch

from admm_library_torch.core.admm import (
    AdmmCarry, _select, adapt_rho, eps_thresholds, infeasibility,
    is_equality_row, residuals, restart_cadence_checks,
    rho_vec_of, scaled_resid_ratio, status_of)
from admm_library_torch.core import admm
from admm_library_torch.core.polish import polish
from admm_library_torch.core.scaling import Scaling
from admm_library_torch.ops import fused as fused_ops
from admm_library_torch.ops import kkt
from admm_library_torch.parallel.batch import (
    BatchCarry, _agreed, _data_max, _geomean_masked, _pick)
from admm_library_torch.parallel import runtime
from admm_library_torch.parallel.consensus import (
    ConsensusSpec, Local, PhaseResult, _balance, _l1_scale, _linf_global,
    _linf_scen, _pmax, _ratio, _Rho, _status, consensus_body,
    infeasibility_blocks)
from admm_library_torch.parallel.horizon import (
    HorizonParts, HorizonSpec, _neighbor_next, _neighbor_prev,
    _spike_factor_sharded, _spike_reduce_factor, _spike_solve_sharded)
from admm_library_torch.parallel.horizon import _rho_vec as _horizon_rho_vec
from admm_library_torch.parallel.rowshard import (
    RowShardSolution, uniform_row_permutation)
from admm_library_torch.parallel.runtime import DATA_AXIS, Mesh
from admm_library_torch.ops.kkt import _CG_CHECK
from admm_library_torch.ops.prox import project_cone
from admm_library_torch.core.scaling import ruiz_equilibrate, scale_qp
from admm_library_torch.api import resolve_backend
from admm_library_torch.ops.prox import project_soc_block
from admm_library_torch.precision import clean64
from admm_library_torch.problem import QPData, mv, objective, vm
from admm_library_torch.settings import Settings
from admm_library_torch.solution import Solution, Status

_UNSOLVED = int(Status.UNSOLVED)
_STALLED = int(Status.STALLED)
_SOLVED = int(Status.SOLVED)
_PINF = int(Status.PRIMAL_INFEASIBLE)
_DINF = int(Status.DUAL_INFEASIBLE)
_F64_MAX_ITER = 8000


# ---- An iteration as it stood before the 'cg' backend's CG became
# segments of the phase and batch loops: ops/kkt.cg_solve one loop with
# a host read every _CG_CHECK steps inside core.admm.admm_iteration. ----

def _ref_cg_solve(fac, rhs, x0=None, tol: float = 1e-9, max_iter: int = 200):
    x = torch.zeros_like(rhs) if x0 is None else x0
    r = rhs - kkt._matvec_M(fac, x)
    p = r
    rs = (r * r).sum(-1)
    tol2 = (tol * tol) * torch.clamp((rhs * rhs).sum(-1), min=1.0)
    for it in range(max_iter):
        if it % _CG_CHECK == 0 and not bool((rs > tol2).any()):
            break
        Mp = kkt._matvec_M(fac, p)
        pMp = (p * Mp).sum(-1)
        active = rs > tol2
        alpha = torch.where(active, rs / torch.where(pMp > 0, pMp, 1.0), 0.0)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Mp
        rs_new = (r * r).sum(-1)
        beta = torch.where(active, rs_new / torch.where(rs > 0, rs, 1.0), 0.0)
        p = r + beta[..., None] * p
        rs = torch.where(active, rs_new, rs)
    return x


def _ref_admm_iteration(qp: QPData, fac, x, z, y, rho_vec,
                        settings: Settings, backend: str, z_off=None):
    rhs = settings.sigma * x - qp.q + vm(rho_vec * z - y, qp.A)
    if backend == "cg":
        xt = _ref_cg_solve(fac, rhs, tol=settings.cg_tol,
                           max_iter=settings.cg_max_iter)
    else:
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


def _ref_iterate_block(qp, fac, x, z, y, rho_vec, settings, backend, k: int,
                       z_off=None):
    for _ in range(k):
        x, z, y = _ref_admm_iteration(qp, fac, x, z, y, rho_vec, settings,
                                      backend, z_off=z_off)
    return x, z, y


def _ref_run_admm(qp: QPData, scaling: Scaling, settings: Settings,
             x0, z0, y0, backend: str, z_off=None, rho0=None) -> AdmmCarry:
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
        x, z, y = _ref_iterate_block(qp, fac, x, z, y, rho_vec, settings,
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


def _ref_run_admm_lanes(qp: QPData, scaling: Scaling, settings: Settings,
                   x0, z0, y0, backend: str, z_off=None,
                   rho0=None) -> AdmmCarry:
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
        xn, zn, yn = _ref_iterate_block(qp, fac, x, z, y, rho_vec(rho_bar),
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


def _ref_run_admm_batch_shared(qp: QPData, scaling, settings: Settings,
                          x0, z0, y0, backend: str, rho0=None,
                          z_off=None, mesh: Mesh | None = None
                          ) -> BatchCarry:
    dtype, dev = qp.dtype, qp.device
    cone = qp.cone
    eq_mask = admm.is_equality_row_shared(qp)
    rho_bar = (torch.tensor(settings.rho, dtype=dtype, device=dev)
               if rho0 is None else
               torch.clamp(rho0.to(dtype), settings.rho_min,
                           settings.rho_max))
    B = x0.shape[0]

    def factor(rho_bar):
        rv = admm.rho_vec_of(rho_bar, eq_mask, settings, cone)
        return kkt.factor_condensed(qp.P, qp.A, settings.sigma, rv, backend,
                                    settings.band_block,
                                    settings.spike_parts)

    # The only place where the plain iteration body is chosen over the
    # fused kernel: f32, explicit inverse, shared q/lam, no shifted prox,
    # uniform SOC blocks.
    use_fused = (
        settings.fused != "off"
        and backend == "inv"
        and qp.A.dim() == 2
        and qp.q.dim() == 1
        and qp.lam.dim() == 1
        and dtype == torch.float32
        and z_off is None
        and (cone.m_soc == 0 or cone.soc_uniform))

    fac = factor(rho_bar)
    big = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    slots = max(settings.history, 0)
    x, z, y = x0, z0, y0
    it = 0
    iters_lane = torch.zeros(B, dtype=torch.int32, device=dev)
    status = torch.full((B,), _UNSOLVED, dtype=torch.int32, device=dev)
    r_prim, r_dual = big, big
    x_chk, y_chk = x0, y0
    x_sum, z_sum, y_sum = (torch.zeros_like(t) for t in (x0, z0, y0))
    avg_cnt = 0
    best_ratio = big
    since_best = torch.zeros(B, dtype=torch.int32, device=dev)
    x_best, z_best, y_best = x0, z0, y0
    rp_best, rd_best = big, big
    hist = torch.full((slots, 3), -1.0, dtype=dtype, device=dev)
    hist_ptr = 0

    k = settings.check_every
    interval_checks = max(1, settings.adaptive_rho_interval // k)
    restart_checks = admm.restart_cadence_checks(settings)
    alive = True

    while alive and it < settings.max_iter:
        check = it // k
        rho_vec = admm.rho_vec_of(rho_bar, eq_mask, settings, cone)
        active = status == _UNSOLVED

        if use_fused:
            xn, zn, yn = fused_ops.fused_iterate_shared(
                qp.A, fac["Minv"], fac["M"], qp.q, rho_vec, qp.lam,
                qp.l, qp.u, x, z, y, cone=cone, sigma=settings.sigma,
                alpha=settings.alpha, k=k,
                refine_steps=settings.refine_steps)
        else:
            xn, zn, yn = _ref_iterate_block(
                qp, fac, x, z, y, rho_vec, settings, backend, k,
                z_off=z_off)
        # Freeze converged/infeasible lanes.
        xn, zn, yn = (_pick(active, a, b)
                      for a, b in ((xn, x), (zn, z), (yn, y)))
        it += k
        iters_lane = iters_lane + active.to(torch.int32) * k

        res = admm.residuals(qp, scaling, xn, zn, yn)

        # Per-lane restarted averaging (Settings.restart_every): adopt a
        # lane's running average iff its scaled residuals beat the
        # lane's current iterate. Frozen lanes never restart.
        x_sum, z_sum, y_sum = x_sum + xn, z_sum + zn, y_sum + yn
        avg_cnt += 1
        if restart_checks and check % restart_checks == restart_checks - 1:
            denom = float(max(avg_cnt, 1))
            xa, za, ya = x_sum / denom, z_sum / denom, y_sum / denom
            res_a = admm.residuals(qp, scaling, xa, za, ya)
            take = active & (admm.scaled_resid_ratio(res_a, settings)
                             < admm.scaled_resid_ratio(res, settings))
            # nq (res[6]) is point-independent and may be a scalar.
            res = tuple(torch.where(take, ra, rc)
                        for ra, rc in zip(res_a[:6], res[:6])) + (res[6],)
            xn, zn, yn = (_pick(take, a, b)
                          for a, b in ((xa, xn), (za, zn), (ya, yn)))
            x_sum, z_sum, y_sum = (torch.zeros_like(t)
                                   for t in (x_sum, z_sum, y_sum))
            avg_cnt = 0

        rp_now, rd_now = res[0], res[1]
        eps_p, eps_d = admm.eps_thresholds(res, settings)
        solved = (rp_now <= eps_p) & (rd_now <= eps_d)
        pinf, dinf = admm.infeasibility(
            qp, scaling, xn - x_chk, yn - y_chk, settings)
        numerr = ~(torch.isfinite(rp_now) & torch.isfinite(rd_now))
        new_status = admm.status_of(numerr, solved, pinf, dinf, status)
        # Per-lane stall exit (Settings.stall_checks).
        ratio_now = admm.scaled_resid_ratio(res, settings)
        improved = active & (ratio_now < best_ratio)
        best_ratio = torch.where(improved, ratio_now, best_ratio)
        since_best = torch.where(
            active, torch.where(improved, 0, since_best + 1), since_best)
        x_best, z_best, y_best = (
            _pick(improved, a, b)
            for a, b in ((xn, x_best), (zn, z_best), (yn, y_best)))
        rp_best = torch.where(improved, res[0], rp_best)
        rd_best = torch.where(improved, res[1], rd_best)
        if settings.stall_checks > 0:
            stalled = since_best >= settings.stall_checks
            new_status = torch.where(
                (new_status == _UNSOLVED) & stalled, _STALLED, new_status)
            # A stalling lane freezes at its BEST iterate: stall can
            # fire mid-excursion.
            swap = active & stalled & (new_status == _STALLED)
            xn, zn, yn = (_pick(swap, a, b)
                          for a, b in ((x_best, xn), (z_best, zn),
                                       (y_best, yn)))
            res = (torch.where(swap, rp_best, res[0]),
                   torch.where(swap, rd_best, res[1])) + res[2:]
        status = torch.where(active, new_status, status)
        r_prim = torch.where(active, rp_now, r_prim)
        r_dual = torch.where(active, rd_now, r_dual)

        # Shared adaptive rho from the active lanes' geomean ratio.
        still = status == _UNSOLVED
        alive_t = still.any()
        do_t = torch.zeros((), dtype=torch.bool, device=dev)
        if settings.adaptive_rho and check % interval_checks == (
                interval_checks - 1):
            tiny = torch.finfo(dtype).tiny
            _, _, nAx, nz, nPx, nAty, nq = res
            sp = res[0] / torch.clamp(torch.maximum(nAx, nz), min=tiny)
            sd = res[1] / torch.clamp(
                torch.maximum(torch.maximum(nPx, nAty), nq), min=tiny)
            ratio = torch.sqrt(
                _geomean_masked(sp, still, mesh)
                / torch.clamp(_geomean_masked(sd, still, mesh), min=tiny))
            new_rho = torch.clamp(rho_bar * ratio, settings.rho_min,
                                  settings.rho_max)
            tol = settings.adaptive_rho_tol
            do_t = ((ratio > tol) | (ratio < 1.0 / tol)) & alive_t

        if slots > 0:
            row = hist[hist_ptr % slots]
            row[0] = float(it)
            row[1] = _data_max(r_prim.amax(), mesh)
            row[2] = _data_max(r_dual.amax(), mesh)
            hist_ptr += 1
        x, z, y = xn, zn, yn
        x_chk, y_chk = xn, yn

        # The one device-to-host read of this check, agreed over the
        # mesh: liveness of any lane anywhere, and the rho decision.
        alive, do = _agreed(torch.stack([alive_t, do_t]), mesh)
        if do:
            rho_bar = new_rho
            if backend == "cg":
                # Matrix-free: rho enters the operator, no refactorisation.
                fac = dict(fac, rho=admm.rho_vec_of(rho_bar, eq_mask,
                                                    settings, cone))
            else:
                fac = factor(rho_bar)

    # Lanes that ran out of iterations also return their BEST iterate.
    unsolved = status == _UNSOLVED
    return BatchCarry(
        x=_pick(unsolved, x_best, x), z=_pick(unsolved, z_best, z),
        y=_pick(unsolved, y_best, y), rho_bar=rho_bar,
        iters_lane=iters_lane,
        status=torch.where(unsolved, int(Status.MAX_ITER), status),
        r_prim=torch.where(unsolved, rp_best, r_prim),
        r_dual=torch.where(unsolved, rd_best, r_dual), hist=hist)


# ---- solve_batch_shared as it stood before its prologue, refactors,
# rounds and epilogue became captured segments: host code around
# `_ref_run_admm_batch_shared`, one eager kernel at a time. ----

def _ref_all_lanes(mask, mesh: Mesh | None) -> bool:
    """True when mask holds on every lane of every rank."""
    return not _agreed((~mask).any()[None], mesh)[0]


def _ref_ruiz(qp, settings, mesh):
    """Ruiz scaling of this rank's lanes equal to the one of the whole
    batch: a per-lane q enters the cost scale through a max over every
    lane, so that max is taken over the data axis too."""
    reduce_max = None
    if mesh is not None and qp.q.dim() > 1:
        def reduce_max(t):
            return _data_max(t, mesh)
    return ruiz_equilibrate(qp, settings.scaling_iters, reduce_max)


def _ref_phase(qp, x0, z0, y0, settings, backend, scaling=None,
               rho0=None, z_off=None, mesh=None):
    if scaling is not None:
        # Precomputed scaling (re-centred rounds keep phase 1's P/A, so
        # the Ruiz loop would recompute identical factors).
        scaling = scaling.astype(qp.dtype)
        qps = scale_qp(qp, scaling)
    else:
        qps, scaling = _ref_ruiz(qp, settings, mesh)
    if settings.warm_start:
        xs = scaling.scale_x(x0)
        zs = scaling.scale_z(z0)
        ys = scaling.scale_y(y0)
    else:
        xs, zs, ys = x0, z0, y0
    if z_off is not None:
        # Shifted-prox offsets live in z-space; they keep their own
        # (f64) dtype — ops/prox upcasts there.
        z_off = scaling.e.to(z_off.dtype) * z_off
    carry = _ref_run_admm_batch_shared(
        qps, scaling, settings, xs, zs, ys, backend, rho0=rho0, z_off=z_off,
        mesh=mesh)
    x = scaling.unscale_x(carry.x)
    z = scaling.unscale_z(carry.z)
    y = scaling.unscale_y(carry.y)
    return Solution(
        x=x, z=z, y=y, status=carry.status, iters=carry.iters_lane,
        r_prim=carry.r_prim, r_dual=carry.r_dual, obj=objective(qp, x, z),
        rho=carry.rho_bar, history=carry.hist)


def _ref_s32_of_shared(settings: Settings) -> Settings:
    """f32-phase settings: relaxed eps and f32 condition-number caps.
    rho_soc_scale is stripped here (in raw coordinates the boost wrecks
    f32 conditioning); the re-centred rounds re-apply it."""
    return settings.replace(
        precision="single",
        eps_abs=max(settings.hybrid_eps, settings.eps_abs),
        eps_rel=max(settings.hybrid_eps, settings.eps_rel),
        sigma=max(settings.sigma, 1e-5),
        rho_soc_scale=1.0,
        rho_eq_scale=min(settings.rho_eq_scale, 1e2))


def _ref_solve_shared_recentered(qp: QPData, x0, z0, y0,
                                 settings: Settings, backend: str,
                                 mesh=None) -> Solution:
    """Hybrid precision via f32 re-centring (all cone types).

    Round 0 solves in f32 to the f32 residual plateau. Each refinement
    round re-solves the same QP with data shifted around the accumulated
    (x, y): g = Px + q (f64) becomes the correction's q, box bounds
    shift by -Ax; L1/SOC rows keep their bounds and evaluate the shifted
    prox with an f64 offset = Ax. The correction lives at the residual
    scale, so f32 iterations reach the 1e-6 target. A capped,
    warm-started f64 phase runs only for lanes the rounds left unsolved.
    Its host branches (skip the later rounds, skip the f64 phase) are
    agreed over the mesh.
    """
    f32, f64 = torch.float32, torch.float64
    s1 = _ref_s32_of_shared(settings)
    qp64 = qp.astype(f64)
    # One Ruiz pass serves phase 1 and every correction round.
    _, scaling1 = _ref_ruiz(qp.astype(f32), s1, mesh)
    sol = _ref_phase(qp.astype(f32), x0.to(f32), z0.to(f32), y0.to(f32),
                     s1, backend, scaling=scaling1, mesh=mesh)
    p1_inf = (sol.status == _PINF) | (sol.status == _DINF)
    x_t = clean64(sol.x)
    y_t = clean64(sol.y)
    z_t64 = clean64(sol.z)
    iters = sol.iters
    rho = sol.rho

    # Correction rounds: absolute eps at the target tolerance.
    s_c = s1.replace(eps_abs=settings.eps_abs, eps_rel=settings.eps_rel,
                     rho_soc_scale=settings.rho_soc_scale)
    B = x_t.shape[0]
    cone = qp.cone
    mb, ml = cone.m_box, cone.m_l1
    mixed = (ml + cone.m_soc) > 0
    act_tol = 10.0 * max(settings.hybrid_eps, settings.eps_abs)
    A64, P64, q64 = qp64.A, qp64.P, qp64.q

    def mask_dual(y, z):
        """Dual base for re-centring — the part of the accumulated dual
        the correction's linear term absorbs (g_c includes Aᵀy_base, and
        the round solves for the O(residual) remainder):
          box:  y within act_tol of a bound, else exactly 0;
          L1:   0 (∂(λ|z|) is bounded, so the round's dual replaces);
          SOC:  the projection of y onto the normal cone at the current
                primal — 0 in the interior, the component along the
                normal ray on the boundary, the polar part at the tip.
        """
        scale = 1.0 + z.abs()
        near_l = torch.isfinite(qp64.l) & (z - qp64.l <= act_tol * scale)
        near_u = torch.isfinite(qp64.u) & (qp64.u - z <= act_tol * scale)
        parts = [torch.where((near_l | near_u)[..., :mb], y[..., :mb], 0.0)]
        if ml:
            parts.append(torch.zeros_like(y[..., mb:mb + ml]))
        if cone.m_soc:
            d = cone.soc_dims[0]
            shp = z[..., mb + ml:].shape[:-1] + (cone.n_soc, d)
            zb = z[..., mb + ml:].reshape(shp)
            yb = y[..., mb + ml:].reshape(shp)
            t, u = zb[..., 0], zb[..., 1:]
            yt, yu = yb[..., 0], yb[..., 1:]
            nu = torch.linalg.vector_norm(u, dim=-1)
            sc = act_tol * (1.0 + t.abs() + nu)
            interior = nu <= t - sc
            tip = (nu <= sc) & (t <= sc)
            # Boundary outward normal ray n = (−1, u/‖u‖)/√2:
            # base = <y, n>₊ n.
            safe = torch.clamp(nu, min=torch.finfo(z.dtype).tiny)
            cross = (yu * u).sum(-1) / safe - yt
            s_ray = 0.5 * torch.clamp(cross, min=0.0)
            ray_t = -s_ray
            ray_u = s_ray[..., None] * (u / safe[..., None])
            # Tip: polar-cone part via Moreau (y − Π_SOC(y)).
            pt, pu = project_soc_block(yt, yu)
            tip_t, tip_u = yt - pt, yu - pu
            bt = torch.where(interior, 0.0, torch.where(tip, tip_t, ray_t))
            bu = torch.where(interior[..., None], 0.0,
                             torch.where(tip[..., None], tip_u, ray_u))
            base = torch.cat([bt[..., None], bu], dim=-1)
            parts.append(base.reshape(z[..., mb + ml:].shape))
        return torch.cat(parts, dim=-1)

    linf = admm.linf

    def true_residuals(x, y, z):
        """(r_p, r_d, eps_p, eps_d) per lane on the original f64 data,
        with the solver loop's eps_d reference (incl. the L1 term)."""
        Ax = x @ A64.mT
        Px = x @ P64.mT
        Aty = y @ A64
        eps_p = settings.eps_abs + settings.eps_rel * torch.maximum(
            linf(Ax), linf(z))
        eps_d = settings.eps_abs + settings.eps_rel * torch.maximum(
            torch.maximum(linf(Px), linf(Aty)),
            torch.maximum(linf(q64), admm.l1_grad_scale_raw(qp64)))
        return linf(Ax - z), linf(Px + q64 + Aty), eps_p, eps_d

    def true_ratio(x, y, z):
        r_p, r_d, eps_p, eps_d = true_residuals(x, y, z)
        return torch.maximum(r_p / eps_p, r_d / eps_d)

    def round_fn(x_t, y_t, z_t64, iters, rho, frozen):
        y_base = mask_dual(y_t, z_t64) if mixed else None
        Ax = x_t @ A64.mT
        Px = x_t @ P64.mT
        if mixed:
            g = Px + q64 + y_base @ A64
            # Box rows shift through the bounds; L1/SOC rows keep the
            # original bounds/lam and use the shifted prox (offset=Ax).
            l_c = torch.cat([qp64.l[..., :mb] - Ax[..., :mb],
                             qp64.l[..., mb:]], dim=-1)
            u_c = torch.cat([qp64.u[..., :mb] - Ax[..., :mb],
                             qp64.u[..., mb:]], dim=-1)
            z_off = torch.cat([torch.zeros_like(Ax[..., :mb]),
                               Ax[..., mb:]], dim=-1)
            y_warm = (y_t - y_base).to(f32)
        else:
            # Box-only: the correction is the original problem in shifted
            # coordinates, so its dual is a complete dual and replaces.
            g = Px + q64
            l_c = qp64.l - Ax
            u_c = qp64.u - Ax
            z_off = None
            y_warm = y_t.to(f32)
        qp_c = QPData(P=qp.P.to(f32), q=g.to(f32), A=qp.A.to(f32),
                      l=l_c.to(f32), u=u_c.to(f32), lam=qp.lam.to(f32),
                      cone=cone)
        zc0 = (z_t64 - Ax).to(f32)
        solc = _ref_phase(qp_c, torch.zeros((B, qp.n), dtype=f32,
                                            device=x_t.device),
                          zc0, y_warm, s_c, backend, scaling=scaling1,
                          rho0=rho.to(f32), z_off=z_off, mesh=mesh)
        x_n = x_t + clean64(solc.x)
        y_n = (y_base + clean64(solc.y)) if mixed else clean64(solc.y)
        z_n = Ax + clean64(solc.z)
        # Round safeguard: accept a lane's round only when it improves
        # the true scaled residual ratio on the original f64 data;
        # rejected lanes keep their iterate and freeze.
        ok = ~frozen & (true_ratio(x_n, y_n, z_n)
                        < true_ratio(x_t, y_t, z_t64))
        rstat = torch.where(ok, solc.status, _STALLED)
        return (_pick(ok, x_n, x_t), _pick(ok, y_n, y_t),
                _pick(ok, z_n, z_t64), iters + solc.iters,
                solc.rho.to(rho.dtype), frozen | ~ok), rstat

    carry = (x_t, y_t, z_t64, iters, rho,
             torch.zeros(B, dtype=torch.bool, device=x_t.device))
    for r in range(max(settings.recenter_rounds, 0)):
        # Later rounds are skipped once every lane met the round
        # criterion or froze: a round costs a factorisation and
        # check_every iterations even when it converges at once.
        if r > 0 and _ref_all_lanes((round_status == _SOLVED) | carry[5],
                                    mesh):
            break
        carry, round_status = round_fn(*carry)
    x_t, y_t, z_t, iters, rho, _frozen = carry

    # True residuals/status in f64 on the original data.
    r_p, r_d, eps_p, eps_d = true_residuals(x_t, y_t, z_t)
    solved = (r_p <= eps_p) & (r_d <= eps_d)
    status = torch.where(p1_inf, sol.status,
                         torch.where(solved, _SOLVED,
                                     int(Status.MAX_ITER)).to(torch.int32))
    d = qp.dtype

    if _ref_all_lanes(solved | p1_inf, mesh):
        return Solution(
            x=x_t.to(d), z=z_t.to(d), y=y_t.to(d), status=status,
            iters=iters, r_prim=r_p.to(d), r_dual=r_d.to(d),
            obj=objective(qp64, x_t, z_t).to(d), rho=rho.to(d),
            history=sol.history.to(d))

    # f64 fallback for targets below the f32 dual floor: a warm-started,
    # capped last-digit refiner (native f64 on the device) that exits on
    # a plateau whatever the caller's stall_checks.
    s64 = settings.replace(precision="single", warm_start=True,
                           recenter_rounds=0,
                           stall_checks=max(settings.stall_checks, 16),
                           max_iter=min(settings.max_iter, _F64_MAX_ITER))
    sol64 = _ref_phase(qp64, x_t, z_t, y_t, s64, backend, mesh=mesh)
    return Solution(
        x=sol64.x.to(d), z=sol64.z.to(d), y=sol64.y.to(d),
        status=torch.where(p1_inf, sol.status, sol64.status),
        iters=iters + sol64.iters,
        r_prim=sol64.r_prim.to(d), r_dual=sol64.r_dual.to(d),
        obj=sol64.obj.to(d), rho=sol64.rho.to(d),
        history=sol64.history.to(d))


def _ref_solve_shared_core(qp, x0, z0, y0, settings: Settings,
                           backend: str, mesh=None) -> Solution:
    precision = settings.precision
    if precision == "single":
        return _ref_phase(qp, x0, z0, y0, settings, backend, mesh=mesh)
    f64 = torch.float64
    if precision == "double":
        return _ref_phase(qp.astype(f64), x0.to(f64), z0.to(f64),
                          y0.to(f64), settings, backend, mesh=mesh)
    if settings.recenter_rounds > 0:
        return _ref_solve_shared_recentered(qp, x0, z0, y0, settings,
                                            backend, mesh)
    # recenter_rounds=0: the classic f32 -> f64 two-phase.
    f32 = torch.float32
    sol32 = _ref_phase(qp.astype(f32), x0.to(f32), z0.to(f32), y0.to(f32),
                       _ref_s32_of_shared(settings), backend, mesh=mesh)
    sol64 = _ref_phase(qp.astype(f64), clean64(sol32.x), clean64(sol32.z),
                       clean64(sol32.y),
                       settings.replace(precision="single", warm_start=True),
                       backend, mesh=mesh)
    p1_inf = (sol32.status == _PINF) | (sol32.status == _DINF)
    d = qp.dtype
    return Solution(
        x=sol64.x.to(d), z=sol64.z.to(d), y=sol64.y.to(d),
        status=torch.where(p1_inf, sol32.status, sol64.status),
        iters=sol32.iters + sol64.iters,
        r_prim=sol64.r_prim.to(d), r_dual=sol64.r_dual.to(d),
        obj=sol64.obj.to(d), rho=sol64.rho.to(d), history=sol64.history)


def _ref_solve_batch_shared(qp: QPData, settings: Settings = Settings(),
                            x0=None, z0=None, y0=None,
                            mesh: Mesh | None = None) -> Solution:
    if qp.l.dim() < 2:
        raise ValueError("solve_batch_shared expects batched l/u (B, m)")
    dtype, dev = qp.dtype, qp.device
    B = qp.l.shape[0]
    if x0 is None:
        x0 = torch.zeros((B, qp.n), dtype=dtype, device=dev)
    if z0 is None:
        z0 = torch.zeros((B, qp.m), dtype=dtype, device=dev)
    if y0 is None:
        y0 = torch.zeros_like(z0)
    backend = resolve_backend(settings, dev, qp.n)
    return _ref_solve_shared_core(qp, x0, z0, y0, settings, backend, mesh)


def _ref_record(hist, ptr, it, r_p, r_d):
    """One (iteration, r_prim, r_dual) row of the ring buffer."""
    hist[ptr % hist.shape[0]] = torch.stack(
        [torch.tensor(float(it), dtype=hist.dtype, device=hist.device),
         r_p.to(hist.dtype), r_d.to(hist.dtype)])


def _ref_run_consensus(qp_blk: QPData, spec: ConsensusSpec, settings: Settings,
                       loc: Local, x0, z0, y0, backend: str, scaling_vecs,
                       z_off=None, rho0=None) -> PhaseResult:
    dtype, dev = qp_blk.dtype, qp_blk.device
    d_s, e_s, c_s = scaling_vecs
    einv = 1.0 / e_s
    cd_inv = 1.0 / (c_s * d_s)
    idx = torch.arange(spec.mb, device=dev)
    box_eq = ((qp_blk.l == qp_blk.u) & torch.isfinite(qp_blk.l)
              & (idx < spec.cone.m_box))
    rho = _Rho(qp_blk, spec, settings, backend, box_eq)
    rho_bar = (torch.tensor(settings.rho, dtype=dtype, device=dev)
               if rho0 is None else rho0.to(dtype))
    fac = rho.factor(rho_bar)
    nlam = _l1_scale(qp_blk, spec, cd_inv, loc)
    use_cert = settings.eps_pinf > 0 or settings.eps_dinf > 0
    k = settings.check_every
    interval_checks = max(1, settings.adaptive_rho_interval // k)
    restart_checks = settings.restart_every and max(
        1, settings.restart_every // k)
    hist = torch.full((max(settings.history, 0), 3), -1.0, dtype=dtype,
                      device=dev)

    def global_res(x, z, y):
        """Globally reduced unscaled residual norms (7-tuple)."""
        Ax = mv(qp_blk.A, x)
        Px = mv(qp_blk.P, x)
        Aty = vm(y, qp_blk.A)
        return (_linf_global(einv * (Ax - z), loc),
                _linf_global(cd_inv * (Px + qp_blk.q + Aty), loc),
                _linf_global(einv * Ax, loc), _linf_global(einv * z, loc),
                _linf_global(cd_inv * Px, loc),
                _linf_global(cd_inv * Aty, loc),
                torch.maximum(_linf_global(cd_inv * qp_blk.q, loc), nlam))

    x, z, y = x0, z0, y0
    x_chk, y_chk = x0, y0
    sums = [torch.zeros_like(t) for t in (x0, z0, y0)]
    cnt = 0
    it = 0
    status = torch.tensor(_UNSOLVED, dtype=torch.int32, device=dev)
    r_prim = r_dual = torch.tensor(float("inf"), dtype=dtype, device=dev)
    done = False
    while not done and it < settings.max_iter:
        check = it // k
        rho_vec = rho.vec(rho_bar)
        for _ in range(k):
            x, z, y = consensus_body(qp_blk, spec, settings, loc, fac, x, z,
                                     y, rho_vec, backend, z_off=z_off)
        it += k
        res = global_res(x, z, y)
        # Certificates use PRE-restart deltas: a restart replaces the
        # iterate with a window average, which wrecks the delta ray.
        cert = (infeasibility_blocks(qp_blk, spec, settings, loc,
                                     scaling_vecs, x - x_chk, y - y_chk)
                if use_cert else None)
        x_chk, y_chk = x, y

        # Restarted averaging: the comparison uses globally reduced
        # norms, so every rank takes the same decision, and the average
        # keeps the agreement-row pairing.
        sums = [s + t for s, t in zip(sums, (x, z, y))]
        cnt += 1
        if restart_checks and check % restart_checks == restart_checks - 1:
            xa, za, ya = (s / float(cnt) for s in sums)
            res_a = global_res(xa, za, ya)
            take = _ratio(res_a, settings) < _ratio(res, settings)
            x, z, y = (torch.where(take, a, b)
                       for a, b in ((xa, x), (za, z), (ya, y)))
            res = tuple(torch.where(take, ra, rc)
                        for ra, rc in zip(res_a[:6], res[:6])) + (res[6],)
            sums = [torch.zeros_like(s) for s in sums]
            cnt = 0

        status = _status(res, settings, cert)
        r_prim, r_dual = res[0], res[1]
        do = torch.zeros((), dtype=torch.bool, device=dev)
        if (settings.adaptive_rho
                and check % interval_checks == interval_checks - 1):
            new_rho, changed = _balance(res, rho_bar, settings)
            do = changed & (status == _UNSOLVED)
        if hist.shape[0]:
            _ref_record(hist, check, it, r_prim, r_dual)
        # The one device-to-host read of this check.
        flags = runtime.agree(
            torch.stack([(status != _UNSOLVED).to(torch.int32),
                         do.to(torch.int32)]), loc.mesh)
        done, do = (bool(f) for f in flags.tolist())
        if do:
            rho_bar = new_rho
            fac = rho.refresh(fac, rho_bar)
    status = torch.where(status == _UNSOLVED, int(Status.MAX_ITER),
                         status).to(torch.int32)
    return PhaseResult(x, z, y, status,
                       torch.tensor(it, dtype=torch.int32, device=dev),
                       r_prim, r_dual, rho_bar, hist)


def _ref_run_consensus_mc(qp_blk: QPData, spec: ConsensusSpec,
                          settings: Settings, loc: Local, x0, z0, y0,
                          backend: str, scaling_vecs, z_off=None,
                          rho0=None) -> PhaseResult:
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
            _ref_record(hist, check, it,
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


def _ref_run_horizon(hp: HorizonParts, spec: HorizonSpec, settings: Settings,
                     loc: Local, x0, z0, y0):
    dtype, dev = hp.q.dtype, hp.q.device
    mesh = loc.mesh
    S = hp.q.shape[0]
    ni, b, npb, mp = spec.ni, spec.b, spec.npb, spec.mp
    B_loc = x0.shape[0]
    sigma = settings.sigma
    alpha = settings.alpha
    cone = spec.cone
    mb_loc, ml_loc = cone.m_box, cone.m_l1
    is_first, is_last = loc.is_first, loc.is_last          # (S, 1)
    l0, u0 = hp.l[0], hp.u[0]
    row_idx = torch.arange(mp, device=dev)
    # Only box rows are equalities (cf. problem.is_equality_row).
    eq = (l0 == u0) & torch.isfinite(l0) & (row_idx < mb_loc)
    is_soc_row = row_idx >= mb_loc + ml_loc

    def rho_vec_of(rb):
        rv = torch.where(eq, settings.rho_eq_scale * rb, rb)
        if cone.m_soc and settings.rho_soc_scale != 1.0:
            rv = torch.where(is_soc_row, settings.rho_soc_scale * rb, rv)
        return rv

    def factor(rb):
        rv = rho_vec_of(rb)
        Mpp = (hp.A_loc.mT @ (rv[..., None] * hp.A_loc)
               + sigma * torch.eye(npb, dtype=dtype, device=dev)
               + torch.diag_embed(hp.P_diag))
        # The next part's A_haloᵀ ρ A_halo lands on OUR separator block.
        corner = _neighbor_next(
            (hp.A_halo.mT @ (rv[..., None] * hp.A_halo)).reshape(S, b * b),
            loc).reshape(S, b, b)
        Mpp[:, ni:, ni:] += torch.where(is_last[:, :, None], 0.0, corner)
        # E couples OUR first variable block to the previous part's
        # separator: A_locᵀ ρ A_halo (partition_qp keeps it inside the
        # first b variable rows).
        E = (hp.A_loc.mT @ (rv[..., None] * hp.A_halo))[:, :b, :]
        E = torch.where(is_first[:, :, None], 0.0, E)
        fac = _spike_factor_sharded(Mpp, E, spec, loc)
        return {**fac, **_spike_reduce_factor(fac, loc)}

    def spmv_A(x):
        """A x with the halo term: x (B, S, npb) -> (B, S, mp)."""
        x_last_prev = _neighbor_prev(x[..., ni:], loc)
        halo = mv(hp.A_halo, x_last_prev)
        return mv(hp.A_loc, x) + torch.where(is_first, 0.0, halo)

    def spmv_At(v):
        """Aᵀ v scattered back onto x: v (B, S, mp) -> (B, S, npb)."""
        mine = vm(v, hp.A_halo)                             # (B, S, b)
        from_next = _neighbor_next(torch.where(is_first, 0.0, mine), loc)
        from_next = torch.where(is_last, 0.0, from_next)
        out = vm(v, hp.A_loc)
        return torch.cat([out[..., :ni], out[..., ni:] + from_next], dim=-1)

    def linf_scen(*vs):
        """Per-scenario inf-norms of each v over (parts, rows), reduced
        over 'horizon' (one collective)."""
        return _pmax(torch.stack([v.abs().amax(dim=(-2, -1)) for v in vs]),
                     loc)

    nq = linf_scen(hp.q[None])[0]
    if ml_loc:
        # L1 gradient scale in the dual-norm reference (cf. core.admm.
        # l1_grad_scale_raw): max_j max_i lam_i |A[i, j]| over the L1
        # rows, whose column support is local + halo.
        sl = slice(mb_loc, mb_loc + ml_loc)
        lamA = torch.maximum(
            (hp.lam[:, :, None] * hp.A_loc[:, sl, :].abs()).amax(),
            (hp.lam[:, :, None] * hp.A_halo[:, sl, :].abs()).amax())
        nq = torch.maximum(nq, _pmax(lamA, loc))

    def body_iter(x, z, y, fac, rho_vec):
        rhs = sigma * x - hp.q + spmv_At(rho_vec * z - y)
        xt = _spike_solve_sharded(fac, rhs, loc, spec)
        zt = spmv_A(xt)
        x_new = alpha * xt + (1.0 - alpha) * x
        w = alpha * zt + (1.0 - alpha) * z
        v = w + y / rho_vec
        lam_r = (hp.lam / rho_vec[..., mb_loc:mb_loc + ml_loc]
                 if ml_loc else hp.lam)
        z_new = project_cone(v, hp.l, hp.u, lam_r, cone)
        y_new = y + rho_vec * (w - z_new)
        return x_new, z_new, y_new

    def residuals(x, z, y):
        Ax = spmv_A(x)
        Px = hp.P_diag * x
        Aty = spmv_At(y)
        return tuple(linf_scen(Ax - z, Px + hp.q + Aty, Ax, z, Px,
                               Aty)) + (nq,)

    rho_bar = torch.tensor(settings.rho, dtype=dtype, device=dev)
    fac = factor(rho_bar)
    k = settings.check_every
    interval_checks = max(1, settings.adaptive_rho_interval // k)
    tiny = torch.finfo(dtype).tiny
    x, z, y = x0, z0, y0
    it = 0
    iters_sc = torch.zeros(B_loc, dtype=torch.int32, device=dev)
    status = torch.full((B_loc,), _UNSOLVED, dtype=torch.int32, device=dev)
    r_p = r_d = torch.full((B_loc,), float("inf"), dtype=dtype, device=dev)
    alive = True
    while alive and it < settings.max_iter:
        check = it // k
        rho_vec = rho_vec_of(rho_bar)
        active = status == _UNSOLVED
        xn, zn, yn = x, z, y
        for _ in range(k):
            xn, zn, yn = body_iter(xn, zn, yn, fac, rho_vec)
        am = active[:, None, None]
        x, z, y = (torch.where(am, a, o)
                   for a, o in ((xn, x), (zn, z), (yn, y)))
        it += k
        iters_sc = iters_sc + active.to(torch.int32) * k

        rp_n, rd_n, nAx, nz, nPx, nAty, nq_ = residuals(x, z, y)
        eps_p = settings.eps_abs + settings.eps_rel * torch.maximum(nAx, nz)
        eps_d = settings.eps_abs + settings.eps_rel * torch.maximum(
            torch.maximum(nPx, nAty), nq_)
        solved = (rp_n <= eps_p) & (rd_n <= eps_d)
        numerr = ~(torch.isfinite(rp_n) & torch.isfinite(rd_n))
        status = torch.where(
            active,
            torch.where(numerr, int(Status.NUMERICAL_ERROR),
                        torch.where(solved, _SOLVED, _UNSOLVED)),
            status).to(torch.int32)
        r_p = torch.where(active, rp_n, r_p)
        r_d = torch.where(active, rd_n, r_d)

        still = status == _UNSOLVED
        do = torch.zeros((), dtype=torch.bool, device=dev)
        if (settings.adaptive_rho
                and check % interval_checks == interval_checks - 1):
            sp = r_p / torch.clamp(torch.maximum(nAx, nz), min=tiny)
            sd = r_d / torch.clamp(
                torch.maximum(torch.maximum(nPx, nAty), nq_), min=tiny)
            logr = torch.where(still, torch.log(torch.sqrt(
                torch.clamp(sp, min=tiny) / torch.clamp(sd, min=tiny))), 0.0)
            tot = runtime.psum(logr.sum(), mesh, DATA_AXIS)
            cnt = runtime.psum(still.sum(), mesh, DATA_AXIS)
            ratio = torch.exp(tot / torch.clamp(cnt, min=1))
            new_rho = torch.clamp(rho_bar * ratio, settings.rho_min,
                                  settings.rho_max)
            tol = settings.adaptive_rho_tol
            do = ((ratio > tol) | (ratio < 1.0 / tol)) & (cnt > 0)
        # The one device-to-host read of this check: liveness of any
        # scenario on any rank, and the shared refactor decision.
        flags = runtime.agree(
            torch.stack([still.any(), do]).to(torch.int32), mesh)
        alive, do = (bool(f) for f in flags.tolist())
        if do:
            rho_bar = new_rho
            fac = factor(rho_bar)
    status = torch.where(status == _UNSOLVED, int(Status.MAX_ITER),
                         status).to(torch.int32)
    return x, z, y, status, iters_sc, r_p, r_d, rho_bar


def _ref_cg_rowsharded(P, A_loc, rho_loc, sigma, rhs, mesh: Mesh, tol: float,
                   max_iter: int):
    """CG on the condensed operator with row-sharded A; every rank holds
    the same n-vectors. Stops once ‖r‖² ≤ tol²·max(‖rhs‖², 1) or after
    max_iter steps. The host reads the stop every _CG_CHECK steps; in
    between, a step taken after the test holds has α = 0 and leaves x
    and r as they were, so the result is the one of a stop at that very
    step (as ops/kkt.cg_solve). Returns (x, the steps taken)."""
    def op(v):
        At = runtime.psum((rho_loc * (A_loc @ v)) @ A_loc, mesh, DATA_AXIS)
        return P @ v + sigma * v + At

    tiny = torch.finfo(rhs.dtype).tiny
    x = torch.zeros_like(rhs)
    r = rhs - op(x)
    p = r
    rs = torch.dot(r, r)
    tol2 = (tol * tol) * torch.clamp(torch.dot(rhs, rhs), min=1.0)
    steps = torch.zeros((), dtype=torch.int32, device=rhs.device)
    for it in range(max_iter):
        live = rs > tol2
        if it % _CG_CHECK == 0 and not bool(
                runtime.agree(live.to(torch.int32)[None], mesh)):
            break
        Mp = op(p)
        alpha = torch.where(
            live, rs / torch.clamp(torch.dot(p, Mp), min=tiny), 0.0)
        x = x + alpha * p
        r = r - alpha * Mp
        rs_new = torch.dot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=tiny)) * p
        rs = torch.where(live, rs_new, rs)
        steps = steps + live.to(torch.int32)
    return x, steps


def _ref_solve_rowsharded(qp: QPData, mesh: Mesh,
                          settings: Settings = Settings(),
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

    def zeros(k):
        return torch.zeros(k, dtype=dtype, device=dev)

    def as_dev(t, k):
        return zeros(k) if t is None else torch.as_tensor(t).to(dev, dtype)

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
    P_mat, q = qps.P, qps.q
    d_v, c_v = scaling.d, scaling.c

    einv_loc = 1.0 / e_loc
    cd_inv = 1.0 / (c_v * d_v)
    k = s.check_every
    interval_checks = max(1, s.adaptive_rho_interval // k)
    restart_checks = s.restart_every and max(1, s.restart_every // k)
    use_cert = s.eps_pinf > 0 or s.eps_dinf > 0
    mbl_box, nl = cone_loc.m_box, cone_loc.m_l1
    mbl = mbl_box + nl
    tiny = torch.finfo(dtype).tiny
    inf = float("inf")

    def pmax_abs(*vs):
        """Max |v| of each row-local v over the axis (one collective)."""
        return runtime.pmax(torch.stack([v.abs().max() for v in vs]), mesh,
                            DATA_AXIS)

    def psum(v):
        return runtime.psum(v, mesh, DATA_AXIS)

    # L1 gradient scale in the dual-norm reference (core.admm.
    # l1_grad_scale): L1 rows are row-local, so the column max takes a
    # max over the axis.
    if nl:
        lamA = (lam_loc[mbl_box:mbl, None]
                * A_loc[mbl_box:mbl].abs()).amax(dim=0)
        nlam = pmax_abs(cd_inv * lamA)[0]
    else:
        nlam = torch.zeros((), dtype=dtype, device=dev)

    def rho_of(rb):
        return torch.where(eq_loc, s.rho_eq_scale * rb, rb)

    cg_steps = torch.zeros((), dtype=torch.int32, device=dev)

    def iter_once(x, z, y, rho_bar, cg_steps):
        rho_loc = rho_of(rho_bar)
        rhs = s.sigma * x - q + psum((rho_loc * z - y) @ A_loc)
        xt, steps = _ref_cg_rowsharded(P_mat, A_loc, rho_loc, s.sigma, rhs,
                                   mesh, s.cg_tol, s.cg_max_iter)
        zt = A_loc @ xt
        a = s.alpha
        x_new = a * xt + (1 - a) * x
        w = a * zt + (1 - a) * z
        v = w + y / rho_loc
        lam_r = lam_loc[mbl_box:mbl] / rho_loc[mbl_box:mbl]
        z_new = project_cone(v, l_loc, u_loc, lam_r, cone_loc)
        y_new = y + rho_loc * (w - z_new)
        return x_new, z_new, y_new, cg_steps + steps

    def row_res(x, z, y):
        """Globally reduced unscaled residual norms (7-tuple)."""
        Ax = A_loc @ x
        Aty = psum(y @ A_loc)
        Px = P_mat @ x
        r_p, nAx, nz = pmax_abs(einv_loc * (Ax - z), einv_loc * Ax,
                                einv_loc * z)
        r_d = (cd_inv * (Px + q + Aty)).abs().max()
        nPx = (cd_inv * Px).abs().max()
        nAty = (cd_inv * Aty).abs().max()
        nq = torch.maximum((cd_inv * q).abs().max(), nlam)
        return r_p, r_d, nAx, nz, nPx, nAty, nq

    def eps_of(res):
        _, _, nAx, nz, nPx, nAty, nq = res
        eps_p = s.eps_abs + s.eps_rel * torch.maximum(nAx, nz)
        eps_d = s.eps_abs + s.eps_rel * torch.maximum(
            nPx, torch.maximum(nAty, nq))
        return eps_p, eps_d

    def ratio_of(res):
        ep, ed = eps_of(res)
        return torch.maximum(res[0] / ep, res[1] / ed)

    def count_bad(ok):
        return psum((~ok).to(torch.int32).sum())

    def infeasibility_local(dx_s, dy_s):
        """OSQP §3.4 certificates on row-sharded data (cf. core.admm.
        infeasibility): dx_s whole (n,), dy_s row-local; every
        cross-shard quantity is reduced over the axis, so every rank
        reaches the same verdicts."""
        eps_pi, eps_di = s.eps_pinf, s.eps_dinf

        # ---- primal infeasibility from dy ----
        dy = (e_loc / c_v) * dy_s
        ndy = pmax_abs(dy)[0]
        dyn = dy / torch.clamp(ndy, min=tiny)
        Aty = psum(((c_v / e_loc) * dyn) @ A_loc) * cd_inv
        cond_A = Aty.abs().max() <= eps_pi
        lu_l = l_loc[:mbl] * einv_loc[:mbl]
        lu_u = u_loc[:mbl] * einv_loc[:mbl]
        dyb = dyn[:mbl]
        up = torch.where(dyb > eps_pi, torch.where(
            torch.isfinite(lu_u), lu_u * dyb, inf), 0.0)
        lo = torch.where(dyb < -eps_pi, torch.where(
            torch.isfinite(lu_l), lu_l * dyb, inf), 0.0)
        sup = psum((up + lo).sum())
        if cone_loc.m_soc:
            d_soc = cone_loc.soc_dims[0]
            blk = dyn[mbl:].reshape(cone_loc.n_soc, d_soc)
            ok = (torch.linalg.vector_norm(blk[:, 1:], dim=-1)
                  <= -blk[:, 0] + eps_pi)
            sup = torch.where(count_bad(ok) > 0, inf, sup)
        pinf = (ndy > 0) & cond_A & (sup <= eps_pi)

        # ---- dual infeasibility from dx (whole) ----
        dx = d_v * dx_s
        ndx = dx.abs().max()
        dxn = dx / torch.clamp(ndx, min=tiny)
        Pdx = (P_mat @ (dxn / d_v)) * cd_inv
        Adx = einv_loc * (A_loc @ (dxn / d_v))
        cond_P = Pdx.abs().max() <= eps_di
        qdx = ((cd_inv * q) * dxn).sum()
        if nl:
            sl = slice(mbl_box, mbl)
            lam_u = lam_loc[sl] * e_loc[sl] / c_v
            qdx = qdx + psum((lam_u * Adx[sl].abs()).sum())
        cond_q = qdx <= -eps_di
        av = Adx[:mbl]
        ok_up = (av <= eps_di) | ~torch.isfinite(lu_u)
        ok_lo = (av >= -eps_di) | ~torch.isfinite(lu_l)
        cond_box = count_bad(ok_up & ok_lo) == 0
        cond_soc = True
        if cone_loc.m_soc:
            d_soc = cone_loc.soc_dims[0]
            blk = Adx[mbl:].reshape(cone_loc.n_soc, d_soc)
            ok = (torch.linalg.vector_norm(blk[:, 1:], dim=-1)
                  <= blk[:, 0] + eps_di)
            cond_soc = count_bad(ok) == 0
        dinf = (ndx > 0) & cond_P & cond_q & cond_box & cond_soc
        return pinf, dinf

    rho_bar = torch.tensor(s.rho, dtype=dtype, device=dev)
    status = torch.tensor(_UNSOLVED, dtype=torch.int32, device=dev)
    r_p = r_d = torch.tensor(inf, dtype=dtype, device=dev)
    sums = [torch.zeros_like(t) for t in (x, z, y)]
    avg_cnt = 0
    x_chk, y_chk = x, y
    it = 0
    done = False
    while not done and it < s.max_iter:
        check = it // k
        for _ in range(k):
            x, z, y, cg_steps = iter_once(x, z, y, rho_bar, cg_steps)
        it += k
        res = row_res(x, z, y)

        # Restarted averaging (Settings.restart_every): the decision
        # uses globally reduced norms, so every rank takes the same one.
        sums = [a + b for a, b in zip(sums, (x, z, y))]
        avg_cnt += 1
        if restart_checks and check % restart_checks == restart_checks - 1:
            xa, za, ya = (t / float(avg_cnt) for t in sums)
            res_a = row_res(xa, za, ya)
            take = ratio_of(res_a) < ratio_of(res)
            x, z, y = (torch.where(take, a, b)
                       for a, b in ((xa, x), (za, z), (ya, y)))
            res = tuple(torch.where(take, ra, rc)
                        for ra, rc in zip(res_a[:6], res[:6])) + (res[6],)
            sums = [torch.zeros_like(t) for t in sums]
            avg_cnt = 0

        r_p, r_d = res[0], res[1]
        eps_p, eps_d = eps_of(res)
        status = torch.where((r_p <= eps_p) & (r_d <= eps_d), _SOLVED,
                             _UNSOLVED).to(torch.int32)
        if use_cert:
            pinf, dinf = infeasibility_local(x - x_chk, y - y_chk)
            status = torch.where(
                status == _SOLVED, status,
                torch.where(pinf, int(Status.PRIMAL_INFEASIBLE),
                            torch.where(dinf, int(Status.DUAL_INFEASIBLE),
                                        status))).to(torch.int32)
        # Adaptive rho: free under CG, and every input is a reduced
        # scalar, so every rank computes the same new rho.
        if s.adaptive_rho and check % interval_checks == interval_checks - 1:
            _, _, nAx, nz, nPx, nAty, nq = res
            sp = r_p / torch.clamp(torch.maximum(nAx, nz), min=tiny)
            sd = r_d / torch.clamp(torch.maximum(torch.maximum(nPx, nAty),
                                                 nq), min=tiny)
            ratio = torch.sqrt(sp / torch.clamp(sd, min=tiny))
            new_rho = torch.clamp(rho_bar * ratio, s.rho_min, s.rho_max)
            tol = s.adaptive_rho_tol
            changed = (ratio > tol) | (ratio < 1.0 / tol)
            rho_bar = torch.where(changed & (status == _UNSOLVED), new_rho,
                                  rho_bar)
        x_chk, y_chk = x, y
        # The one device-to-host read of this check.
        done = bool(runtime.agree(
            (status != _UNSOLVED).to(torch.int32)[None], mesh))
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
        iters=torch.tensor(it, dtype=torch.int32, device=dev),
        r_prim=r_p, r_dual=r_d, rho=rho_bar, cg_steps=cg_steps)


# ---- solve and solve_batch as they stood before their phases, polish,
# rounds and warm-start check became captured segments: host code around
# `_ref_run_admm`, `_ref_run_admm_lanes` and `_ref_solve_batch_shared`,
# one eager kernel at a time. ----

_INFEASIBLE = (_PINF, _DINF)


def _ref_int32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def _ref_solve_one_phase(qp: QPData, x0, z0, y0, settings: Settings,
                     backend: str, z_off=None, rho0=None) -> Solution:
    """Ruiz-scale, run `run_admm` in qp's dtype, unscale.

    z_off: unscaled shifted-prox offset for the L1/SOC rows (it keeps
    its own dtype); rho0: warm rho-bar as a Python float.
    """
    qps, scaling = ruiz_equilibrate(qp, settings.scaling_iters)
    if settings.warm_start:
        xs = scaling.scale_x(x0)
        zs = scaling.scale_z(z0)
        ys = scaling.scale_y(y0)
    else:
        xs, zs, ys = x0, z0, y0
    if z_off is not None:
        z_off = scaling.scale_z(z_off)      # offsets live in z-space
    lanes = qp.P.dim() == 3
    run = _ref_run_admm_lanes if lanes else _ref_run_admm
    carry = run(qps, scaling, settings, xs, zs, ys, backend, z_off=z_off,
                rho0=rho0)
    x = scaling.unscale_x(carry.x)
    z = scaling.unscale_z(carry.z)
    y = scaling.unscale_y(carry.y)
    return Solution(
        x=x, z=z, y=y, status=carry.status,
        iters=carry.it if lanes else _ref_int32(carry.it, qp.device),
        r_prim=carry.r_prim, r_dual=carry.r_dual, obj=objective(qp, x, z),
        rho=carry.rho_bar, history=carry.hist)


def _ref_s32_of(settings: Settings) -> Settings:
    """f32-phase settings: relaxed eps and condition-number caps (the
    equality-rho boost times rho over sigma must stay well under
    1/eps_f32, or the f32 factorisation fails; sigma does not move the
    ADMM fixed point)."""
    return settings.replace(
        precision="single",
        eps_abs=max(settings.hybrid_eps, settings.eps_abs),
        eps_rel=max(settings.hybrid_eps, settings.eps_rel),
        sigma=max(settings.sigma, 1e-5),
        rho_eq_scale=min(settings.rho_eq_scale, 1e2),
        polish=False)


def _ref_cast(sol: Solution, dtype: torch.dtype, **kw) -> Solution:
    """sol with every floating leaf in `dtype` (history included),
    fields in `kw` replaced first."""
    sol = dataclasses.replace(sol, **kw)
    return dataclasses.replace(
        sol, **{f: getattr(sol, f).to(dtype)
                for f in ("x", "z", "y", "r_prim", "r_dual", "obj", "rho",
                          "history")})


def _ref_finish(sol: Solution, sol32: Solution, out_dtype) -> Solution:
    """Combine phase results: cast out, add the iteration counts, keep
    a phase-1 infeasibility verdict."""
    p1_inf = ((sol32.status == _INFEASIBLE[0])
              | (sol32.status == _INFEASIBLE[1]))
    return _ref_cast(sol, out_dtype,
                 status=torch.where(p1_inf, sol32.status, sol.status),
                 iters=sol32.iters + sol.iters)


def _ref_solve_core(qp: QPData, x0, z0, y0, settings: Settings,
                backend: str) -> Solution:
    """One problem, or a lockstep batch of independent ones (every leaf
    with a leading lane axis), by precision strategy: 'single' in qp's
    dtype, 'double' in f64, 'hybrid' as an f32 phase to hybrid_eps and
    a warm-started f64 phase to the target."""
    f32, f64 = torch.float32, torch.float64
    if settings.precision == "single":
        return _ref_solve_one_phase(qp, x0, z0, y0, settings, backend)
    if settings.precision == "double":
        return _ref_solve_one_phase(qp.astype(f64), x0.to(f64), z0.to(f64),
                                y0.to(f64), settings, backend)
    sol32 = _ref_solve_one_phase(qp.astype(f32), x0.to(f32), z0.to(f32),
                             y0.to(f32), _ref_s32_of(settings), backend)
    sol64 = _ref_solve_one_phase(
        qp.astype(f64), clean64(sol32.x), clean64(sol32.z),
        clean64(sol32.y),
        settings.replace(precision="single", warm_start=True), backend)
    return _ref_finish(sol64, sol32, qp.dtype)


def _ref_recentered_rounds(qp: QPData, qp64: QPData, sol0: Solution,
                       settings: Settings, backend: str, try_polish=None):
    """Up to recenter_rounds f32 correction solves around the f64 point
    sol0; returns (Solution in f64, solved).

    Each round re-solves the same problem in shifted coordinates: box
    rows shift exactly (bounds − Ax), L1/SOC rows keep their bounds and
    lam and evaluate the shifted prox with an f64 offset = Ax. True
    residuals are evaluated in f64 on the original data; the rounds stop
    once those meet the criterion, or once `try_polish` (called after
    every round) returns SOLVED.
    """
    f32 = torch.float32
    dev = qp.device
    mb = qp.cone.m_box
    x_t, y_t, z_t = sol0.x, sol0.y, sol0.z
    iters = _ref_int32(0, dev)
    rho = sol0.rho
    # Correction problems are feasible by construction and mix shifted
    # and original rows, so infeasibility certificates mean nothing
    # there.
    s_c = _ref_s32_of(settings).replace(
        eps_abs=settings.eps_abs, eps_rel=settings.eps_rel,
        eps_pinf=0.0, eps_dinf=0.0)

    solved = False
    r_p, r_d = sol0.r_prim, sol0.r_dual
    for _ in range(settings.recenter_rounds):
        Ax, Px, r_p, r_d, eps_p, eps_d, ok = admm.unscaled_criterion(
            qp64, x_t, z_t, y_t, settings.eps_abs, settings.eps_rel)
        solved = bool(ok)
        if solved:
            break
        # Each round only has to meet the ORIGINAL mixed criterion, whose
        # eps_rel term scales with the total norms: demanding the raw
        # eps_abs at the correction's scale costs ~100x the iterations.
        # Quantised to a power of two, as in the reference.
        eps_round = float(torch.minimum(eps_p, eps_d))
        eps_q = 2.0 ** math.floor(math.log2(max(eps_round,
                                                settings.eps_abs)))
        s_round = s_c.replace(eps_abs=eps_q, eps_rel=0.0)
        if settings.recenter_max_iter > 0:
            s_round = s_round.replace(max_iter=min(
                settings.max_iter, settings.recenter_max_iter))
        # g = Px + q only (no Aᵀy tilt): the correction problem is then
        # exactly the original in shifted coordinates, so its dual is a
        # complete dual of the original. Duals are warm-started and
        # replaced, never summed: summed partial duals leave junk on
        # inactive rows that tilts x off the optimum.
        l_c = torch.cat([qp64.l[:mb] - Ax[:mb], qp64.l[mb:]])
        u_c = torch.cat([qp64.u[:mb] - Ax[:mb], qp64.u[mb:]])
        off = torch.cat([torch.zeros_like(Ax[:mb]), Ax[mb:]])
        qp_c = QPData(P=qp.P.to(f32), q=(Px + qp64.q).to(f32),
                      A=qp.A.to(f32), l=l_c.to(f32), u=u_c.to(f32),
                      lam=qp.lam.to(f32), cone=qp.cone)
        sol_c = _ref_solve_one_phase(qp_c, torch.zeros_like(qp_c.q),
                                 (z_t - Ax).to(f32), y_t.to(f32), s_round,
                                 backend, z_off=off)
        x_t = x_t + clean64(sol_c.x)
        y_t = clean64(sol_c.y)
        z_t = Ax + clean64(sol_c.z)
        iters = iters + sol_c.iters
        rho = sol_c.rho.to(torch.float64)
        # Polish from the partly converged round: on min-fuel LPs the
        # active set locks in long before the first-order tail ends.
        if try_polish is not None:
            cand = Solution(
                x=x_t, z=z_t, y=y_t, status=_ref_int32(0, dev), iters=iters,
                r_prim=r_p, r_dual=r_d, obj=objective(qp64, x_t, z_t),
                rho=rho, history=sol0.history)
            pol = try_polish(cand)
            if int(pol.status) == _SOLVED:
                return dataclasses.replace(pol, iters=iters), True
    if not solved:
        _, _, r_p, r_d, _, _, ok = admm.unscaled_criterion(
            qp64, x_t, z_t, y_t, settings.eps_abs, settings.eps_rel)
        solved = bool(ok)
    status = _ref_int32(int(Status.SOLVED if solved else Status.MAX_ITER), dev)
    return Solution(
        x=x_t, z=z_t, y=y_t, status=status, iters=iters, r_prim=r_p,
        r_dual=r_d, obj=objective(qp64, x_t, z_t), rho=rho,
        history=sol0.history), solved


def _ref_f64_continuation(qp: QPData, sol: Solution, settings: Settings,
                      backend: str, chunk: int = 2000) -> Solution:
    """Chunked, warm-started f64 endgame for an SOC problem that the
    shared pass left unsolved.

    Degenerate min-fuel SOCPs (cost linear in the cone's t, most blocks
    at the tip at the optimum) defeat every f32 stage: the f32 phase
    chatters far above the hand-off and the re-centred rounds are built
    around a point too far out for their tip/boundary classification.
    Plain f64 ADMM with the SOC-row rho boost does converge, so this
    continues in f64 on the problem's device, warm-started, in chunks of
    `chunk` iterations, for at most one more max_iter budget.

    The stall exit is off inside a chunk (chatter would freeze a
    transient). rho carries across chunks as a Python float (run_admm's
    rho0). With Settings.polish, a polish attempt (act_tol 1e-4) follows
    every chunk, and the first SOLVED candidate ends the run. Otherwise
    the run ends when a chunk ends other than MAX_ITER or the budget is
    spent, and returns the best chunk-end point by max(r_prim, r_dual).

    Unlike the reference, the run does not stop after two chunks without
    a new best: chunk-end residuals chatter by an order of magnitude on
    these problems, so that test ends runs that are converging (the JAX
    package on the CPU quits config 4 at 10,525 iterations with MAX_ITER;
    its own chunks, run on, land SOLVED at 16,525).
    """
    dtype, dev = qp.dtype, qp.device
    qp64 = qp.astype(torch.float64)
    x, z, y = clean64(sol.x), clean64(sol.z), clean64(sol.y)
    rho = float(sol.rho.max())
    if not (rho > 0.0 and math.isfinite(rho)):
        rho = settings.rho
    iters = int(sol.iters)
    used = 0
    out = sol
    s_chunk = settings.replace(
        precision="single", warm_start=True, polish=False,
        recenter_rounds=0, max_iter=chunk, stall_checks=0)
    best = float("inf")
    while used < settings.max_iter:
        ph = _ref_solve_one_phase(qp64, x, z, y, s_chunk, backend, rho0=rho)
        done_it = int(ph.iters)
        used += done_it
        iters += done_it
        if settings.polish:
            pol = polish(qp64, ph, settings.eps_abs, settings.eps_rel,
                         act_tol=1e-4)
            if int(pol.status) == _SOLVED:
                return _ref_cast(pol, dtype, iters=_ref_int32(iters, dev),
                             rho=ph.rho, history=ph.history)
        score = float(torch.maximum(ph.r_prim, ph.r_dual))
        if score < best or int(ph.status) == _SOLVED:
            best = score
            out = dataclasses.replace(ph, iters=_ref_int32(iters, dev))
        else:
            out = dataclasses.replace(out, iters=_ref_int32(iters, dev))
        if int(ph.status) != int(Status.MAX_ITER) or done_it == 0:
            break
        x, z, y = ph.x, ph.z, ph.y
        rho = float(ph.rho.max())
    # Every floating leaf in qp's dtype, history included (the reference
    # leaves history in f64).
    return _ref_cast(out, dtype)


def _ref_warm_check(qp64: QPData, x0, z0, y0, eps_abs: float, eps_rel: float):
    """f64 check of a user's warm start against the stopping criterion:
    (r_prim, r_dual, solved, objective).

    Besides the primal and dual residuals, solved requires
    ‖z0 − Π(z0 + y0)‖∞ ≤ eps_p, with Π the cone prox at unit penalty.
    That holds exactly when z0 lies in the constraint set and y0 in the
    subdifferential of the cone term at z0 (box, L1 and SOC rows alike).
    Without it a point with r_prim = r_dual = 0 but z0 outside its
    bounds would pass.
    """
    _, _, r_p, r_d, eps_p, _, ok = admm.unscaled_criterion(
        qp64, x0, z0, y0, eps_abs, eps_rel)
    gap = admm.linf(z0 - project_cone(z0 + y0, qp64.l, qp64.u, qp64.lam,
                                      qp64.cone))
    return r_p, r_d, ok & (gap <= eps_p), objective(qp64, x0, z0)


def _ref_solve_staged(qp: QPData, x0, z0, y0, settings: Settings,
                  backend: str) -> Solution:
    """The staged hybrid path: f32 phase → polish at 10·hybrid_eps →
    re-centred f32 rounds (polish after each) → f64 phase → polish."""
    f32, f64 = torch.float32, torch.float64
    dtype = qp.dtype
    sol32 = _ref_solve_one_phase(qp.astype(f32), x0.to(f32), z0.to(f32),
                             y0.to(f32), _ref_s32_of(settings), backend)
    qp64 = qp.astype(f64)
    sol32_64 = Solution(
        x=clean64(sol32.x), z=clean64(sol32.z), y=clean64(sol32.y),
        status=sol32.status, iters=_ref_int32(0, qp.device),
        r_prim=sol32.r_prim.to(f64), r_dual=sol32.r_dual.to(f64),
        obj=sol32.obj.to(f64), rho=sol32.rho.to(f64),
        history=sol32.history.to(f64))

    def do_polish(sol_p, act_tol):
        return polish(qp64, sol_p, settings.eps_abs, settings.eps_rel,
                      act_tol=act_tol)

    if settings.polish:
        pol = do_polish(sol32_64, 10.0 * settings.hybrid_eps)
        if int(pol.status) == _SOLVED:
            return _ref_finish(pol, sol32, dtype)

    if settings.recenter_rounds > 0:
        tp = ((lambda cand: do_polish(cand, 1e-4))
              if settings.polish else None)
        sol_r, solved_r = _ref_recentered_rounds(qp, qp64, sol32_64, settings,
                                             backend, try_polish=tp)
        if solved_r:
            if settings.polish:
                pol = do_polish(sol_r, 1e-4)
                if int(pol.status) == _SOLVED:
                    return _ref_finish(
                        dataclasses.replace(pol, iters=sol_r.iters), sol32,
                        dtype)
            return _ref_finish(sol_r, sol32, dtype)
        sol32_64 = sol_r            # warm-start the f64 phase from it

    s64 = settings.replace(precision="single", warm_start=True,
                           polish=False)
    sol64 = _ref_solve_one_phase(qp64, sol32_64.x, sol32_64.z, sol32_64.y, s64,
                             backend)
    if settings.polish:
        sol64 = dataclasses.replace(do_polish(sol64, 1e-4),
                                    iters=sol64.iters)
    return _ref_finish(sol64, sol32, dtype)


def _ref_solve(qp: QPData, settings: Settings = Settings(),
          x0=None, z0=None, y0=None) -> Solution:
    """Solve one QP/SOCP, optionally warm-started from an unscaled
    (x0, z0, y0).

    A warm start that already meets the stopping criterion is returned
    as SOLVED at 0 iterations. 'single' and 'double' precision run one
    phase of run_admm. 'hybrid' (the default) runs box-only and SOC
    problems through solve_batch_shared at batch 1 (at least 4 rounds
    for SOC), and an SOC problem left unsolved there through
    `_f64_continuation`; L1 problems and recenter_rounds=0 take the
    staged path (module docstring).
    """
    if (qp.P.dim() != 2 or qp.A.dim() != 2 or qp.q.dim() != 1
            or qp.l.dim() != 1 or qp.u.dim() != 1):
        raise ValueError(
            "solve takes one problem (P (n, n), A (m, n), q (n,), l and u "
            "(m,)); for a batch that shares (P, A) use solve_batch_shared")
    cone = qp.cone
    dtype, dev = qp.dtype, qp.device
    warm_given = x0 is not None and z0 is not None and y0 is not None
    if x0 is None:
        x0 = torch.zeros(qp.n, dtype=dtype, device=dev)
    if z0 is None:
        z0 = torch.zeros(qp.m, dtype=dtype, device=dev)
    if y0 is None:
        y0 = torch.zeros_like(z0)
    backend = resolve_backend(settings, dev, qp.n)

    if warm_given and settings.warm_start:
        f64 = torch.float64
        r_p, r_d, ok, obj = _ref_warm_check(
            qp.astype(f64), x0.to(f64), z0.to(f64), y0.to(f64),
            settings.eps_abs, settings.eps_rel)
        if bool(ok):
            return Solution(
                x=x0, z=z0, y=y0, status=_ref_int32(_SOLVED, dev),
                iters=_ref_int32(0, dev),
                r_prim=r_p.to(dtype), r_dual=r_d.to(dtype),
                obj=obj.to(dtype),
                rho=torch.tensor(settings.rho, dtype=dtype, device=dev),
                history=torch.zeros((0, 3), dtype=dtype, device=dev))

    if settings.precision != "hybrid":
        return _ref_solve_core(qp, x0, z0, y0, settings, backend)
    if settings.recenter_rounds == 0 or (cone.m_l1 and not cone.m_soc):
        return _ref_solve_staged(qp, x0, z0, y0, settings, backend)

    qpb = QPData(P=qp.P, q=qp.q, A=qp.A, l=qp.l[None], u=qp.u[None],
                 lam=qp.lam, cone=cone)
    s_del = settings
    if cone.m_soc:
        # SOC corrections converge geometrically per round; the default
        # 2 rounds can stop just above an absolute target.
        s_del = settings.replace(
            recenter_rounds=max(settings.recenter_rounds, 4))
    solb = _ref_solve_batch_shared(qpb, s_del, x0=x0[None], z0=z0[None],
                              y0=y0[None])
    sol = Solution(
        x=solb.x[0], z=solb.z[0], y=solb.y[0], status=solb.status[0],
        iters=solb.iters[0], r_prim=solb.r_prim[0], r_dual=solb.r_dual[0],
        obj=solb.obj[0], rho=solb.rho, history=solb.history)
    # Box-only problems return without reading the status; only SOC
    # problems, whose f32 machinery can fail wholesale, continue in f64.
    if not cone.m_soc or int(sol.status) in (_SOLVED, *_INFEASIBLE):
        return sol
    return _ref_f64_continuation(qp, sol, settings, backend)


def _ref_solve_batch(qp_batch: QPData, settings: Settings = Settings(),
                x0=None, z0=None, y0=None) -> Solution:
    """Solve a batch of independent problems: every leaf of `qp_batch`
    carries a leading lane axis (P (B, n, n), A (B, m, n), q (B, n),
    l and u (B, m), lam (B, m_l1)); x0, z0, y0 likewise when given.

    One lockstep loop over the lanes (core.admm.run_admm_lanes) runs
    `_solve_core`'s pipeline, each lane with its own scaling, rho,
    factor and status; a lane that exits freezes with its own honest
    iteration count, and the loop runs to the slowest lane. There is no
    polish and no re-centred rounds, unlike `solve`. Lanes that share
    (P, A) are solved faster by `solve_batch_shared` (one shared factor).
    """
    if qp_batch.P.dim() != 3 or qp_batch.A.dim() != 3:
        raise ValueError(
            "solve_batch takes a batch of problems (P (B, n, n), A (B, m, "
            "n), q (B, n), l and u (B, m)); for one problem use solve")
    B, n, m = qp_batch.P.shape[0], qp_batch.n, qp_batch.m
    dtype, dev = qp_batch.dtype, qp_batch.device
    for name, shape in (("A", (B, m, n)), ("q", (B, n)), ("l", (B, m)),
                        ("u", (B, m)), ("lam", (B, qp_batch.cone.m_l1))):
        if tuple(getattr(qp_batch, name).shape) != shape:
            raise ValueError(f"solve_batch: {name} has shape "
                             f"{tuple(getattr(qp_batch, name).shape)}, "
                             f"expected {shape}")
    backend = resolve_backend(settings, dev, n)
    if backend == "pallas_cg":
        raise ValueError(
            "backend 'pallas_cg' takes one shared M per launch; solve "
            "lanes that share (P, A) with solve_batch_shared")
    if x0 is None:
        x0 = torch.zeros((B, n), dtype=dtype, device=dev)
    if z0 is None:
        z0 = torch.zeros((B, m), dtype=dtype, device=dev)
    if y0 is None:
        y0 = torch.zeros_like(z0)
    return _ref_solve_core(qp_batch, x0, z0, y0, settings, backend)


# ---- The loops over checks as host loops (before run_checks), by the
# kind of the loop they drive: `loop` is the driver's graph.CheckLoop,
# every segment one call of it. ----

def _host_phase_loop(loop, settings: Settings, restart_checks: int):
    """core.admm.run_phase's loop."""
    k = settings.check_every
    it = 0
    alive = True
    while alive and it < settings.max_iter:
        loop(admm.check_variant(it // k, settings, restart_checks))
        it += k
        alive, do = loop.state["flags"].tolist()
        if do:
            loop(admm.REFACTOR)


def _host_batch_loop(loop, settings: Settings, restart_checks: int):
    """parallel.batch._run_batch's loop (its mesh in the step, which a
    fused loop wraps with its pre)."""
    step = getattr(loop.step, "step", loop.step)
    mesh = step.keywords["mesh"]
    k = settings.check_every
    it = 0
    alive = True
    while alive and it < settings.max_iter:
        loop(admm.check_variant(it // k, settings, restart_checks))
        it += k
        alive, do = _agreed(loop.state["flags"], mesh)
        if do:
            loop(admm.REFACTOR)


def _host_rho(loop):
    """The consensus drivers' `_Rho`, rebuilt from the loop's state and
    the step's static arguments."""
    kw = loop.step.keywords
    state = loop.state
    qp = QPData(**state["qp"], cone=kw["spec"].cone)
    return _Rho(qp, kw["spec"], kw["settings"], kw["backend"],
                state["box_eq"])


def _host_consensus_loop(loop, settings: Settings, restart_checks: int):
    """parallel.consensus.run_consensus's loop: 'done' in flags[0], the
    refactor on the host."""
    mesh = loop.step.keywords["mesh"]
    k = settings.check_every
    it = 0
    done = False
    while not done and it < settings.max_iter:
        loop(admm.check_variant(it // k, settings, restart_checks))
        it += k
        done, do = (bool(f) for f in
                    runtime.agree(loop.state["flags"], mesh).tolist())
        if do:
            rho_bar = loop.state["new_rho"]
            loop.set(dict(rho_bar=rho_bar, fac=_host_rho(loop).refresh(
                loop.state["fac"], rho_bar)))


def _host_consensus_mc_loop(loop, settings: Settings, restart_checks: int):
    """parallel.consensus_mc.run_consensus_mc's loop: the refactor on the
    host."""
    mesh = loop.step.keywords["mesh"]
    k = settings.check_every
    it = 0
    alive = True
    while alive and it < settings.max_iter:
        loop(admm.check_variant(it // k, settings, restart_checks))
        it += k
        alive, do = (bool(f) for f in
                     runtime.agree(loop.state["flags"], mesh).tolist())
        if do:
            rho_bar = loop.state["new_rho"]
            loop.set(dict(rho_bar=rho_bar, fac=_host_rho(loop).refresh(
                loop.state["fac"], rho_bar)))


def _host_horizon_factor(loop, rb):
    """parallel.horizon._run_horizon's factor of rho-bar `rb` as the
    driver built it on the host, from the loop's state."""
    kw = loop.step.keywords
    spec, settings, mesh = kw["spec"], kw["settings"], kw["mesh"]
    state = loop.state
    hp = HorizonParts(**state["hp"])
    loc = Local(mesh=mesh, block_ids=state["block_ids"], n_blocks=spec.parts)
    dtype, dev = hp.q.dtype, hp.q.device
    S = hp.q.shape[0]
    ni, b, npb = spec.ni, spec.b, spec.npb
    is_first, is_last = loc.is_first, loc.is_last
    rv = _horizon_rho_vec(rb, state["eq"], state["soc_rows"], settings,
                          spec.cone)
    Mpp = (hp.A_loc.mT @ (rv[..., None] * hp.A_loc)
           + settings.sigma * torch.eye(npb, dtype=dtype, device=dev)
           + torch.diag_embed(hp.P_diag))
    corner = _neighbor_next(
        (hp.A_halo.mT @ (rv[..., None] * hp.A_halo)).reshape(S, b * b),
        loc).reshape(S, b, b)
    Mpp[:, ni:, ni:] += torch.where(is_last[:, :, None], 0.0, corner)
    E = (hp.A_loc.mT @ (rv[..., None] * hp.A_halo))[:, :b, :]
    E = torch.where(is_first[:, :, None], 0.0, E)
    fac = _spike_factor_sharded(Mpp, E, spec, loc)
    return {**fac, **_spike_reduce_factor(fac, loc)}


def _host_horizon_loop(loop, settings: Settings, restart_checks: int):
    """parallel.horizon._run_horizon's loop: no restart, the refactor on
    the host."""
    mesh = loop.step.keywords["mesh"]
    k = settings.check_every
    it = 0
    alive = True
    while alive and it < settings.max_iter:
        loop(admm.check_variant(it // k, settings, 0))
        it += k
        alive, do = (bool(f) for f in
                     runtime.agree(loop.state["flags"], mesh).tolist())
        if do:
            rho_bar = loop.state["new_rho"]
            loop.set(dict(rho_bar=rho_bar,
                          fac=_host_horizon_factor(loop, rho_bar)))


def _host_rowshard_loop(loop, settings: Settings, restart_checks: int):
    """parallel.rowshard.solve_rowsharded's loop: 'done' in flags[0], no
    refactor (rho adapts inside the check)."""
    mesh = loop.step.keywords["mesh"]
    k = settings.check_every
    it = 0
    done = False
    while not done and it < settings.max_iter:
        loop(("check",) + admm.check_variant(it // k, settings,
                                             restart_checks))
        it += k
        done = bool(runtime.agree(loop.state["flags"], mesh))


HOST_LOOPS = {
    "run_admm": _host_phase_loop, "run_admm_lanes": _host_phase_loop,
    "run_admm_batch_shared": _host_batch_loop,
    "run_consensus": _host_consensus_loop,
    "run_consensus_mc": _host_consensus_mc_loop,
    "run_horizon": _host_horizon_loop,
    "solve_rowsharded": _host_rowshard_loop}
