"""The three host loops of admm_library_torch written with host-side
counters and rebinding, one iterate at a time: `run_admm`,
`run_admm_lanes` and `run_admm_batch_shared` as plain loops whose check
is inline. tests/test_torch_graph.py holds the package's loops, whose
checks are carry-to-carry steps (core/graph.py), bitwise to these on
the CPU.
"""
import torch

from admm_library_torch.core.admm import (
    AdmmCarry, _select, adapt_rho, eps_thresholds, infeasibility,
    is_equality_row, iterate_block, residuals, restart_cadence_checks,
    rho_vec_of, scaled_resid_ratio, status_of)
from admm_library_torch.core import admm
from admm_library_torch.core.scaling import Scaling
from admm_library_torch.ops import fused as fused_ops
from admm_library_torch.ops import kkt
from admm_library_torch.parallel.batch import (
    BatchCarry, _agreed, _data_max, _geomean_masked, _pick)
from admm_library_torch.parallel.runtime import Mesh
from admm_library_torch.problem import QPData
from admm_library_torch.settings import Settings
from admm_library_torch.solution import Status

_UNSOLVED = int(Status.UNSOLVED)
_STALLED = int(Status.STALLED)


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
            xn, zn, yn = admm.iterate_block(
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


