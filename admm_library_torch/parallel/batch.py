"""Shared-matrix lane batch: B problems that share (P, A) and differ in
their bounds (and optionally q) — the Monte-Carlo dispersion shape,
where dispersed initial states enter only the constraint bounds.

M = P + σI + AᵀρA is factored once for the whole batch; every x-update
is one (B, n) product against the shared factor. The lanes run in
lockstep with per-lane convergence masking: finished lanes freeze and
keep honest per-lane iteration counts. On f32 'inv' batches each
`check_every` block of iterations is one call of the fused CUDA kernel
(ops/fused.py).

The solve runs as a loop over residual checks
(`graph.CheckLoop.run_checks`): the restart boundary and the
adaptive-rho cadence follow from the lockstep count. Each part is a
segment of the loop (core/graph.py): the prologue (cast, Ruiz scaling,
warm start, factor, starting carry), the phase (the checks, each with
its iterations, the fused kernel's launch inside the check, and each
refactor after the check that asks for it) and the epilogue (the best
iterate, the unscale, the objective). The hybrid driver's work between
phases (the rounds' set-up and safeguard, the f64 true residuals) is a
loop of its own in the same way, and its branches (a later round, the
f64 fallback) are `graph.repeat` and `graph.cond`. The whole solve is
one `graph.program`, as the JAX package runs it as one compiled
program: on the card one graph launch, each phase a WHILE node, the
rounds a WHILE node and the fallback an IF node, no host read. Outside
a capture (the CPU, a mesh axis of size > 1) it runs as the plain host
loop, which reads one small tensor a check (loop liveness and the
refactor flag), one before each later round and one before the f64
fallback.

Data parallelism: `shard_batch` gives each rank of a `make_data_mesh`
its slice of the lanes, and `solve_batch_shared(..., mesh=)` runs the
same driver on it. P, A and the factor are whole on every rank; only the
batch-global quantities cross the 'data' axis: the loop liveness and the
refactor flag (one agreed read per check, the plain loop's), the
shared rho's geometric
mean (a sum of logs and a count), the history's max residuals, and the
Ruiz cost scale of a per-lane q. On a 1-rank mesh every collective is
the identity, so the result is bitwise the solve without a mesh.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from ..api import resolve_backend
from ..core import admm, graph
# The named segments of the batch loop besides its checks: a phase's.
from ..core.admm import EPILOGUE, PROLOGUE, REFACTOR
from ..core.scaling import Scaling, ruiz_equilibrate, scale_qp
from ..ops import fused as fused_ops
from ..ops import kkt
from ..ops.prox import project_soc_block
from ..precision import clean64
from ..problem import QPData, objective
from ..settings import Settings
from ..solution import Solution, Status
from ..utils import trace
from . import runtime
from .runtime import DATA_AXIS, Mesh

_UNSOLVED = int(Status.UNSOLVED)
_SOLVED = int(Status.SOLVED)
_PINF = int(Status.PRIMAL_INFEASIBLE)
_DINF = int(Status.DUAL_INFEASIBLE)
_STALLED = int(Status.STALLED)
_F64_MAX_ITER = 8000


class BatchCarry(NamedTuple):
    x: torch.Tensor            # (B, n) scaled iterates
    z: torch.Tensor            # (B, m)
    y: torch.Tensor            # (B, m)
    rho_bar: torch.Tensor      # scalar — shared so the factor stays shared
    iters_lane: torch.Tensor   # (B,) int32 honest per-lane counts
    status: torch.Tensor       # (B,) int32
    r_prim: torch.Tensor       # (B,)
    r_dual: torch.Tensor       # (B,)
    hist: torch.Tensor         # (slots, 3) residual ring buffer


def _data_sum(v, mesh: Mesh | None):
    return v if mesh is None else runtime.psum(v, mesh, DATA_AXIS)


def _data_max(v, mesh: Mesh | None):
    return v if mesh is None else runtime.pmax(v, mesh, DATA_AXIS)


def _geomean_masked(v, mask, mesh: Mesh | None = None):
    """Geometric mean of v over the lanes where mask, on every rank of
    the mesh's data axis (a float sum across ranks: its rounding may
    differ from one rank's); 1.0 if there are none."""
    logv = torch.where(mask, torch.log(torch.clamp(v, min=1e-30)), 0.0)
    tot = _data_sum(logv.sum(), mesh)
    cnt = _data_sum(mask.sum(), mesh)
    return torch.exp(tot / torch.clamp(cnt, min=1))


def _agree_flags(flags, mesh: Mesh):
    """A segment's flags as int32, the same on every rank."""
    return runtime.agree(flags.to(torch.int32), mesh)


def _agreed(flags, mesh: Mesh | None):
    """The host's read of a segment's flags, the same on every rank."""
    if mesh is not None:
        flags = _agree_flags(flags, mesh)
    return [bool(f) for f in flags.tolist()]


def _pick(mask, a, b):
    """Per-lane select between two (B, ·) tensors."""
    return torch.where(mask[:, None], a, b)


def batch_check(state, variant, *, cone, settings: Settings, backend: str,
                restart_checks: int, fused: bool, mesh: Mesh | None):
    """One residual check of `run_admm_batch_shared`: check_every
    iterations (or, with `fused`, the fused kernel's output in
    state['xn'], 'zn', 'yn'), lane freezing, residuals, restart, status,
    stall, the shared rho test and the history row. Returns the state
    entries it changes; 'flags' holds (any lane UNSOLVED, refactor)."""
    restart, rho_test = variant
    qp, scaling = admm.problem_of(state, cone)
    k = settings.check_every
    x, z, y, status = state["x"], state["z"], state["y"], state["status"]
    active = status == _UNSOLVED
    if fused:
        xn, zn, yn = state["xn"], state["zn"], state["yn"]
    else:
        rho_vec = admm.rho_vec_of(state["rho_bar"], state["eq_mask"],
                                  settings, cone)
        xn, zn, yn = admm.iterate_block(
            qp, state["fac"], x, z, y, rho_vec, settings, backend, k,
            z_off=state.get("z_off"))
    # Freeze converged/infeasible lanes.
    xn, zn, yn = (_pick(active, a, b) for a, b in ((xn, x), (zn, z), (yn, y)))
    iters_lane = state["iters_lane"] + active.to(torch.int32) * k

    res = admm.residuals(qp, scaling, xn, zn, yn)

    # Per-lane restarted averaging (Settings.restart_every): adopt a
    # lane's running average iff its scaled residuals beat the lane's
    # current iterate. Frozen lanes never restart. The window always
    # holds restart_checks checks: the loop starts at check 0.
    x_sum, z_sum, y_sum = (state["x_sum"] + xn, state["z_sum"] + zn,
                           state["y_sum"] + yn)
    if restart:
        denom = float(restart_checks)
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

    rp_now, rd_now = res[0], res[1]
    eps_p, eps_d = admm.eps_thresholds(res, settings)
    solved = (rp_now <= eps_p) & (rd_now <= eps_d)
    pinf, dinf = admm.infeasibility(
        qp, scaling, xn - state["x_chk"], yn - state["y_chk"], settings)
    numerr = ~(torch.isfinite(rp_now) & torch.isfinite(rd_now))
    new_status = admm.status_of(numerr, solved, pinf, dinf, status)
    # Per-lane stall exit (Settings.stall_checks).
    ratio_now = admm.scaled_resid_ratio(res, settings)
    improved = active & (ratio_now < state["best_ratio"])
    best_ratio = torch.where(improved, ratio_now, state["best_ratio"])
    since = state["since_best"]
    since_best = torch.where(active, torch.where(improved, 0, since + 1),
                             since)
    x_best, z_best, y_best = (
        _pick(improved, a, state[b])
        for a, b in ((xn, "x_best"), (zn, "z_best"), (yn, "y_best")))
    rp_best = torch.where(improved, res[0], state["rp_best"])
    rd_best = torch.where(improved, res[1], state["rd_best"])
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
    r_prim = torch.where(active, rp_now, state["r_prim"])
    r_dual = torch.where(active, rd_now, state["r_dual"])

    # Shared adaptive rho from the active lanes' geomean ratio.
    still = status == _UNSOLVED
    alive_t = still.any()
    do_t = torch.zeros((), dtype=torch.bool, device=x.device)
    new_rho = state["new_rho"]
    if rho_test:
        tiny = torch.finfo(qp.dtype).tiny
        _, _, nAx, nz, nPx, nAty, nq = res
        sp = res[0] / torch.clamp(torch.maximum(nAx, nz), min=tiny)
        sd = res[1] / torch.clamp(
            torch.maximum(torch.maximum(nPx, nAty), nq), min=tiny)
        ratio = torch.sqrt(
            _geomean_masked(sp, still, mesh)
            / torch.clamp(_geomean_masked(sd, still, mesh), min=tiny))
        new_rho = torch.clamp(state["rho_bar"] * ratio, settings.rho_min,
                              settings.rho_max)
        tol = settings.adaptive_rho_tol
        do_t = ((ratio > tol) | (ratio < 1.0 / tol)) & alive_t

    it = state["it"] + k
    out = dict(x=xn, z=zn, y=yn, x_chk=xn, y_chk=yn, x_sum=x_sum,
               z_sum=z_sum, y_sum=y_sum, iters_lane=iters_lane,
               status=status, r_prim=r_prim, r_dual=r_dual,
               best_ratio=best_ratio, since_best=since_best, x_best=x_best,
               z_best=z_best, y_best=y_best, rp_best=rp_best,
               rd_best=rd_best, new_rho=new_rho, it=it,
               flags=torch.stack([alive_t, do_t]))
    hist = state["hist"]
    if hist.shape[-2] > 0:
        row = torch.stack([it.to(hist.dtype),
                           _data_max(r_prim.amax(), mesh),
                           _data_max(r_dual.amax(), mesh)])
        out["hist"] = admm.hist_write(hist, state["it"] // k, row)
    return out


def batch_prologue(state, *, cone, settings: Settings, backend: str, dtype,
                   scale: str, mesh: Mesh | None):
    """The loop's start from its raw entries ('raw' problem, warm start
    'x0', 'z0', 'y0', and where given the scaling 'sc', 'rho0' and the
    unscaled shifted-prox offset 'z_off0'), cast to `dtype`: the scaled
    problem (`scale` 'ruiz': Ruiz equilibration; 'given': the scaling in
    'sc'; 'scaled': the data is already scaled by 'sc'), the scaled warm
    start and offset, the equality rows, rho, the KKT factor and the
    starting carry."""
    qp = QPData(**state["raw"], cone=cone).astype(dtype)
    x0, z0, y0 = (state[k].to(dtype) for k in ("x0", "z0", "y0"))
    z_off = state.get("z_off0")
    if scale == "scaled":
        qps, scaling = qp, Scaling(**state["sc"])
        xs, zs, ys = x0, z0, y0
    else:
        if scale == "given":
            # Re-centred rounds keep phase 1's P/A, so the Ruiz loop
            # would recompute identical factors.
            scaling = Scaling(**state["sc"]).astype(dtype)
            qps = scale_qp(qp, scaling)
        else:
            qps, scaling = _ruiz(qp, settings, mesh)
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
    dev = x0.device
    eq_mask = admm.is_equality_row_shared(qps)
    rho_bar = (torch.full((), settings.rho, dtype=dtype, device=dev)
               if "rho0" not in state else
               torch.clamp(state["rho0"].to(dtype), settings.rho_min,
                           settings.rho_max))
    B = x0.shape[0]
    big = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    slots = max(settings.history, 0)
    out = admm.problem_state(
        qps, scaling, admm.factor(qps.P, qps.A, rho_bar, eq_mask, settings,
                              backend, cone), eq_mask, z_off)
    out.update(admm.carry_state(
        xs, zs, ys, rho_bar,
        torch.full((B,), _UNSOLVED, dtype=torch.int32, device=dev), big,
        torch.zeros(B, dtype=torch.int32, device=dev),
        torch.full((slots, 3), -1.0, dtype=dtype, device=dev)))
    out.update(iters_lane=torch.zeros(B, dtype=torch.int32, device=dev),
               x_best=xs, z_best=zs, y_best=ys, rp_best=big, rd_best=big)
    return out


def batch_refactor(state, *, cone, settings: Settings, backend: str):
    """The factor of the rho the last check proposed ('new_rho')."""
    rho_bar = state["new_rho"]
    if backend == "cg":
        # Matrix-free: rho enters the operator, no refactorisation.
        fac = dict(state["fac"], rho=admm.rho_vec_of(
            rho_bar, state["eq_mask"], settings, cone))
    else:
        d = state["qp"]
        fac = admm.factor(d["P"], d["A"], rho_bar, state["eq_mask"], settings,
                      backend, cone)
    return dict(rho_bar=rho_bar, fac=fac)


def batch_epilogue(state, *, cone, dtype, scale: str):
    """'out': each lane's iterate (the BEST one for lanes that ran out of
    iterations), status and residuals; unless the loop was given scaled
    data (`scale` 'scaled'), the iterates unscaled and the objective on
    the raw data."""
    unsolved = state["status"] == _UNSOLVED
    x, z, y = (_pick(unsolved, state[f"{v}_best"], state[v])
               for v in ("x", "z", "y"))
    out = dict(status=torch.where(unsolved, int(Status.MAX_ITER),
                                  state["status"]),
               r_prim=torch.where(unsolved, state["rp_best"],
                                  state["r_prim"]),
               r_dual=torch.where(unsolved, state["rd_best"],
                                  state["r_dual"]))
    if scale != "scaled":
        scaling = Scaling(**state["scaling"])
        x = scaling.unscale_x(x)
        z = scaling.unscale_z(z)
        y = scaling.unscale_y(y)
        out["obj"] = objective(
            QPData(**state["raw"], cone=cone).astype(dtype), x, z)
    out.update(x=x, z=z, y=y)
    return dict(out=out)


def batch_step(state, variant, *, cone, settings: Settings, backend: str,
               restart_checks: int, fused: bool, mesh: Mesh | None, dtype,
               scale: str):
    """A segment of the batch loop: PROLOGUE, REFACTOR, EPILOGUE, or the
    check `variant` = (restart, rho_test) (`batch_check`)."""
    if variant == PROLOGUE:
        return batch_prologue(state, cone=cone, settings=settings,
                              backend=backend, dtype=dtype, scale=scale,
                              mesh=mesh)
    if variant == REFACTOR:
        return batch_refactor(state, cone=cone, settings=settings,
                              backend=backend)
    if variant == EPILOGUE:
        return batch_epilogue(state, cone=cone, dtype=dtype, scale=scale)
    return batch_check(state, variant, cone=cone, settings=settings,
                       backend=backend, restart_checks=restart_checks,
                       fused=fused, mesh=mesh)


def _fused_pre(settings: Settings, cone):
    """The fused kernel's k-block from a check's state: (xn, zn, yn),
    the kernel's launch alone inside the span 'kernel1'."""
    def pre(state):
        d = state["qp"]
        rho_vec = admm.rho_vec_of(state["rho_bar"], state["eq_mask"],
                                  settings, cone)
        with trace.span("kernel1"):
            xn, zn, yn = fused_ops.fused_iterate_shared(
                d["A"], state["fac"]["Minv"], state["fac"]["M"], d["q"],
                rho_vec, d["lam"], d["l"], d["u"], state["x"], state["z"],
                state["y"], cone=cone, sigma=settings.sigma,
                alpha=settings.alpha, k=settings.check_every,
                refine_steps=settings.refine_steps)
        return dict(xn=xn, zn=zn, yn=yn)
    return pre


def _run_batch(qp: QPData, x0, z0, y0, settings: Settings, backend: str, *,
               dtype, scale: str, scaling=None, rho0=None,
               z_off=None, mesh: Mesh | None = None) -> graph.CheckLoop:
    """The batch loop from raw data: PROLOGUE, the checks with a
    REFACTOR wherever a check asks for one (one phase segment on the
    card), EPILOGUE. Returns the loop;
    its state's 'out', 'rho_bar', 'iters_lane' and 'hist' are the
    result."""
    cone = qp.cone
    # The only place where the plain iteration body is chosen over the
    # fused kernel: f32, explicit inverse, shared q/lam, no shifted prox,
    # uniform SOC blocks.
    fused = (
        settings.fused != "off"
        and backend == "inv"
        and qp.A.dim() == 2
        and qp.q.dim() == 1
        and qp.lam.dim() == 1
        and dtype == torch.float32
        and z_off is None
        and (cone.m_soc == 0 or cone.soc_uniform))
    state = dict(raw=admm.qp_leaves(qp), x0=x0, z0=z0, y0=y0)
    if scaling is not None:
        state["sc"] = dict(d=scaling.d, e=scaling.e, c=scaling.c)
    if rho0 is not None:
        state["rho0"] = rho0
    if z_off is not None:
        state["z_off0"] = z_off
    restart_checks = admm.restart_cadence_checks(settings)
    step = functools.partial(batch_step, cone=cone, settings=settings,
                             backend=backend, restart_checks=restart_checks,
                             fused=fused, mesh=mesh, dtype=dtype,
                             scale=scale)
    loop = graph.CheckLoop(
        "run_admm_batch_shared", step, state, settings, backend, mesh=mesh,
        pre=_fused_pre(settings, cone) if fused else None,
        cone=cone, restart_checks=restart_checks, fused=fused,
        dtype=dtype, scale=scale,
        **{f: getattr(settings, f) for f in admm.PROLOGUE_FIELDS})
    kkt.prepare(backend, x0.shape[0], qp.n, dtype, x0.device)
    loop(PROLOGUE)
    # The plain loop's read is agreed over the mesh: liveness of any lane
    # anywhere, and the rho decision.
    loop.run_checks(settings, restart_checks, agree=None if mesh is None
                    else functools.partial(_agree_flags, mesh=mesh))
    loop(EPILOGUE)
    return loop


def run_admm_batch_shared(qp: QPData, scaling, settings: Settings,
                          x0, z0, y0, backend: str, rho0=None,
                          z_off=None, mesh: Mesh | None = None
                          ) -> BatchCarry:
    """Lockstep batched ADMM with one shared KKT factor.

    `qp` carries unbatched P and A with (B, m) l, u (q may be (B, n)),
    already scaled by `scaling`; iterates are (B, ·). The shared scalar
    rho_bar adapts on the geometric-mean residual ratio of the
    still-active lanes, so one refactorisation serves all lanes. With a
    `mesh` the lanes are this rank's share of the batch: liveness, the
    rho statistics and the history's maxima are taken over the data
    axis. Each segment (the prologue, each check with the fused kernel's
    launch where it runs, each refactor, the epilogue) is `batch_step`,
    on the card a CUDA graph replay where `graph.capturable` allows.
    """
    loop = _run_batch(qp, x0, z0, y0, settings, backend, dtype=qp.dtype,
                      scale="scaled", scaling=scaling, rho0=rho0,
                      z_off=z_off, mesh=mesh)
    out, rho_bar, iters_lane, hist = loop.result("out", "rho_bar",
                                                 "iters_lane", "hist")
    return BatchCarry(x=out["x"], z=out["z"], y=out["y"], rho_bar=rho_bar,
                      iters_lane=iters_lane, status=out["status"],
                      r_prim=out["r_prim"], r_dual=out["r_dual"], hist=hist)


def _ruiz(qp, settings, mesh):
    """Ruiz scaling of this rank's lanes equal to the one of the whole
    batch: a per-lane q enters the cost scale through a max over every
    lane, so that max is taken over the data axis too."""
    reduce_max = None
    if mesh is not None and qp.q.dim() > 1:
        def reduce_max(t):
            return _data_max(t, mesh)
    return ruiz_equilibrate(qp, settings.scaling_iters, reduce_max)


def _phase(qp, x0, z0, y0, settings, backend, scaling=None, rho0=None,
           z_off=None, mesh=None, dtype=None):
    """One phase on `qp` and the unscaled warm start, both cast to
    `dtype` (default qp's): Ruiz-scaled, or scaled by a precomputed
    `scaling`; the solution unscaled. Scaling, factor, loop and unscale
    are the segments of one `_run_batch` loop."""
    dtype = qp.dtype if dtype is None else dtype
    loop = _run_batch(qp, x0, z0, y0, settings, backend, dtype=dtype,
                      scale="ruiz" if scaling is None else "given",
                      scaling=scaling, rho0=rho0, z_off=z_off, mesh=mesh)
    out, rho_bar, iters_lane, hist = loop.result("out", "rho_bar",
                                                 "iters_lane", "hist")
    return Solution(
        x=out["x"], z=out["z"], y=out["y"], status=out["status"],
        iters=iters_lane, r_prim=out["r_prim"], r_dual=out["r_dual"],
        obj=out["obj"], rho=rho_bar, history=hist)


def _s32_of_shared(settings: Settings) -> Settings:
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


def _mask_dual(qp64: QPData, y, z, act_tol: float):
    """Dual base for re-centring — the part of the accumulated dual the
    correction's linear term absorbs (g_c includes Aᵀy_base, and the
    round solves for the O(residual) remainder):
      box:  y within act_tol of a bound, else exactly 0;
      L1:   0 (∂(λ|z|) is bounded, so the round's dual replaces);
      SOC:  the projection of y onto the normal cone at the current
            primal — 0 in the interior, the component along the normal
            ray on the boundary, the polar part at the tip.
    """
    cone = qp64.cone
    mb, ml = cone.m_box, cone.m_l1
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


def _true_residuals(qp64: QPData, settings: Settings, x, y, z):
    """(r_p, r_d, eps_p, eps_d) per lane on the original f64 data, with
    the solver loop's eps_d reference (incl. the L1 term)."""
    linf = admm.linf
    A64, P64, q64 = qp64.A, qp64.P, qp64.q
    Ax = x @ A64.mT
    Px = x @ P64.mT
    Aty = y @ A64
    eps_p = settings.eps_abs + settings.eps_rel * torch.maximum(
        linf(Ax), linf(z))
    eps_d = settings.eps_abs + settings.eps_rel * torch.maximum(
        torch.maximum(linf(Px), linf(Aty)),
        torch.maximum(linf(q64), admm.l1_grad_scale_raw(qp64)))
    return linf(Ax - z), linf(Px + q64 + Aty), eps_p, eps_d


def _true_ratio(qp64, settings, x, y, z):
    r_p, r_d, eps_p, eps_d = _true_residuals(qp64, settings, x, y, z)
    return torch.maximum(r_p / eps_p, r_d / eps_d)


# The segments of the re-centred driver.
START, CARRY, SETUP, SAFEGUARD, FINAL, JOIN = (
    ("start",), ("carry",), ("setup",), ("safeguard",), ("final",),
    ("join",))


def recentered_step(state, variant, *, cone, settings: Settings,
                    mesh: Mesh | None):
    """A segment of `_solve_shared_recentered` on its state: the raw
    problem 'raw', phase 1's scaling 'sc' and solution 'p1', the rounds'
    carry 'carry' (accumulated f64 x, y, z, iterations, rho, frozen
    lanes), each round's inputs 'rnd' and solution 'solc', the f64
    fallback's solution 'f64'; 'flags' holds one flag for the host's
    next branch, 'out' the solve's result.

    START: phase 1's Ruiz scaling of the f32 data. CARRY: the rounds'
    carry from phase 1. SETUP: a round's data shifted around the carry.
    SAFEGUARD: accept a lane's round only
    where it improves the true residual ratio; flag: a lane is neither
    SOLVED in the round nor frozen. FINAL: the true residuals and
    status in f64, the result without fallback; flag: a lane is neither
    solved nor infeasible in phase 1. JOIN: the result with the f64
    fallback's solution."""
    f32, f64 = torch.float32, torch.float64
    qp = QPData(**state["raw"], cone=cone)
    if variant == START:
        _, scaling1 = _ruiz(qp.astype(f32), settings, mesh)
        return dict(sc=dict(d=scaling1.d, e=scaling1.e, c=scaling1.c))
    if variant == CARRY:
        p1 = state["p1"]
        return dict(carry=dict(
            x=clean64(p1["x"]), y=clean64(p1["y"]), z=clean64(p1["z"]),
            iters=p1["iters"], rho=p1["rho"],
            frozen=torch.zeros(p1["x"].shape[0], dtype=torch.bool,
                               device=p1["x"].device)))
    qp64 = qp.astype(f64)
    d = qp.dtype
    carry = state["carry"]
    if variant == SETUP:
        return _round_setup(qp, qp64, carry, settings)
    x_t, y_t, z_t = carry["x"], carry["y"], carry["z"]
    if variant == SAFEGUARD:
        solc = state["solc"]
        mixed = (cone.m_l1 + cone.m_soc) > 0
        x_n = x_t + clean64(solc["x"])
        y_n = (state["y_base"] + clean64(solc["y"])) if mixed else \
            clean64(solc["y"])
        z_n = state["Ax"] + clean64(solc["z"])
        # Round safeguard: accept a lane's round only when it improves
        # the true scaled residual ratio on the original f64 data;
        # rejected lanes keep their iterate and freeze.
        ok = ~carry["frozen"] & (_true_ratio(qp64, settings, x_n, y_n, z_n)
                                 < _true_ratio(qp64, settings, x_t, y_t,
                                               z_t))
        rstat = torch.where(ok, solc["status"], _STALLED)
        frozen = carry["frozen"] | ~ok
        return dict(
            carry=dict(x=_pick(ok, x_n, x_t), y=_pick(ok, y_n, y_t),
                       z=_pick(ok, z_n, z_t),
                       iters=carry["iters"] + solc["iters"],
                       rho=solc["rho"].to(carry["rho"].dtype),
                       frozen=frozen),
            flags=(~((rstat == _SOLVED) | frozen)).any()[None])
    p1 = state["p1"]
    p1_inf = (p1["status"] == _PINF) | (p1["status"] == _DINF)
    if variant == FINAL:
        # True residuals/status in f64 on the original data.
        r_p, r_d, eps_p, eps_d = _true_residuals(qp64, settings, x_t, y_t,
                                                 z_t)
        solved = (r_p <= eps_p) & (r_d <= eps_d)
        status = torch.where(p1_inf, p1["status"],
                             torch.where(solved, _SOLVED,
                                         int(Status.MAX_ITER)).to(
                                             torch.int32))
        return dict(
            flags=(~(solved | p1_inf)).any()[None],
            out=dict(x=x_t.to(d), z=z_t.to(d), y=y_t.to(d), status=status,
                     iters=carry["iters"], r_prim=r_p.to(d),
                     r_dual=r_d.to(d),
                     obj=objective(qp64, x_t, z_t).to(d),
                     rho=carry["rho"].to(d), history=p1["history"].to(d)))
    s64 = state["f64"]
    return dict(out=dict(
        x=s64["x"].to(d), z=s64["z"].to(d), y=s64["y"].to(d),
        status=torch.where(p1_inf, p1["status"], s64["status"]),
        iters=carry["iters"] + s64["iters"],
        r_prim=s64["r_prim"].to(d), r_dual=s64["r_dual"].to(d),
        obj=s64["obj"].to(d), rho=s64["rho"].to(d),
        history=s64["history"].to(d)))


def _round_setup(qp: QPData, qp64: QPData, carry, settings: Settings):
    """A re-centring round's problem around the carry: g = Px + q (f64)
    becomes the correction's q, box bounds shift by -Ax; L1/SOC rows keep
    their bounds and evaluate the shifted prox with an f64 offset = Ax.
    'rnd' holds its f32 data, warm start, rho and offset; 'Ax' and
    'y_base' what the safeguard adds back."""
    f32 = torch.float32
    cone = qp.cone
    mb = cone.m_box
    mixed = (cone.m_l1 + cone.m_soc) > 0
    x_t, y_t, z_t64 = carry["x"], carry["y"], carry["z"]
    A64, P64, q64 = qp64.A, qp64.P, qp64.q
    y_base = (_mask_dual(qp64, y_t, z_t64,
                         10.0 * max(settings.hybrid_eps, settings.eps_abs))
              if mixed else None)
    Ax = x_t @ A64.mT
    Px = x_t @ P64.mT
    out = dict(Ax=Ax)
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
        out["y_base"] = y_base
    else:
        # Box-only: the correction is the original problem in shifted
        # coordinates, so its dual is a complete dual and replaces.
        g = Px + q64
        l_c = qp64.l - Ax
        u_c = qp64.u - Ax
        z_off = None
        y_warm = y_t.to(f32)
    B = x_t.shape[0]
    rnd = dict(P=qp.P.to(f32), q=g.to(f32), A=qp.A.to(f32), l=l_c.to(f32),
               u=u_c.to(f32), lam=qp.lam.to(f32),
               x0=torch.zeros((B, qp.n), dtype=f32, device=x_t.device),
               z0=(z_t64 - Ax).to(f32), y0=y_warm,
               rho0=carry["rho"].to(f32))
    if z_off is not None:
        rnd["z_off"] = z_off
    out["rnd"] = rnd
    return out


def _round_settings(settings: Settings) -> Settings:
    """The re-centred rounds' settings: phase 1's, with absolute eps at
    the target tolerance and the SOC rows' rho boost back."""
    return _s32_of_shared(settings).replace(
        eps_abs=settings.eps_abs, eps_rel=settings.eps_rel,
        rho_soc_scale=settings.rho_soc_scale)


def _f64_settings(settings: Settings) -> Settings:
    """The f64 fallback's settings: a warm-started, capped last-digit
    refiner that exits on a plateau whatever the caller's stall_checks."""
    return settings.replace(precision="single", warm_start=True,
                            recenter_rounds=0,
                            stall_checks=max(settings.stall_checks, 16),
                            max_iter=min(settings.max_iter, _F64_MAX_ITER))


def _program_key(settings: Settings, cone) -> dict:
    """The static part of a solve's program key (`graph.program`): every
    field of the caller's settings and of each settings the solve
    derives (phase 1's, the rounds', the fallback's, the two-phase
    f64 phase's), and the cone."""
    derived = (settings, _s32_of_shared(settings), _round_settings(settings),
               _f64_settings(settings),
               settings.replace(precision="single", warm_start=True))
    return dict(cone=cone, derived=tuple(dataclasses.astuple(s)
                                         for s in derived))


def _solve_shared_recentered(qp: QPData, x0, z0, y0, settings: Settings,
                             backend: str, mesh=None) -> Solution:
    """Hybrid precision via f32 re-centring (all cone types).

    Round 0 solves in f32 to the f32 residual plateau. Each refinement
    round re-solves the same QP with data shifted around the accumulated
    (x, y): g = Px + q (f64) becomes the correction's q, box bounds
    shift by -Ax; L1/SOC rows keep their bounds and evaluate the shifted
    prox with an f64 offset = Ax. The correction lives at the residual
    scale, so f32 iterations reach the 1e-6 target. A capped,
    warm-started f64 phase runs only for lanes the rounds left unsolved.

    The work between the phases runs as the segments of one loop of its
    own (`recentered_step`). Its branches are the reference's: the
    rounds after the first run while a lane is neither solved in its
    round nor frozen (`graph.repeat`), the f64 phase where a lane is
    unsolved and feasible (`graph.cond`); plain, each reads one flag,
    agreed over the mesh. Phase 1, each round and the fallback run inside
    the spans 'phase1', 'round' and 'fallback'.
    """
    f32, f64 = torch.float32, torch.float64
    cone = qp.cone
    s1 = _s32_of_shared(settings)
    s_c = _round_settings(settings)
    step = functools.partial(recentered_step, cone=cone, settings=settings,
                             mesh=mesh)
    drv = graph.CheckLoop(
        "solve_shared_recentered", step, dict(raw=admm.qp_leaves(qp)),
        settings, backend, mesh=mesh, cone=cone,
        scaling_iters=settings.scaling_iters, hybrid_eps=settings.hybrid_eps)
    # One Ruiz pass serves phase 1 and every correction round.
    drv(START)
    scaling1 = Scaling(**drv.state["sc"])
    with trace.span("phase1"):
        sol = _phase(qp, x0, z0, y0, s1, backend, scaling=scaling1,
                     mesh=mesh, dtype=f32)
    drv.set(dict(p1=dict(x=sol.x, y=sol.y, z=sol.z, status=sol.status,
                         iters=sol.iters, rho=sol.rho,
                         history=sol.history)))
    drv(CARRY)

    def round_():
        drv(SETUP)
        rnd = drv.state["rnd"]
        solc = _phase(QPData(**{f: rnd[f] for f in admm.QP_FIELDS}, cone=cone),
                      rnd["x0"], rnd["z0"], rnd["y0"], s_c, backend,
                      scaling=scaling1, rho0=rnd["rho0"],
                      z_off=rnd.get("z_off"), mesh=mesh)
        drv.set(dict(solc=dict(x=solc.x, y=solc.y, z=solc.z,
                               status=solc.status, iters=solc.iters,
                               rho=solc.rho)))
        drv(SAFEGUARD)

    def fallback():
        # f64 fallback for targets below the f32 dual floor: a
        # warm-started, capped last-digit refiner (native f64 on the
        # device).
        c = drv.state["carry"]
        sol64 = _phase(qp, c["x"], c["z"], c["y"], _f64_settings(settings),
                       backend, mesh=mesh, dtype=f64)
        drv.set(dict(f64=sol64.leaves()))
        drv(JOIN)

    def agreed(flags):
        return _agreed(flags, mesh)[0]

    # Later rounds are skipped once every lane met the round criterion
    # or froze: a round costs a factorisation and check_every iterations
    # even when it converges at once.
    graph.repeat(max(settings.recenter_rounds, 0), round_,
                 lambda: drv.state["flags"], agreed, span="round")
    drv(FINAL)
    graph.cond(drv.state["flags"], fallback, agreed, span="fallback")
    out, = drv.result("out")
    return Solution(**out)


def _shared_program(inputs, *, cone, settings: Settings, backend: str,
                    mesh) -> dict:
    """The driver of `_solve_shared_core`'s program: the solve by
    precision strategy from its inputs ('raw' problem, warm start 'x0',
    'z0', 'y0'); returns the Solution's leaves. A one-phase solve runs
    inside the span 'single' or 'double', the two-phase one inside
    'phase1' and 'phase2'."""
    qp = QPData(**inputs["raw"], cone=cone)
    x0, z0, y0 = inputs["x0"], inputs["z0"], inputs["y0"]
    precision = settings.precision
    f32, f64 = torch.float32, torch.float64
    if precision == "single":
        with trace.span("single"):
            sol = _phase(qp, x0, z0, y0, settings, backend, mesh=mesh)
    elif precision == "double":
        with trace.span("double"):
            sol = _phase(qp, x0, z0, y0, settings, backend, mesh=mesh,
                         dtype=f64)
    elif settings.recenter_rounds > 0:
        sol = _solve_shared_recentered(qp, x0, z0, y0, settings, backend,
                                       mesh)
    else:
        # recenter_rounds=0: the classic f32 -> f64 two-phase.
        with trace.span("phase1"):
            sol32 = _phase(qp, x0, z0, y0, _s32_of_shared(settings),
                           backend, mesh=mesh, dtype=f32)
        with trace.span("phase2"):
            sol64 = _phase(qp, clean64(sol32.x), clean64(sol32.z),
                           clean64(sol32.y),
                           settings.replace(precision="single",
                                            warm_start=True),
                           backend, mesh=mesh, dtype=f64)
        p1_inf = (sol32.status == _PINF) | (sol32.status == _DINF)
        d = qp.dtype
        sol = Solution(
            x=sol64.x.to(d), z=sol64.z.to(d), y=sol64.y.to(d),
            status=torch.where(p1_inf, sol32.status, sol64.status),
            iters=sol32.iters + sol64.iters,
            r_prim=sol64.r_prim.to(d), r_dual=sol64.r_dual.to(d),
            obj=sol64.obj.to(d), rho=sol64.rho.to(d),
            history=sol64.history)
    return sol.leaves()


def _solve_shared_core(qp, x0, z0, y0, settings: Settings,
                       backend: str, mesh=None) -> Solution:
    """The shared-batch solve as one `graph.program` (`_shared_program`),
    the counterpart of the JAX package's `_solve_shared_jit`: on the card
    one graph launch with no host read, elsewhere the plain host
    driver."""
    cone = qp.cone
    return Solution(**graph.program(
        "solve_batch_shared",
        functools.partial(_shared_program, cone=cone, settings=settings,
                          backend=backend, mesh=mesh),
        dict(raw=admm.qp_leaves(qp), x0=x0, z0=z0, y0=y0), backend,
        mesh=mesh, **_program_key(settings, cone)))


def solve_batch_shared(qp: QPData, settings: Settings = Settings(),
                       x0=None, z0=None, y0=None,
                       mesh: Mesh | None = None) -> Solution:
    """Solve B problems sharing (P, A) and differing in (l, u) and/or q.

    `qp` holds unbatched P (n, n) and A (m, n) with (B, m) l, u (q may
    be (n,) or (B, n)). One factorisation serves the whole batch; the
    solve runs on qp's device.

    mesh: a data mesh (`make_data_mesh`) when `qp` and the warm start
    hold this rank's lanes (`shard_batch`); the solution is then this
    rank's lanes, and every rank of the mesh must call with the same
    settings. Tensors carry no placement, so the mesh is passed here
    where the reference reads it from the batch's sharding. The call is
    the host span 'solve_batch_shared' (utils/trace).
    """
    if qp.l.dim() < 2:
        raise ValueError("solve_batch_shared expects batched l/u (B, m)")
    with trace.host("solve_batch_shared"):
        with trace.host("inputs"):
            dtype, dev = qp.dtype, qp.device
            B = qp.l.shape[0]
            if x0 is None:
                x0 = torch.zeros((B, qp.n), dtype=dtype, device=dev)
            if z0 is None:
                z0 = torch.zeros((B, qp.m), dtype=dtype, device=dev)
            if y0 is None:
                y0 = torch.zeros_like(z0)
            backend = resolve_backend(settings, dev, qp.n)
        return _solve_shared_core(qp, x0, z0, y0, settings, backend, mesh)


def make_data_mesh(n_devices: int | None = None, device=None,
                   axis: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the data-parallel axis: every rank of the process
    group (one rank when none is initialised) along 'data'.
    `n_devices`, where given, must equal the world size; the device
    defaults to this rank's card."""
    if axis != DATA_AXIS:
        raise ValueError(f"the data mesh's axis is {DATA_AXIS!r}, not "
                         f"{axis!r}")
    return runtime.make_mesh(data=n_devices, horizon=1, device=device)


def shard_batch(qp: QPData, mesh: Mesh, x0=None, z0=None, y0=None):
    """This rank's share of a shared-matrix batch, on the mesh's device.

    Batched leaves (l, u, a per-lane q, the warm start) are sliced to
    the rank's contiguous block of lanes along 'data'; unbatched P, A,
    lam and a shared q stay whole. Returns (qp, x0, z0, y0) for
    `solve_batch_shared(..., mesh=mesh)`; absent warm starts stay None.
    """
    nd, d = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
    B = qp.l.shape[0]
    if B % nd:
        raise ValueError(f"batch {B} not divisible by the data axis "
                         f"({nd} ranks)")
    lanes = slice(d * (B // nd), (d + 1) * (B // nd))

    def put(t, batched):
        t = torch.as_tensor(t)
        return (t[lanes] if batched else t).to(mesh.device)

    qp2 = QPData(P=put(qp.P, qp.P.dim() > 2), q=put(qp.q, qp.q.dim() > 1),
                 A=put(qp.A, qp.A.dim() > 2), l=put(qp.l, True),
                 u=put(qp.u, True), lam=put(qp.lam, qp.lam.dim() > 1),
                 cone=qp.cone)
    return (qp2,) + tuple(None if t is None else put(t, True)
                          for t in (x0, z0, y0))
