"""Public solver API: `solve` for one problem, `solve_batch` for a batch
of independent problems, and the backend choice.

`solve` runs 'single' and 'double' precision as one phase of
`core.admm.run_admm`. The default 'hybrid' precision takes one of two
pipelines:

- box-only and SOC problems go to the shared-matrix batch pipeline at
  batch 1 (parallel.batch.solve_batch_shared: f32 phase, re-centred f32
  rounds, capped f64 fallback); an SOC problem that comes back unsolved
  continues in `_f64_continuation`, chunked warm-started f64 ADMM with
  polish between chunks;
- L1 problems, and any problem with recenter_rounds=0, take the staged
  path: f32 phase, polish, re-centred f32 rounds (each followed by a
  polish attempt), then an f64 phase and polish.

`solve_batch` runs `_solve_core` (single, double, or the two-phase
hybrid; no polish, no re-centred rounds) over a leading lane axis in one
lockstep loop (core.admm.run_phase).

Every stage runs on the problem's device; the f64 stages use the
device's native f64. The programs that the JAX package compiles run on
`core.graph`: `_solve_core` (the counterpart of `_solve_jit`) and the
shared pass (`_solve_shared_jit`) are each one `graph.program`, on the
card one graph launch with no host read; a phase alone
(`_solve_one_phase`: cast, Ruiz scaling, factor; the checks and
refactors, one graph whose WHILE node runs them; unscale), the staged
path's rounds (`rounds_step`), `polish` and the warm-start check are
`core.graph.CheckLoop`s, one CUDA graph replay a segment. The host
reads the device only where the JAX package does (`# host sync`
there): the branches of `_recentered_rounds`, `_f64_continuation`,
`_solve_staged` and `solve`, never between checks.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .core import admm, graph
from .core.admm import QP_FIELDS, qp_leaves
from .core.polish import POLISH, polish_step
from .ops.prox import project_cone
from .precision import clean64
from .problem import QPData, objective
from .settings import Settings
from .solution import Solution, Status
from .utils import trace

_INFEASIBLE = (int(Status.PRIMAL_INFEASIBLE), int(Status.DUAL_INFEASIBLE))
_SOLVED = int(Status.SOLVED)


def resolve_backend(settings: Settings, device,
                    qp_n: int | None = None) -> str:
    """Map backend='auto' to a concrete backend for `device` and a
    problem of qp_n variables.

    With declared block structure (band_block > 0): on a CUDA device
    'inv' up to n = 2048 (each KKT solve is one product, and the fused
    kernel takes M⁻¹) and 'banded' above; elsewhere 'banded'. Without
    it: 'inv' on a CUDA device, dense Cholesky elsewhere. The JAX
    package makes the same choice with the TPU in the CUDA device's
    place.
    """
    if settings.backend != "auto":
        return settings.backend
    on_cuda = torch.device(device).type == "cuda"
    if settings.band_block > 0:
        if on_cuda and (qp_n is None or qp_n <= 2048):
            return "inv"
        return "banded"
    return "inv" if on_cuda else "chol"


def _int32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def _solve_one_phase(qp: QPData, x0, z0, y0, settings: Settings,
                     backend: str, z_off=None, rho0=None, *, dtype=None,
                     p1=None) -> Solution:
    """One phase from raw data (core.admm.run_phase), the counterpart of
    the JAX package's `_phase_jit`, `_phase_off_jit` and
    `_phase_rho_jit`: cast to `dtype` (default qp's), Ruiz-scaled,
    solved, unscaled, each a segment of one loop.

    z_off: unscaled shifted-prox offset for the L1/SOC rows (it keeps
    its own dtype); rho0: warm rho-bar (a float or a tensor); p1 (a
    Solution): the first phase where this is a hybrid solve's second,
    which cleans the first phase's iterates and returns the joined
    result in qp's dtype.
    """
    loop = admm.run_phase(
        qp, x0, z0, y0, settings, backend, dtype=dtype, rho0=rho0,
        z_off=z_off,
        p1=None if p1 is None else dict(status=p1.status, iters=p1.iters))
    out, = loop.result("out")
    return Solution(**out)


def _s32_of(settings: Settings) -> Settings:
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


def _cast(sol: Solution, dtype: torch.dtype, **kw) -> Solution:
    """sol with every floating leaf in `dtype` (history included),
    fields in `kw` replaced first."""
    sol = dataclasses.replace(sol, **kw)
    return dataclasses.replace(
        sol, **{f: getattr(sol, f).to(dtype) for f in admm.FLOAT_LEAVES})


def _finish(sol: Solution, sol32: Solution, out_dtype) -> Solution:
    """Combine phase results: cast out, add the iteration counts, keep
    a phase-1 infeasibility verdict."""
    return Solution(**admm.join_phases(
        sol.leaves(), dict(status=sol32.status, iters=sol32.iters),
        out_dtype))


def _core_program(inputs, *, cone, settings: Settings,
                  backend: str) -> dict:
    """The driver of `_solve_core`'s program: the solve by precision
    strategy from its inputs ('raw' problem, warm start 'x0', 'z0',
    'y0'); returns the Solution's leaves. The phases pass their iterates
    on the device. A one-phase solve runs inside the span 'single' or
    'double', the hybrid one inside 'phase1' and 'phase2'."""
    f32, f64 = torch.float32, torch.float64
    qp = QPData(**inputs["raw"], cone=cone)
    x0, z0, y0 = inputs["x0"], inputs["z0"], inputs["y0"]
    if settings.precision == "single":
        with trace.span("single"):
            sol = _solve_one_phase(qp, x0, z0, y0, settings, backend)
    elif settings.precision == "double":
        with trace.span("double"):
            sol = _solve_one_phase(qp, x0, z0, y0, settings, backend,
                                   dtype=f64)
    else:
        with trace.span("phase1"):
            sol32 = _solve_one_phase(qp, x0, z0, y0, _s32_of(settings),
                                     backend, dtype=f32)
        with trace.span("phase2"):
            sol = _solve_one_phase(
                qp, sol32.x, sol32.z, sol32.y,
                settings.replace(precision="single", warm_start=True),
                backend, dtype=f64, p1=sol32)
    return sol.leaves()


def _solve_core(qp: QPData, x0, z0, y0, settings: Settings,
                backend: str) -> Solution:
    """One problem, or a lockstep batch of independent ones (every leaf
    with a leading lane axis), by precision strategy: 'single' in qp's
    dtype, 'double' in f64, 'hybrid' as an f32 phase to hybrid_eps and
    a warm-started f64 phase to the target, the counterpart of the JAX
    package's `_solve_jit`: one `graph.program` (`_core_program`), on
    the card one graph launch with no host read."""
    return Solution(**graph.program(
        "solve_core",
        functools.partial(_core_program, cone=qp.cone, settings=settings,
                          backend=backend),
        dict(raw=qp_leaves(qp), x0=x0, z0=z0, y0=y0), backend,
        **_program_key(settings, qp.cone)))


def _program_key(settings: Settings, cone) -> dict:
    """The static part of `_solve_core`'s program key (`graph.program`):
    every field of the caller's settings and of each settings the solve
    derives (the f32 phase's, the f64 phase's), and the cone."""
    derived = (settings, _s32_of(settings),
               settings.replace(precision="single", warm_start=True))
    return dict(cone=cone, derived=tuple(dataclasses.astuple(s)
                                         for s in derived))


# The segments of `_recentered_rounds`' loop.
SETUP, JOIN, FINAL = ("setup",), ("join",), ("final",)


def rounds_step(state, variant, *, cone, settings: Settings):
    """A segment of `_recentered_rounds` on its state: the f64 problem
    'qp64', the accumulated point 'carry' (x, y, z in f64, iterations,
    rho), the first phase's history 'hist0', a round's solution 'solc'.

    SETUP: the true residuals at the carry ('res') and the round's
    shifted f32 problem 'rnd' (its warm start and f64 offset), with
    'Ax'; flags (solved, min(eps_p, eps_d)) in f64. JOIN: the round's
    solution added to the carry, and the polish candidate 'cand'. FINAL:
    the result 'out' at the carry, SOLVED where its true residuals meet
    the criterion; flags (solved,)."""
    f32, f64 = torch.float32, torch.float64
    qp64 = QPData(**state["qp64"], cone=cone)
    c = state["carry"]
    if variant == JOIN:
        solc, Ax = state["solc"], state["Ax"]
        x = c["x"] + clean64(solc["x"])
        y = clean64(solc["y"])
        z = Ax + clean64(solc["z"])
        iters = c["iters"] + solc["iters"]
        rho = solc["rho"].to(f64)
        return dict(
            carry=dict(x=x, y=y, z=z, iters=iters, rho=rho),
            cand=dict(x=x, z=z, y=y, status=torch.zeros_like(iters),
                      iters=iters, r_prim=state["res"]["r_p"],
                      r_dual=state["res"]["r_d"],
                      obj=objective(qp64, x, z), rho=rho,
                      history=state["hist0"]))
    x_t, y_t, z_t = c["x"], c["y"], c["z"]
    Ax, Px, r_p, r_d, eps_p, eps_d, ok = admm.unscaled_criterion(
        qp64, x_t, z_t, y_t, settings.eps_abs, settings.eps_rel)
    if variant == FINAL:
        status = torch.where(ok, _SOLVED, int(Status.MAX_ITER)).to(
            torch.int32)
        return dict(flags=ok[None], out=dict(
            x=x_t, z=z_t, y=y_t, status=status, iters=c["iters"],
            r_prim=r_p, r_dual=r_d, obj=objective(qp64, x_t, z_t),
            rho=c["rho"], history=state["hist0"]))
    # g = Px + q only (no Aᵀy tilt): the correction problem is then
    # exactly the original in shifted coordinates, so its dual is a
    # complete dual of the original. Duals are warm-started and
    # replaced, never summed: summed partial duals leave junk on
    # inactive rows that tilts x off the optimum.
    mb = cone.m_box
    l_c = torch.cat([qp64.l[:mb] - Ax[:mb], qp64.l[mb:]])
    u_c = torch.cat([qp64.u[:mb] - Ax[:mb], qp64.u[mb:]])
    rnd = dict(P=qp64.P.to(f32), q=(Px + qp64.q).to(f32), A=qp64.A.to(f32),
               l=l_c.to(f32), u=u_c.to(f32), lam=qp64.lam.to(f32),
               x0=torch.zeros(qp64.n, dtype=f32, device=x_t.device),
               z0=(z_t - Ax).to(f32), y0=y_t.to(f32),
               z_off=torch.cat([torch.zeros_like(Ax[:mb]), Ax[mb:]]))
    return dict(Ax=Ax, res=dict(r_p=r_p, r_d=r_d), rnd=rnd,
                flags=torch.stack([ok.to(f64), torch.minimum(eps_p, eps_d)]))


def _recentered_rounds(qp: QPData, qp64: QPData, sol0: Solution,
                       settings: Settings, backend: str, try_polish=None):
    """Up to recenter_rounds f32 correction solves around the f64 point
    sol0; returns (Solution in f64, solved).

    Each round re-solves the same problem in shifted coordinates: box
    rows shift exactly (bounds − Ax), L1/SOC rows keep their bounds and
    lam and evaluate the shifted prox with an f64 offset = Ax. True
    residuals are evaluated in f64 on the original data; the rounds stop
    once those meet the criterion, or once `try_polish` (called after
    every round) returns SOLVED. The work between the rounds is the
    segments of a loop of its own (`rounds_step`); the host reads the
    round's criterion and eps, each polish status and the final test, as
    the JAX package does. `qp64` is `qp` in f64: the rounds' f32 data is
    cast from it.
    """
    cone = qp.cone
    # Correction problems are feasible by construction and mix shifted
    # and original rows, so infeasibility certificates mean nothing
    # there.
    s_c = _s32_of(settings).replace(
        eps_abs=settings.eps_abs, eps_rel=settings.eps_rel,
        eps_pinf=0.0, eps_dinf=0.0)
    state = dict(qp64=qp_leaves(qp64), hist0=sol0.history, carry=dict(
        x=sol0.x, y=sol0.y, z=sol0.z, rho=sol0.rho,
        iters=torch.zeros((), dtype=torch.int32, device=qp.device)))
    drv = graph.CheckLoop(
        "recentered_rounds",
        functools.partial(rounds_step, cone=cone, settings=settings), state,
        settings, backend, cone=cone)
    solved = False
    for _ in range(settings.recenter_rounds):
        drv(SETUP)
        ok, eps_round = drv.state["flags"].tolist()     # host sync
        solved = bool(ok)
        if solved:
            break
        # Each round only has to meet the ORIGINAL mixed criterion, whose
        # eps_rel term scales with the total norms: demanding the raw
        # eps_abs at the correction's scale costs ~100x the iterations.
        # Quantised to a power of two, as in the reference.
        eps_q = 2.0 ** math.floor(math.log2(max(eps_round,
                                                settings.eps_abs)))
        s_round = s_c.replace(eps_abs=eps_q, eps_rel=0.0)
        if settings.recenter_max_iter > 0:
            s_round = s_round.replace(max_iter=min(
                settings.max_iter, settings.recenter_max_iter))
        rnd = drv.state["rnd"]
        sol_c = _solve_one_phase(
            QPData(**{f: rnd[f] for f in QP_FIELDS}, cone=cone), rnd["x0"],
            rnd["z0"], rnd["y0"], s_round, backend, z_off=rnd["z_off"])
        drv.set(dict(solc=dict(x=sol_c.x, y=sol_c.y, z=sol_c.z,
                               iters=sol_c.iters, rho=sol_c.rho)))
        drv(JOIN)
        # Polish from the partly converged round: on min-fuel LPs the
        # active set locks in long before the first-order tail ends.
        if try_polish is not None:
            cand, = drv.result("cand")
            pol = try_polish(Solution(**cand))
            if int(pol.status) == _SOLVED:              # host sync
                return dataclasses.replace(pol, iters=cand["iters"]), True
    drv(FINAL)
    if not solved:
        solved = bool(drv.state["flags"].tolist()[0])   # host sync
    out, = drv.result("out")
    return Solution(**out), solved


def _f64_continuation(qp: QPData, sol: Solution, settings: Settings,
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
    transient). rho carries across chunks on the device (the phase's
    'rho0' state entry: every chunk replays one loop). With
    Settings.polish, a polish attempt (act_tol 1e-4) follows every
    chunk, and the first SOLVED candidate ends the run. Otherwise the
    run ends when a chunk ends other than MAX_ITER or the budget is
    spent, and returns the best chunk-end point by max(r_prim, r_dual).
    The host reads each chunk's count, polish status, score and status,
    as the JAX package does.

    Unlike the reference, the run does not stop after two chunks without
    a new best: chunk-end residuals chatter by an order of magnitude on
    these problems, so that test ends runs that are converging (the JAX
    package on the CPU quits config 4 at 10,525 iterations with MAX_ITER;
    its own chunks, run on, land SOLVED at 16,525).
    """
    dtype, dev = qp.dtype, qp.device
    qp64 = qp.astype(torch.float64)
    x, z, y = clean64(sol.x), clean64(sol.z), clean64(sol.y)
    rho = sol.rho.max().to(torch.float64)
    rho = torch.where((rho > 0.0) & torch.isfinite(rho), rho, settings.rho)
    iters = int(sol.iters)                                  # host sync
    used = 0
    out = sol
    s_chunk = settings.replace(
        precision="single", warm_start=True, polish=False,
        recenter_rounds=0, max_iter=chunk, stall_checks=0)
    best = float("inf")
    while used < settings.max_iter:
        ph = _solve_one_phase(qp64, x, z, y, s_chunk, backend, rho0=rho)
        done_it = int(ph.iters)                             # host sync
        used += done_it
        iters += done_it
        if settings.polish:
            pol = polish(qp64, ph, settings.eps_abs, settings.eps_rel,
                         act_tol=1e-4, backend=backend)
            if int(pol.status) == _SOLVED:                  # host sync
                return _cast(pol, dtype, iters=_int32(iters, dev),
                             rho=ph.rho, history=ph.history)
        score = float(torch.maximum(ph.r_prim, ph.r_dual))  # host sync
        if score < best or int(ph.status) == _SOLVED:
            best = score
            out = dataclasses.replace(ph, iters=_int32(iters, dev))
        else:
            out = dataclasses.replace(out, iters=_int32(iters, dev))
        if int(ph.status) != int(Status.MAX_ITER) or done_it == 0:
            break
        x, z, y = ph.x, ph.z, ph.y
        rho = ph.rho.max()
    # Every floating leaf in qp's dtype, history included (the reference
    # leaves history in f64).
    return _cast(out, dtype)


def _warm_check(qp64: QPData, x0, z0, y0, eps_abs: float, eps_rel: float):
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


# The one segment of the warm-start check's loop.
WARM_CHECK = ("warm_check",)


def warm_check_step(state, variant, *, cone, eps_abs: float,
                    eps_rel: float, dtype):
    """`_warm_check` of the warm start 'x0', 'z0', 'y0' on the problem
    'raw', both in f64, as a loop's segment (the counterpart of the JAX
    package's `_warm_check_jit`): flags (solved,) and 'out' the
    residuals and objective in `dtype`."""
    f64 = torch.float64
    r_p, r_d, ok, obj = _warm_check(
        QPData(**state["raw"], cone=cone).astype(f64),
        *(state[k].to(f64) for k in ("x0", "z0", "y0")), eps_abs, eps_rel)
    return dict(flags=ok[None], out=dict(
        r_prim=r_p.to(dtype), r_dual=r_d.to(dtype), obj=obj.to(dtype)))


def polish(qp64: QPData, sol: Solution, eps_abs: float, eps_rel: float,
           act_tol: float = 1e-4, backend: str = "chol") -> Solution:
    """core.polish.polish of `sol` on the f64 problem `qp64` as the one
    segment of a loop (kind 'polish', keyed on eps_abs, eps_rel, act_tol
    and the shapes), the counterpart of the JAX package's `_polish_jit`:
    one CUDA graph replay on the card where `graph.capturable` allows
    `backend`, the solve's KKT backend."""
    loop = graph.CheckLoop(
        "polish", functools.partial(polish_step, cone=qp64.cone,
                                    eps_abs=eps_abs, eps_rel=eps_rel,
                                    act_tol=act_tol),
        dict(qp64=qp_leaves(qp64), sol=sol.leaves()), None, backend,
        cone=qp64.cone, eps_abs=eps_abs, eps_rel=eps_rel, act_tol=act_tol)
    loop(POLISH)
    out, = loop.result("out")
    return Solution(**out)


def _solve_staged(qp: QPData, x0, z0, y0, settings: Settings,
                  backend: str) -> Solution:
    """The staged hybrid path: f32 phase → polish at 10·hybrid_eps →
    re-centred f32 rounds (polish after each) → f64 phase → polish."""
    f32, f64 = torch.float32, torch.float64
    dtype = qp.dtype
    sol32 = _solve_one_phase(qp, x0, z0, y0, _s32_of(settings), backend,
                             dtype=f32)
    qp64 = qp.astype(f64)
    sol32_64 = Solution(
        x=clean64(sol32.x), z=clean64(sol32.z), y=clean64(sol32.y),
        status=sol32.status, iters=_int32(0, qp.device),
        r_prim=sol32.r_prim.to(f64), r_dual=sol32.r_dual.to(f64),
        obj=sol32.obj.to(f64), rho=sol32.rho.to(f64),
        history=sol32.history.to(f64))

    def do_polish(sol_p, act_tol):
        return polish(qp64, sol_p, settings.eps_abs, settings.eps_rel,
                      act_tol=act_tol, backend=backend)

    if settings.polish:
        pol = do_polish(sol32_64, 10.0 * settings.hybrid_eps)
        if int(pol.status) == _SOLVED:                      # host sync
            return _finish(pol, sol32, dtype)

    if settings.recenter_rounds > 0:
        tp = ((lambda cand: do_polish(cand, 1e-4))
              if settings.polish else None)
        sol_r, solved_r = _recentered_rounds(qp, qp64, sol32_64, settings,
                                             backend, try_polish=tp)
        if solved_r:
            if settings.polish:
                pol = do_polish(sol_r, 1e-4)
                if int(pol.status) == _SOLVED:              # host sync
                    return _finish(
                        dataclasses.replace(pol, iters=sol_r.iters), sol32,
                        dtype)
            return _finish(sol_r, sol32, dtype)
        sol32_64 = sol_r            # warm-start the f64 phase from it

    s64 = settings.replace(precision="single", warm_start=True,
                           polish=False)
    sol64 = _solve_one_phase(qp64, sol32_64.x, sol32_64.z, sol32_64.y, s64,
                             backend)
    if settings.polish:
        sol64 = dataclasses.replace(do_polish(sol64, 1e-4),
                                    iters=sol64.iters)
    return _finish(sol64, sol32, dtype)


def solve(qp: QPData, settings: Settings = Settings(),
          x0=None, z0=None, y0=None) -> Solution:
    """Solve one QP/SOCP, optionally warm-started from an unscaled
    (x0, z0, y0).

    A warm start that already meets the stopping criterion is returned
    as SOLVED at 0 iterations. 'single' and 'double' precision run one
    phase of run_admm. 'hybrid' (the default) runs box-only and SOC
    problems through solve_batch_shared at batch 1 (at least 4 rounds
    for SOC), and an SOC problem left unsolved there through
    `_f64_continuation`; L1 problems and recenter_rounds=0 take the
    staged path (module docstring). The call is the host span 'solve'
    (utils/trace).
    """
    with trace.host("solve"):
        return _solve(qp, settings, x0, z0, y0)


def _solve(qp: QPData, settings: Settings, x0, z0, y0) -> Solution:
    """`solve`'s work."""
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
        chk = graph.CheckLoop(
            "warm_check", functools.partial(
                warm_check_step, cone=cone, eps_abs=settings.eps_abs,
                eps_rel=settings.eps_rel, dtype=dtype),
            dict(raw=qp_leaves(qp), x0=x0, z0=z0, y0=y0), None, backend,
            cone=cone, eps_abs=settings.eps_abs, eps_rel=settings.eps_rel,
            dtype=dtype)
        chk(WARM_CHECK)
        if chk.state["flags"].tolist()[0]:                  # host sync
            out, = chk.result("out")
            return Solution(
                x=x0, z=z0, y=y0, status=_int32(_SOLVED, dev),
                iters=_int32(0, dev), r_prim=out["r_prim"],
                r_dual=out["r_dual"], obj=out["obj"],
                rho=torch.tensor(settings.rho, dtype=dtype, device=dev),
                history=torch.zeros((0, 3), dtype=dtype, device=dev))

    if settings.precision != "hybrid":
        return _solve_core(qp, x0, z0, y0, settings, backend)
    if settings.recenter_rounds == 0 or (cone.m_l1 and not cone.m_soc):
        return _solve_staged(qp, x0, z0, y0, settings, backend)

    from .parallel.batch import solve_batch_shared
    qpb = QPData(P=qp.P, q=qp.q, A=qp.A, l=qp.l[None], u=qp.u[None],
                 lam=qp.lam, cone=cone)
    s_del = settings
    if cone.m_soc:
        # SOC corrections converge geometrically per round; the default
        # 2 rounds can stop just above an absolute target.
        s_del = settings.replace(
            recenter_rounds=max(settings.recenter_rounds, 4))
    solb = solve_batch_shared(qpb, s_del, x0=x0[None], z0=z0[None],
                              y0=y0[None])
    sol = Solution(
        x=solb.x[0], z=solb.z[0], y=solb.y[0], status=solb.status[0],
        iters=solb.iters[0], r_prim=solb.r_prim[0], r_dual=solb.r_dual[0],
        obj=solb.obj[0], rho=solb.rho, history=solb.history)
    # Box-only problems return without reading the status; only SOC
    # problems, whose f32 machinery can fail wholesale, continue in f64.
    if not cone.m_soc or int(sol.status) in (_SOLVED, *_INFEASIBLE):
        return sol                                          # host sync
    return _f64_continuation(qp, sol, settings, backend)


def solve_batch(qp_batch: QPData, settings: Settings = Settings(),
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
    return _solve_core(qp_batch, x0, z0, y0, settings, backend)
