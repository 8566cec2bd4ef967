"""Public solver API: `solve` for one problem, and the backend choice.

`solve` runs 'single' and 'double' precision as one phase of
`core.admm.run_admm`; the default 'hybrid' precision of a box-only or
SOC problem goes to the shared-matrix batch pipeline at batch 1
(parallel.batch.solve_batch_shared). The staged hybrid path of L1
problems, the hybrid path without re-centred rounds, the f64
continuation of an unsolved SOC problem and `solve_batch` are not
ported yet: `solve` raises NotImplementedError where it would enter
them.
"""
from __future__ import annotations

import torch

from .core import admm
from .core.scaling import ruiz_equilibrate
from .ops.prox import project_cone
from .precision import clean64
from .problem import QPData, objective
from .settings import Settings
from .solution import Solution, Status

_POLISH_STEP = "it needs core/polish.py, ROADMAP.md queue 1 step 10"
_INFEASIBLE = (int(Status.PRIMAL_INFEASIBLE), int(Status.DUAL_INFEASIBLE))


def resolve_backend(settings: Settings, device) -> str:
    """Map backend='auto' to a concrete backend for `device`.

    On a CUDA device 'inv' (each KKT solve is one product, and the fused
    kernel takes M⁻¹); elsewhere dense Cholesky — the JAX package's
    choice off the TPU.
    """
    if settings.backend != "auto":
        return settings.backend
    return "inv" if torch.device(device).type == "cuda" else "chol"


def _solve_one_phase(qp: QPData, x0, z0, y0, settings: Settings,
                     backend: str) -> Solution:
    """Ruiz-scale, run `run_admm` in qp's dtype, unscale."""
    qps, scaling = ruiz_equilibrate(qp, settings.scaling_iters)
    if settings.warm_start:
        xs = scaling.scale_x(x0)
        zs = scaling.scale_z(z0)
        ys = scaling.scale_y(y0)
    else:
        xs, zs, ys = x0, z0, y0
    carry = admm.run_admm(qps, scaling, settings, xs, zs, ys, backend)
    x = scaling.unscale_x(carry.x)
    z = scaling.unscale_z(carry.z)
    y = scaling.unscale_y(carry.y)
    return Solution(
        x=x, z=z, y=y, status=carry.status,
        iters=torch.tensor(carry.it, dtype=torch.int32, device=qp.device),
        r_prim=carry.r_prim, r_dual=carry.r_dual, obj=objective(qp, x, z),
        rho=carry.rho_bar, history=carry.hist)


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


def _solve_core(qp: QPData, x0, z0, y0, settings: Settings,
                backend: str) -> Solution:
    """One problem by precision strategy: 'single' in qp's dtype,
    'double' in f64, 'hybrid' as an f32 phase to hybrid_eps and a
    warm-started f64 phase to the target."""
    f32, f64 = torch.float32, torch.float64
    if settings.precision == "single":
        return _solve_one_phase(qp, x0, z0, y0, settings, backend)
    if settings.precision == "double":
        return _solve_one_phase(qp.astype(f64), x0.to(f64), z0.to(f64),
                                y0.to(f64), settings, backend)
    sol32 = _solve_one_phase(qp.astype(f32), x0.to(f32), z0.to(f32),
                             y0.to(f32), _s32_of(settings), backend)
    sol64 = _solve_one_phase(
        qp.astype(f64), clean64(sol32.x), clean64(sol32.z),
        clean64(sol32.y),
        settings.replace(precision="single", warm_start=True), backend)
    # A phase-1 infeasibility verdict stands.
    p1_inf = ((sol32.status == _INFEASIBLE[0])
              | (sol32.status == _INFEASIBLE[1]))
    d = qp.dtype
    return Solution(
        x=sol64.x.to(d), z=sol64.z.to(d), y=sol64.y.to(d),
        status=torch.where(p1_inf, sol32.status, sol64.status),
        iters=sol32.iters + sol64.iters, r_prim=sol64.r_prim.to(d),
        r_dual=sol64.r_dual.to(d), obj=sol64.obj.to(d),
        rho=sol64.rho.to(d), history=sol64.history)


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
    linf = admm.linf
    Ax = x0 @ qp64.A.mT
    Px = x0 @ qp64.P.mT
    Aty = y0 @ qp64.A
    r_p = linf(Ax - z0)
    r_d = linf(Px + qp64.q + Aty)
    eps_p = eps_abs + eps_rel * torch.maximum(linf(Ax), linf(z0))
    eps_d = eps_abs + eps_rel * torch.maximum(
        torch.maximum(linf(Px), linf(Aty)),
        torch.maximum(linf(qp64.q), admm.l1_grad_scale_raw(qp64)))
    gap = linf(z0 - project_cone(z0 + y0, qp64.l, qp64.u, qp64.lam,
                                 qp64.cone))
    solved = (r_p <= eps_p) & (r_d <= eps_d) & (gap <= eps_p)
    return r_p, r_d, solved, objective(qp64, x0, z0)


def solve(qp: QPData, settings: Settings = Settings(),
          x0=None, z0=None, y0=None) -> Solution:
    """Solve one QP/SOCP, optionally warm-started from an unscaled
    (x0, z0, y0).

    A warm start that already meets the stopping criterion is returned
    as SOLVED at 0 iterations. 'single' and 'double' precision run one
    phase of run_admm. 'hybrid' (the default) runs box-only and SOC
    problems through solve_batch_shared at batch 1: f32 phase,
    re-centred f32 rounds (at least 4 for SOC) and a capped f64
    fallback.
    """
    if (qp.P.dim() != 2 or qp.A.dim() != 2 or qp.q.dim() != 1
            or qp.l.dim() != 1 or qp.u.dim() != 1):
        raise ValueError(
            "solve takes one problem (P (n, n), A (m, n), q (n,), l and u "
            "(m,)); for a batch that shares (P, A) use solve_batch_shared")
    cone = qp.cone
    hybrid = settings.precision == "hybrid"
    if hybrid and settings.recenter_rounds == 0:
        raise NotImplementedError(
            "hybrid precision with recenter_rounds=0 runs the staged path "
            f"of solve, which is not ported yet: {_POLISH_STEP}")
    if hybrid and cone.m_l1 and not cone.m_soc:
        raise NotImplementedError(
            "hybrid precision on an L1 problem runs the staged path of "
            f"solve, which is not ported yet: {_POLISH_STEP}")
    dtype, dev = qp.dtype, qp.device
    warm_given = x0 is not None and z0 is not None and y0 is not None
    if x0 is None:
        x0 = torch.zeros(qp.n, dtype=dtype, device=dev)
    if z0 is None:
        z0 = torch.zeros(qp.m, dtype=dtype, device=dev)
    if y0 is None:
        y0 = torch.zeros_like(z0)
    backend = resolve_backend(settings, dev)

    if warm_given and settings.warm_start:
        f64 = torch.float64
        r_p, r_d, ok, obj = _warm_check(
            qp.astype(f64), x0.to(f64), z0.to(f64), y0.to(f64),
            settings.eps_abs, settings.eps_rel)
        if bool(ok):
            return Solution(
                x=x0, z=z0, y=y0,
                status=torch.tensor(int(Status.SOLVED), dtype=torch.int32,
                                    device=dev),
                iters=torch.tensor(0, dtype=torch.int32, device=dev),
                r_prim=r_p.to(dtype), r_dual=r_d.to(dtype),
                obj=obj.to(dtype),
                rho=torch.tensor(settings.rho, dtype=dtype, device=dev),
                history=torch.zeros((0, 3), dtype=dtype, device=dev))

    if not hybrid:
        return _solve_core(qp, x0, z0, y0, settings, backend)

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
    if cone.m_soc and int(sol.status) not in (int(Status.SOLVED),
                                              *_INFEASIBLE):
        raise NotImplementedError(
            "the shared pass left this SOC problem "
            f"{Status(int(sol.status)).name}; the f64 continuation that "
            f"finishes it is not ported yet: {_POLISH_STEP}")
    return sol
