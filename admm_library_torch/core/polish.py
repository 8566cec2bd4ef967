"""Solution polishing (OSQP §8 style): detect the active set at the
current point, then solve the equality-constrained reduced QP directly
in f64. First-order ADMM crawls through the last digits of LP-like
min-fuel problems; polish skips that tail.

The reduced QP is solved as the weighted penalty system

    (P + delta I + Aᵀ W A) x = -q_eff + Aᵀ W b,
    W = diag(1/delta on active rows, 0 otherwise)

with three augmented-Lagrangian passes, so the constraint defect falls
to machine level while delta stays moderate. L1 rows contribute
exactly: rows clamped at a bound act like active box rows, rows at the
kink (z = 0) are pinned to zero, and rows in the smooth regime add
lam * sign(z) to the effective gradient with dual y = lam * sign(z).

SOC blocks (uniform block dims) polish by tangent linearisation: a block
on the cone boundary contributes the single equality row
a_t - û'A_u = 0 (û = u/‖u‖ at the current point) with one multiplier and
the Lagrangian curvature term; a block at the tip pins all its rows to
0; interior blocks stay inactive with dual 0. A block whose dual carries
a positive normal-ray component counts as active even when the primal
gap reads interior. After the first two AL passes the rays and the
curvature multiplier are refreshed from the polished Ax and the system
is refactored (two Gauss-Newton steps on the active manifold).
Non-uniform SOC layouts never activate SOC rows: they keep the input
dual there and take z as the cone projection of Ax.

The polished point is accepted only if it meets the stopping criterion
at (eps_abs, eps_rel) and, when the input already met it, lowers
max(r_prim, r_dual): polish never makes a solution worse. A factor of a
matrix that is not positive definite is NaN, so the candidate fails the
finiteness test and is rejected.
"""
from __future__ import annotations

import torch

from ..ops.kkt import cholesky_or_nan
from ..ops.prox import project_soc_rows
from ..problem import QPData, objective
from ..solution import Solution, Status
from .admm import unscaled_criterion

_PASSTHROUGH = (int(Status.PRIMAL_INFEASIBLE), int(Status.DUAL_INFEASIBLE),
                int(Status.NUMERICAL_ERROR))


def polish(qp: QPData, sol: Solution, eps_abs: float, eps_rel: float,
           act_tol: float = 1e-4, delta: float = 1e-7,
           force_accept: bool = False) -> Solution:
    """Polish `sol` on the (f64) problem `qp`, on qp's device.

    act_tol: relative distance for active-set detection;
    delta: AL penalty weight;
    force_accept: return the polished candidate whenever it is finite
    (tests: inspect the candidate the acceptance test saw).
    """
    cone = qp.cone
    mb, ml = cone.m_box, cone.m_l1
    dtype, dev = qp.dtype, qp.device
    tiny = torch.finfo(dtype).tiny
    x0, z0, y0 = sol.x, sol.z, sol.y
    fin_l, fin_u = torch.isfinite(qp.l), torch.isfinite(qp.u)

    span = torch.where(fin_u & fin_l, qp.u - qp.l, 1.0)
    tol = act_tol * torch.clamp(span, min=1.0)

    low_act = fin_l & (z0 - qp.l <= tol)
    up_act = fin_u & (qp.u - z0 <= tol)
    b = torch.where(up_act, torch.where(fin_u, qp.u, 0.0),
                    torch.where(fin_l, qp.l, 0.0))
    act = low_act | up_act

    q_eff = qp.q
    lam_sign = torch.zeros_like(z0)
    if ml:
        sl = slice(mb, mb + ml)
        z_l1 = z0[..., sl]
        at_kink = z_l1.abs() <= tol[..., sl]
        # Kink rows become equalities to 0; smooth rows contribute the
        # fixed subgradient lam*sign(z).
        act = act.clone()
        act[..., sl] = act[..., sl] | at_kink
        b = b.clone()
        b[..., sl] = torch.where(at_kink, 0.0, b[..., sl])
        lam_sign[..., sl] = torch.where(at_kink, 0.0,
                                        qp.lam * torch.sign(z_l1))
        q_eff = q_eff + lam_sign @ qp.A

    # --- SOC activation by tangent linearisation (uniform dims only) ---
    soc_lin = bool(cone.m_soc) and cone.soc_uniform
    soc0 = mb + ml
    if soc_lin:
        d = cone.soc_dims[0]
        shp = z0[..., soc0:].shape[:-1] + (cone.n_soc, d)
        zb = z0[..., soc0:].reshape(shp)
        t0_, u0_ = zb[..., 0], zb[..., 1:]
        nu0 = torch.linalg.vector_norm(u0_, dim=-1)
        tol_b = act_tol * (1.0 + t0_.abs() + nu0)
        # Complementarity-aware activation: with a cost linear in the
        # cone's t (min-fuel SOCPs), dropping a block whose dual carries
        # a normal-ray component leaves the reduced problem unbounded
        # below in t.
        yb0 = y0[..., soc0:].reshape(shp)
        yt0, yu0 = yb0[..., 0], yb0[..., 1:]
        u_hat = u0_ / torch.clamp(nu0, min=tiny)[..., None]
        ray0 = torch.clamp((yu0 * u_hat).sum(-1) - yt0, min=0.0)
        dual_act = ray0 > act_tol * (
            1.0 + yt0.abs() + torch.linalg.vector_norm(yu0, dim=-1))
        interior = (nu0 <= t0_ - tol_b) & ~dual_act
        tip = (t0_ <= tol_b) & (nu0 <= tol_b)
        bnd = ~(interior | tip)
        # Tip blocks: pin every row of the block to 0 (b there is 0).
        tip_rows = tip.repeat_interleave(d, dim=-1)
        act = torch.cat([act[..., :soc0], tip_rows], dim=-1)
        w_soc = torch.where(bnd, 1.0 / delta, 0.0)          # (..., n_soc)
        A_soc = qp.A[..., soc0:, :].reshape(
            qp.A.shape[:-2] + (cone.n_soc, d, qp.n))

        def tan_rows(uh):
            """Tangent row per block: a_t − ûᵀA_u."""
            return A_soc[..., 0, :] - torch.einsum(
                "...ke,...ken->...kn", uh, A_soc[..., 1:, :])

        A_tan = tan_rows(u_hat)
        # Curvature multiplier: the input dual's normal-ray component
        # (refreshed from the AL multiplier after each of passes 1-2).
        c_curv = torch.where(bnd, ray0 / torch.clamp(nu0, min=tiny), 0.0)

    w = torch.where(act, 1.0 / delta, 0.0)
    eye = torch.eye(qp.n, dtype=dtype, device=dev)

    def build_M(A_tan_=None, c_curv_=None, uh_=None):
        M_ = (qp.P + delta * eye
              + torch.einsum("...ji,...j,...jk->...ik", qp.A, w, qp.A))
        if soc_lin:
            M_ = M_ + torch.einsum("...ki,...k,...kj->...ij",
                                   A_tan_, w_soc, A_tan_)
            # Lagrangian curvature of the active cone,
            # (s/‖u‖) A_uᵀ (I − ûûᵀ) A_u: the tangent equality alone
            # drops the norm bound, and with a cost linear in t the
            # reduced problem would be unbounded along the tangent plane.
            r_u = torch.einsum("...ke,...ken->...kn", uh_,
                               A_soc[..., 1:, :])
            M_ = M_ + torch.einsum("...kdi,...k,...kdj->...ij",
                                   A_soc[..., 1:, :], c_curv_,
                                   A_soc[..., 1:, :])
            M_ = M_ - torch.einsum("...ki,...k,...kj->...ij",
                                   r_u, c_curv_, r_u)
        return M_, cholesky_or_nan(M_)

    M, L = build_M(A_tan, c_curv, u_hat) if soc_lin else build_M()

    def solve_M(L_, M_, r):
        def apply(v):
            t = torch.linalg.solve_triangular(L_, v[..., None], upper=False)
            return torch.linalg.solve_triangular(L_.mT, t,
                                                 upper=True)[..., 0]

        x_ = apply(r)
        for _ in range(2):                  # iterative refinement, f64
            x_ = x_ + apply(r - x_ @ M_.mT)
        return x_

    # Augmented-Lagrangian passes on the active rows, each on the cached
    # factor: a moderate delta stays stable to factor even where P is
    # singular, and the passes still reach machine-level defects.
    y_mult = torch.zeros_like(z0)
    s_soc = (torch.zeros(z0.shape[:-1] + (cone.n_soc,), dtype=dtype,
                         device=dev) if soc_lin else None)
    for it in range(3):
        rhs = -q_eff + (w * b - torch.where(act, y_mult, 0.0)) @ qp.A
        if soc_lin:
            rhs = rhs - torch.einsum("...k,...kn->...n", s_soc, A_tan)
        x = solve_M(L, M, rhs)
        Ax = x @ qp.A.mT
        y_mult = y_mult + w * (Ax - b)
        if soc_lin:
            s_soc = s_soc + w_soc * torch.einsum("...kn,...n->...k",
                                                 A_tan, x)
            if it < 2:
                # Gauss-Newton ray refresh: re-linearise the active cones
                # at the polished point, refresh the curvature multiplier
                # from the AL estimate and refactor. Two refreshes: from
                # a coarse input dual one lands the dual only near 1e-4.
                uA = Ax[..., soc0:].reshape(shp)[..., 1:]
                nuA = torch.linalg.vector_norm(uA, dim=-1)
                u_hat = torch.where(
                    (bnd & (nuA > tiny))[..., None],
                    uA / torch.clamp(nuA, min=tiny)[..., None], u_hat)
                A_tan = tan_rows(u_hat)
                # The cone multiplier is −s_soc (≥ 0 when active): valid
                # cone duals have y_t < 0 in this dual convention.
                s_ref = torch.clamp(-s_soc, min=0.0)
                c_curv = torch.where(
                    bnd, s_ref / torch.clamp(nuA, min=tiny), 0.0)
                M, L = build_M(A_tan, c_curv, u_hat)

    y = torch.where(act, y_mult, 0.0) + lam_sign
    if soc_lin:
        # Boundary blocks: y = s (1, −û), the tangent row's multiplier
        # mapped back onto the block's rows; tip blocks: the AL
        # multipliers of the pinned rows; interior: 0.
        y_t = torch.where(bnd, s_soc, 0.0)
        y_u = torch.where(bnd[..., None], -s_soc[..., None] * u_hat, 0.0)
        y_bnd = torch.cat([y_t[..., None], y_u], dim=-1).reshape(
            z0[..., soc0:].shape)
        y_tip = torch.where(tip_rows, y_mult[..., soc0:], 0.0)
        y = torch.cat([y[..., :soc0], y_bnd + y_tip], dim=-1)
    elif cone.m_soc:
        # Non-uniform fallback: keep the input dual on SOC rows.
        y = torch.cat([y[..., :soc0], y0[..., soc0:]], dim=-1)
    z = torch.where(act, b, Ax)
    if cone.m_soc:
        # SOC z: the cone projection of Ax per block (the identity on
        # interior blocks).
        z = torch.cat([z[..., :soc0],
                       project_soc_rows(Ax[..., soc0:], cone.soc_dims)],
                      dim=-1)

    _, _, r_p0, r_d0, _, _, solved0 = unscaled_criterion(
        qp, x0, z0, y0, eps_abs, eps_rel)
    _, _, r_p1, r_d1, _, _, solved1 = unscaled_criterion(
        qp, x, z, y, eps_abs, eps_rel)
    finite = torch.isfinite(x).all(-1)
    # Accept only a polished point that meets the criterion outright (and
    # beats an input that already met it): an improved but unconverged
    # candidate carries 1/delta-scaled duals from a misidentified active
    # set, which poison a warm start.
    accepted = finite & solved1 & (
        ~solved0 | (torch.maximum(r_p1, r_d1) < torch.maximum(r_p0, r_d0)))
    if force_accept:
        accepted = finite | accepted

    def pick(a, b_):
        return torch.where(accepted[..., None], a, b_)

    x_f, z_f, y_f = pick(x, x0), pick(z, z0), pick(y, y0)
    solved_now = torch.where(accepted, solved1, solved0)
    # The status reflects THIS eps, not the caller's earlier (possibly
    # relaxed) criterion: only infeasibility and numerical-error
    # verdicts pass through; an unconverged point reports MAX_ITER.
    # Compared code by code: a tensor of the codes would be a copy from
    # the host, which a captured segment cannot hold.
    pinf, dinf, numerr = _PASSTHROUGH
    passthrough = ((sol.status == pinf) | (sol.status == dinf)
                   | (sol.status == numerr))
    status = torch.where(
        solved_now, int(Status.SOLVED),
        torch.where(passthrough, sol.status, int(Status.MAX_ITER))
    ).to(torch.int32)
    return Solution(
        x=x_f, z=z_f, y=y_f, status=status, iters=sol.iters,
        r_prim=torch.where(accepted, r_p1, r_p0),
        r_dual=torch.where(accepted, r_d1, r_d0),
        obj=objective(qp, x_f, z_f), rho=sol.rho, history=sol.history)


# The one segment of a polish loop (api.polish).
POLISH = ("polish",)


def polish_step(state, variant, *, cone, eps_abs: float, eps_rel: float,
                act_tol: float):
    """`polish` of the solution 'sol' on the f64 problem 'qp64' (both
    dicts of their leaves), as a loop's segment: 'out' holds the
    polished Solution's leaves. Makes no host read."""
    pol = polish(QPData(**state["qp64"], cone=cone), Solution(**state["sol"]),
                 eps_abs, eps_rel, act_tol=act_tol)
    return dict(out=pol.leaves())

