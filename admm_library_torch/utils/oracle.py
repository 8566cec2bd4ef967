"""Independent checks of a solution.

`qp_known_solution` constructs a box QP with a known optimal
primal-dual pair (pick x*, an active set and dual signs, then derive q
so that the KKT conditions hold exactly). `kkt_residuals` computes the
raw unscaled KKT residuals of any point, independently of the solver's
own scaled residuals. `solve_box_qp_activeset` solves a small box QP by
a dense active-set method, a ground truth that shares no code with the
solver.
"""
from __future__ import annotations

import numpy as np
import torch

from ..problem import ConeSpec, QPData, make_qp


def qp_known_solution(seed: int, n: int = 50, m: int = 100,
                      n_active: int = 20,
                      dtype: torch.dtype = torch.float64, device="cpu"):
    """Box QP with a constructed optimal pair: returns (QPData, x*, y*).

    A ~ N(0,1)/sqrt(n), P = RRᵀ + I; rows [0, n_active) are active (even
    rows at the upper bound with y* > 0, odd rows at the lower bound
    with y* < 0), the rest strictly slack; q = -P x* - Aᵀ y*. The numpy
    draws match the JAX package's oracle for the same seed.
    """
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    P = R @ R.T + np.eye(n)
    x = rng.standard_normal(n)
    z = A @ x
    y = np.zeros(m)
    l = z - (1.0 + rng.random(m))
    u = z + (1.0 + rng.random(m))
    for i in range(n_active):
        mag = 0.1 + rng.random()
        if i % 2 == 0:
            u[i] = z[i]
            y[i] = mag
        else:
            l[i] = z[i]
            y[i] = -mag
    q = -P @ x - A.T @ y
    qp = make_qp(P, q, A, l, u, cone=ConeSpec(m_box=m), dtype=dtype,
                 device=device)
    return (qp, torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(y, dtype=dtype, device=device))


def kkt_residuals(qp: QPData, x, z, y):
    """Raw unscaled KKT residual inf-norms (primal, dual,
    complementarity), per lane:

    primal: ||Ax - z||_inf plus the box violation of z
    dual:   ||Px + q + Aᵀy||_inf
    comp:   max_i |y_i⁺ (u_i - z_i)| + |y_i⁻ (z_i - l_i)|
    """
    Ax = x @ qp.A.mT
    r_p = (Ax - z).abs().amax(-1)
    viol = torch.clamp(qp.l - z, min=0.0) + torch.clamp(z - qp.u, min=0.0)
    viol = torch.where(torch.isfinite(viol), viol, 0.0)
    r_p = torch.maximum(r_p, viol.amax(-1))
    r_d = (x @ qp.P.mT + qp.q + y @ qp.A).abs().amax(-1)
    yp = torch.clamp(y, min=0.0)
    ym = torch.clamp(y, max=0.0)
    du = torch.where(torch.isfinite(qp.u), qp.u - z, 0.0)
    dl = torch.where(torch.isfinite(qp.l), z - qp.l, 0.0)
    comp = ((yp * du).abs() + (ym * dl).abs()).amax(-1)
    return r_p, r_d, comp


def solve_box_qp_activeset(qp: QPData, max_iter: int = 200):
    """Small dense primal active-set solver (host numpy, f64): an
    independent ground truth for small box QPs.

    Starts from the unconstrained minimiser and solves the equality-
    constrained KKT system on the current active set until the point is
    primal and dual feasible. Returns (x, y) as f64 tensors on qp's
    device. For tests only (small n, m).
    """
    def host(t):
        return t.detach().cpu().double().numpy()

    P, q, A, l, u = (host(t) for t in (qp.P, qp.q, qp.A, qp.l, qp.u))
    m, n = A.shape
    x = np.linalg.solve(P, -q)
    y = np.zeros(m)
    active_u = np.zeros(m, bool)
    active_l = np.zeros(m, bool)
    for _ in range(max_iter):
        z = A @ x
        active_u |= z > u + 1e-10
        active_l |= z < l - 1e-10
        active_l &= ~active_u
        act = active_u | active_l
        k = int(act.sum())
        if k == 0:
            x = np.linalg.solve(P, -q)
            y = np.zeros(m)
        else:
            Aa = A[act]
            b = np.where(active_u, u, l)[act]
            K = np.block([[P, Aa.T], [Aa, np.zeros((k, k))]])
            sol = np.linalg.lstsq(K, np.concatenate([-q, b]), rcond=None)[0]
            x = sol[:n]
            y = np.zeros(m)
            y[act] = sol[n:]
            # Drop constraints with wrong-sign multipliers.
            drop_u = active_u & (y < -1e-10)
            drop_l = active_l & (y > 1e-10)
            if drop_u.any() or drop_l.any():
                active_u &= ~drop_u
                active_l &= ~drop_l
                continue
        z = A @ x
        if (z <= u + 1e-8).all() and (z >= l - 1e-8).all():
            break
    return (torch.as_tensor(x, device=qp.device),
            torch.as_tensor(y, device=qp.device))
