"""Independent checks of a solution.

`qp_known_solution` constructs a box QP with a known optimal
primal-dual pair (pick x*, an active set and dual signs, then derive q
so that the KKT conditions hold exactly). `kkt_residuals` computes the
raw unscaled KKT residuals of any point, independently of the solver's
own scaled residuals.
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
