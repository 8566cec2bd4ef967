"""Double-integrator min-energy rendezvous MPC builder.

Discrete double integrator in `dim` spatial dimensions with step dt:

    r_{k+1} = r_k + v_k dt + a_k dt²/2
    v_{k+1} = v_k + a_k dt

Variables are ordered by time step, x = [u_0, s_1, u_1, s_2, ...,
u_{N-1}, s_N] with s_k = (r_k, v_k), so M = P + σI + AᵀρA is
block-tridiagonal with block size 3*dim. Constraint rows (all box):
dynamics equalities (s_0 enters the right-hand side), the terminal
equality s_N = s_target, and control bounds |u_k| <= u_max. Objective:
½ Σ ||u_k||² plus a tiny state regularisation.

The data is built in f64 numpy and converted once, as the JAX builder
does, so both packages hold identical problems.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..problem import ConeSpec, QPData, make_qp
from . import model_device


@dataclasses.dataclass(frozen=True)
class MPCSpec:
    """Static description of the MPC instance (shapes + matrices)."""

    N: int
    dim: int
    dt: float

    @property
    def ns(self) -> int:
        return 2 * self.dim

    @property
    def nu(self) -> int:
        return self.dim

    @property
    def block(self) -> int:
        return self.nu + self.ns

    @property
    def n(self) -> int:
        return self.N * self.block


def dynamics_matrices(spec: MPCSpec):
    """F (ns, ns), G (ns, nu) of the exact discrete double integrator
    (f64 numpy)."""
    d, dt = spec.dim, spec.dt
    F = np.eye(2 * d)
    F[:d, d:] = dt * np.eye(d)
    G = np.zeros((2 * d, d))
    G[:d] = 0.5 * dt * dt * np.eye(d)
    G[d:] = dt * np.eye(d)
    return F, G


def build_mpc_qp(s0, s_target, N: int = 50, dim: int = 3, dt: float = 1.0,
                 u_max: float = 1.0, state_reg: float = 1e-8,
                 dtype: torch.dtype = torch.float32, device=None):
    """Build the min-energy rendezvous QP. Returns (QPData, MPCSpec).

    s0 and s_target are (2*dim,) states. s0 enters only the bounds of
    the first dynamics rows, so a dispersion of s0 keeps P and A shared
    across a batch.
    """
    device = model_device(device)
    spec = MPCSpec(N=N, dim=dim, dt=dt)
    ns, nu, b = spec.ns, spec.nu, spec.block
    n = spec.n
    F, G = dynamics_matrices(spec)
    s0 = np.asarray(torch.as_tensor(s0).cpu(), np.float64)
    s_target = np.asarray(torch.as_tensor(s_target).cpu(), np.float64)

    def u_idx(k):
        return k * b

    def s_idx(k):          # s_{k+1} lives in block k
        return k * b + nu

    Pd = np.full(n, state_reg)
    for k in range(N):
        Pd[u_idx(k):u_idx(k) + nu] = 1.0
    P = np.diag(Pd)
    q = np.zeros(n)

    m_dyn, m_term, m_u = N * ns, ns, N * nu
    m = m_dyn + m_term + m_u
    A = np.zeros((m, n))
    l = np.zeros(m)
    u = np.zeros(m)

    # dynamics rows: s_{k+1} - F s_k - G u_k = (F s_0 if k == 0 else 0)
    for k in range(N):
        r = k * ns
        A[r:r + ns, s_idx(k):s_idx(k) + ns] = np.eye(ns)
        A[r:r + ns, u_idx(k):u_idx(k) + nu] = -G
        if k > 0:
            A[r:r + ns, s_idx(k - 1):s_idx(k - 1) + ns] = -F
            rhs = np.zeros(ns)
        else:
            rhs = F @ s0
        l[r:r + ns] = rhs
        u[r:r + ns] = rhs

    r = m_dyn                                   # terminal equality
    A[r:r + ns, s_idx(N - 1):s_idx(N - 1) + ns] = np.eye(ns)
    l[r:r + ns] = s_target
    u[r:r + ns] = s_target

    r = m_dyn + m_term                          # control bounds
    for k in range(N):
        A[r + k * nu:r + (k + 1) * nu, u_idx(k):u_idx(k) + nu] = np.eye(nu)
    l[r:] = -u_max
    u[r:] = u_max

    qp = make_qp(*(torch.as_tensor(a, dtype=dtype) for a in (P, q, A, l, u)),
                 cone=ConeSpec(m_box=m), device=device)
    return qp, spec


def rollout(spec: MPCSpec, s0, x):
    """Simulate the dynamics under the controls in solution vector x.
    Returns states (N+1, ns) — a physics check independent of the
    constraint residuals."""
    F, G = (torch.as_tensor(a, dtype=x.dtype, device=x.device)
            for a in dynamics_matrices(spec))
    b, nu = spec.block, spec.nu
    s = torch.as_tensor(s0, dtype=x.dtype, device=x.device)
    out = [s]
    for k in range(spec.N):
        s = F @ s + G @ x[k * b:k * b + nu]
        out.append(s)
    return torch.stack(out)


def mpc_bounds_for_s0(qp: QPData, spec: MPCSpec, s0):
    """Rebuild (l, u) for initial state(s) s0 (..., ns), keeping P, A, q:
    only the first ns rows' bounds depend on s0. A batch of states gives
    (..., m) bounds."""
    F, _ = dynamics_matrices(spec)
    s0 = torch.as_tensor(s0, dtype=qp.dtype, device=qp.l.device)
    rhs = s0 @ torch.as_tensor(F, dtype=qp.dtype, device=qp.l.device).mT
    ns = spec.ns
    shape = rhs.shape[:-1] + qp.l.shape[-1:]
    l = qp.l.expand(shape).clone()
    u = qp.u.expand(shape).clone()
    l[..., :ns] = rhs
    u[..., :ns] = rhs
    return l, u
