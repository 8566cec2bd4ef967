"""Double-integrator minimum-energy rendezvous MPC: the problem builder
and the bounds of a dispersed initial state.

A frozen copy of `admm_library_torch/models/double_integrator.py`
(`build_mpc_qp`, `mpc_bounds_for_s0`, `dynamics_matrices`), kept here so
that an edit of the port's models cannot move the benchmark's inputs.
It returns plain tensors, not the port's types: the same tensors go to
the port and to the reference.

Variables are ordered by time step, x = [u_0, s_1, ..., u_{N-1}, s_N]
with s_k = (r_k, v_k). Box rows: N*2*dim dynamics equalities (s0 enters
the right-hand side of the first 2*dim), 2*dim terminal equalities and
N*dim control bounds |u_k| <= u_max. Objective ½ Σ ||u_k||² plus a
small state regularisation.
"""
from __future__ import annotations

import numpy as np
import torch


def dynamics_matrices(dim: int, dt: float):
    """F (2dim, 2dim), G (2dim, dim) of the exact discrete double
    integrator (f64 numpy)."""
    F = np.eye(2 * dim)
    F[:dim, dim:] = dt * np.eye(dim)
    G = np.zeros((2 * dim, dim))
    G[:dim] = 0.5 * dt * dt * np.eye(dim)
    G[dim:] = dt * np.eye(dim)
    return F, G


def build(problem: dict, dtype=torch.float32, device="cpu") -> dict:
    """The QP of `problem` (N, dim, dt, u_max, state_reg, s0_nominal,
    s_target) at its nominal initial state, assembled in f64 numpy and
    converted once: {P, q, A, l, u, lam, m_box, m_l1}."""
    N, dim, dt = problem["N"], problem["dim"], problem["dt"]
    u_max, state_reg = problem["u_max"], problem["state_reg"]
    s0 = np.asarray(problem["s0_nominal"], np.float64)
    s_target = np.asarray(problem["s_target"], np.float64)
    ns, nu = 2 * dim, dim
    b = nu + ns
    n = N * b
    F, G = dynamics_matrices(dim, dt)

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
    r = m_dyn
    A[r:r + ns, s_idx(N - 1):s_idx(N - 1) + ns] = np.eye(ns)
    l[r:r + ns] = s_target
    u[r:r + ns] = s_target
    r = m_dyn + m_term
    for k in range(N):
        A[r + k * nu:r + (k + 1) * nu, u_idx(k):u_idx(k) + nu] = np.eye(nu)
    l[r:] = -u_max
    u[r:] = u_max

    P, q, A, l, u = (torch.as_tensor(a, dtype=dtype).to(device)
                     for a in (P, q, A, l, u))
    return dict(P=0.5 * (P + P.transpose(-1, -2)), q=q, A=A, l=l, u=u,
                lam=torch.zeros(0, dtype=dtype, device=device),
                m_box=m, m_l1=0)


def bounds_for_s0(qp: dict, problem: dict, s0):
    """(l, u) for initial state(s) s0 (..., 2dim): only the first 2dim
    rows depend on s0, so a batch of states gives (..., m) bounds that
    share (P, q, A)."""
    F, _ = dynamics_matrices(problem["dim"], problem["dt"])
    l0, u0 = qp["l"], qp["u"]
    s0 = torch.as_tensor(s0, dtype=l0.dtype, device=l0.device)
    rhs = s0 @ torch.as_tensor(F, dtype=l0.dtype, device=l0.device).mT
    ns = 2 * problem["dim"]
    shape = rhs.shape[:-1] + l0.shape[-1:]
    l = l0.expand(shape).clone()
    u = u0.expand(shape).clone()
    l[..., :ns] = rhs
    u[..., :ns] = rhs
    return l, u
