"""Clohessy-Wiltshire impulsive rendezvous with an L1 minimum-fuel cost:
the problem builder and the bounds of a dispersed initial state.

A frozen copy of `admm_library_torch/models/clohessy_wiltshire.py`
(`cw_stm`, `build_cw_rendezvous`, `cw_bounds_for_s0`), kept here so that
an edit of the port's models cannot move the benchmark's inputs. It
returns plain tensors, not the port's types.

Condensed transcription: x = [dv_0, ..., dv_{N-1}]; 6 terminal
equalities sum_k Phi^{N-k} B dv_k = s_target - Phi^N s0 (each row
divided by its norm), then 3N L1 rows on the impulses with weight lam
and bounds ±dv_max. P = reg * I, q = 0.
"""
from __future__ import annotations

import numpy as np
import torch


def cw_stm(n: float, t: float) -> np.ndarray:
    """Analytic 6x6 HCW state-transition matrix Phi(t) (f64 numpy); x
    radial, y along-track, z cross-track."""
    s, c = np.sin(n * t), np.cos(n * t)
    P = np.zeros((6, 6))
    P[0, 0] = 4.0 - 3.0 * c
    P[0, 3] = s / n
    P[0, 4] = 2.0 * (1.0 - c) / n
    P[1, 0] = 6.0 * (s - n * t)
    P[1, 1] = 1.0
    P[1, 3] = 2.0 * (c - 1.0) / n
    P[1, 4] = (4.0 * s - 3.0 * n * t) / n
    P[2, 2] = c
    P[2, 5] = s / n
    P[3, 0] = 3.0 * n * s
    P[3, 3] = c
    P[3, 4] = 2.0 * s
    P[4, 0] = 6.0 * n * (c - 1.0)
    P[4, 3] = -2.0 * s
    P[4, 4] = 4.0 * c - 3.0
    P[5, 2] = -n * s
    P[5, 5] = c
    return P


def _row_scale(problem: dict) -> np.ndarray:
    """The terminal map T (6, 3N) and its row norms."""
    N = problem["N"]
    B = np.zeros((6, 3))
    B[3:, :] = np.eye(3)
    Phi = cw_stm(problem["n_mean"], problem["dt"])
    T = np.zeros((6, 3 * N))
    PhiB = Phi @ B
    for k in range(N - 1, -1, -1):
        T[:, 3 * k:3 * k + 3] = PhiB
        PhiB = Phi @ PhiB
    rown = np.linalg.norm(T, axis=1, keepdims=True)
    return T, np.where(rown > 0, rown, 1.0)


def build(problem: dict, dtype=torch.float32, device="cpu") -> dict:
    """The QP of `problem` (N, dt, n_mean, dv_max, lam, reg, s0_nominal,
    s_target) at its nominal initial state, assembled in f64 numpy and
    converted once: {P, q, A, l, u, lam, m_box, m_l1}."""
    N, dv_max = problem["N"], problem["dv_max"]
    s0 = np.asarray(problem["s0_nominal"], np.float64)
    s_t = np.asarray(problem["s_target"], np.float64)
    nvar = 3 * N
    T, rown = _row_scale(problem)
    Phi = cw_stm(problem["n_mean"], problem["dt"])
    rhs = (s_t - np.linalg.matrix_power(Phi, N) @ s0) / rown[:, 0]
    m_eq, m_l1 = 6, nvar
    A = np.zeros((m_eq + m_l1, nvar))
    A[:m_eq] = T / rown
    A[m_eq:] = np.eye(nvar)
    l = np.concatenate([rhs, np.full(nvar, -dv_max)])
    u = np.concatenate([rhs, np.full(nvar, dv_max)])
    P, q, A, l, u = (torch.as_tensor(a, dtype=dtype).to(device)
                     for a in (problem["reg"] * np.eye(nvar),
                               np.zeros(nvar), A, l, u))
    return dict(P=0.5 * (P + P.transpose(-1, -2)), q=q, A=A, l=l, u=u,
                lam=torch.full((m_l1,), problem["lam"],
                               dtype=dtype).to(device),
                m_box=m_eq, m_l1=m_l1)


def bounds_for_s0(qp: dict, problem: dict, s0):
    """(l, u) for dispersed initial state(s) s0 (..., 6): only the 6
    terminal-equality bounds depend on s0."""
    l0, u0 = qp["l"], qp["u"]
    dtype, dev = l0.dtype, l0.device
    PhiN = torch.as_tensor(
        np.linalg.matrix_power(cw_stm(problem["n_mean"], problem["dt"]),
                               problem["N"]), dtype=dtype, device=dev)
    s0 = torch.as_tensor(s0, dtype=dtype, device=dev)
    s_t = torch.tensor(tuple(map(float, problem["s_target"])), dtype=dtype,
                       device=dev)
    rown = torch.tensor(tuple(map(float, _row_scale(problem)[1][:, 0])),
                        dtype=dtype, device=dev)
    rhs = (s_t - s0 @ PhiN.mT) / rown
    shape = rhs.shape[:-1] + l0.shape[-1:]
    l = l0.expand(shape).clone()
    u = u0.expand(shape).clone()
    l[..., :6] = rhs
    u[..., :6] = rhs
    return l, u
