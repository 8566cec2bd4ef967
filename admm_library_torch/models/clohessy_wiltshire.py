"""Clohessy-Wiltshire impulsive rendezvous with an L1 min-fuel cost
(BASELINE config 3).

Hill/Clohessy-Wiltshire frame: x radial (away from Earth), y
along-track, z cross-track; the target is on a circular orbit with mean
motion n. State s = (x, y, z, vx, vy, vz). Impulses dv_k are applied at
node times k*dt:

    s_{k+1} = Phi(dt) (s_k + B dv_k),      B = [0; I3]

The condensed transcription eliminates the states through the analytic
state-transition matrix: decision vector X = [dv_0, ..., dv_{N-1}] with
the rendezvous condition

    sum_k Phi(dt)^{N-k} B dv_k = s_target - Phi(dt)^N s_0.

Row layout ([box | L1]): 6 terminal equality rows, then 3N bounded L1
rows on the impulses (weight lam, bounds ±dv_max). P is a small
regularisation reg*I; the objective is the L1 term.

The builders assemble the data in f64 numpy, as the JAX package's do,
and convert once to tensors of the given dtype and device, so both
packages hold identical problems. The functions that act on solutions
and dispersions take tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..problem import ConeSpec, QPData, make_qp
from . import model_device


def state_to_nd(s, lu: float, tu: float):
    """SI state (m, m/s) tensor -> nondimensional (LU, LU/TU)."""
    return torch.cat([s[..., :3] / lu, s[..., 3:] * (tu / lu)], dim=-1)


@dataclasses.dataclass(frozen=True)
class CWSpec:
    """Static description of the impulsive CW instance."""

    N: int                  # number of impulses
    dt: float               # node spacing [s or normalised]
    n_mean: float           # target mean motion [rad / time-unit]
    s_target: tuple = (0.0,) * 6
    row_scale: tuple = (1.0,) * 6   # terminal-row normalisation factors
    # Canonical units of the sparse transcription (1.0 = dimensional).
    lu: float = 1.0         # length unit [m]
    tu: float = 1.0         # time unit [s]

    @property
    def n(self) -> int:
        return 3 * self.N

    def state_to_nd(self, s):
        """SI state tensor (m, m/s) -> nondimensional (LU, LU/TU)."""
        return state_to_nd(s, self.lu, self.tu)


def cw_stm(n: float, t: float) -> np.ndarray:
    """Analytic 6x6 HCW state-transition matrix Phi(t) (f64 numpy).

    The standard closed form of Hill's equations (e.g. Vallado,
    "Fundamentals of Astrodynamics"); x radial, y along-track, z
    cross-track.
    """
    s, c = np.sin(n * t), np.cos(n * t)
    P = np.zeros((6, 6))
    # position rows
    P[0, 0] = 4.0 - 3.0 * c
    P[0, 3] = s / n
    P[0, 4] = 2.0 * (1.0 - c) / n
    P[1, 0] = 6.0 * (s - n * t)
    P[1, 1] = 1.0
    P[1, 3] = 2.0 * (c - 1.0) / n
    P[1, 4] = (4.0 * s - 3.0 * n * t) / n
    P[2, 2] = c
    P[2, 5] = s / n
    # velocity rows
    P[3, 0] = 3.0 * n * s
    P[3, 3] = c
    P[3, 4] = 2.0 * s
    P[4, 0] = 6.0 * n * (c - 1.0)
    P[4, 3] = -2.0 * s
    P[4, 4] = 4.0 * c - 3.0
    P[5, 2] = -n * s
    P[5, 5] = c
    return P


def _qp_of(P, q, A, l, u, cone, lam, dtype, device) -> QPData:
    """QPData from f64 numpy arrays, converted once to dtype/device."""
    return make_qp(*(torch.as_tensor(a, dtype=dtype) for a in (P, q, A, l, u)),
                   cone=cone, lam=torch.full((cone.m_l1,), lam, dtype=dtype),
                   device=device)


def _as_np(s):
    if isinstance(s, torch.Tensor):
        s = s.cpu()
    return np.asarray(s, np.float64)


def build_cw_rendezvous(s0, s_target=None, N: int = 20, dt: float = 300.0,
                        n_mean: float = 1.1288e-3, dv_max: float = 1.0,
                        lam: float = 1.0, reg: float = 1e-6,
                        dtype: torch.dtype = torch.float32, device=None):
    """Build the L1 min-fuel impulsive CW rendezvous problem.

    s0: (6,) initial relative state; s_target: (6,) final state (default
    0 = rendezvous with the target). n_mean defaults to a ~400 km LEO
    orbit. Returns (QPData, CWSpec).

    s0 enters only the terminal-equality bounds, so Monte-Carlo
    dispersions share (P, q, A) (see `cw_bounds_for_s0`).
    """
    device = model_device(device)
    s0 = _as_np(s0)
    s_t = np.zeros(6) if s_target is None else _as_np(s_target)
    nvar = 3 * N
    B = np.zeros((6, 3))
    B[3:, :] = np.eye(3)

    # Terminal map: T[:, 3k:3k+3] = Phi^{N-k} B.
    Phi = cw_stm(n_mean, dt)
    T = np.zeros((6, nvar))
    PhiB = Phi @ B                      # Phi^1 B for the last impulse
    for k in range(N - 1, -1, -1):
        T[:, 3 * k:3 * k + 3] = PhiB
        PhiB = Phi @ PhiB
    rhs = s_t - np.linalg.matrix_power(Phi, N) @ s0

    # Row-normalise the terminal map: its entries span ~5 orders of
    # magnitude between position and velocity rows, and the LP crawls
    # without this. Dividing a row and its rhs by the row norm leaves
    # the constraint unchanged.
    rown = np.linalg.norm(T, axis=1, keepdims=True)
    rown = np.where(rown > 0, rown, 1.0)
    T = T / rown
    rhs = rhs / rown[:, 0]
    spec = CWSpec(N=N, dt=dt, n_mean=n_mean,
                  s_target=tuple(map(float, s_t)),
                  row_scale=tuple(map(float, rown[:, 0])))

    # 6 terminal equalities (box), then 3N bounded L1 rows: the impulse
    # bounds fold into the L1 prox (clip of the soft threshold).
    m_eq, m_l1 = 6, nvar
    A = np.zeros((m_eq + m_l1, nvar))
    A[:m_eq] = T
    A[m_eq:] = np.eye(nvar)
    l = np.concatenate([rhs, np.full(nvar, -dv_max)])
    u = np.concatenate([rhs, np.full(nvar, dv_max)])
    qp = _qp_of(reg * np.eye(nvar), np.zeros(nvar), A, l, u,
                ConeSpec(m_box=m_eq, m_l1=m_l1), lam, dtype, device)
    return qp, spec


def build_cw_rendezvous_sparse(s0, s_target=None, N: int = 20,
                               dt: float = 300.0,
                               n_mean: float = 1.1288e-3,
                               dv_max: float = 1.0, lam: float = 1.0,
                               reg: float = 1e-6,
                               dtype: torch.dtype = torch.float32,
                               device=None):
    """Banded state-space transcription of the L1 min-fuel CW problem.

    The states stay decision variables, so A is block-banded. Variables
    per step k (block b=9): [dv_k (3), s_{k+1} (6)]. Rows, [box | L1]:

        N*6 dynamics equalities  s_{k+1} - Phi s_k - Phi B dv_k = rhs_k
             (rhs_0 = Phi s_0, else 0)
        6   terminal equalities  s_N = s_target
        N*3 bounded L1 rows on dv_k (lam, ±dv_max)

    Built in canonical units (LU = ‖r0‖, TU = 1/n: nondimensional mean
    motion 1, all data O(1)); dv and lam are nondimensional (LU/TU),
    and spec.lu / spec.tu convert back. The same optimum as the
    condensed form. Returns (QPData, CWSpec).
    """
    device = model_device(device)
    s0 = _as_np(s0)
    s_t = np.zeros(6) if s_target is None else _as_np(s_target)
    lu = max(float(np.linalg.norm(s0[:3])), 1.0)
    tu = 1.0 / n_mean
    spec0 = CWSpec(N=N, dt=dt, n_mean=n_mean, lu=lu, tu=tu)
    s0 = spec0.state_to_nd(torch.from_numpy(s0)).numpy()
    s_t = spec0.state_to_nd(torch.from_numpy(s_t)).numpy()
    dv_max = dv_max * tu / lu
    b = 9
    nvar = N * b
    Phi = cw_stm(1.0, dt / tu)
    B = np.zeros((6, 3))
    B[3:, :] = np.eye(3)
    PhiB = Phi @ B

    def dv_idx(k):
        return k * b

    def s_idx(k):            # state s_{k+1} lives in block k
        return k * b + 3

    m_dyn, m_term, m_l1 = N * 6, 6, N * 3
    m_box = m_dyn + m_term
    A = np.zeros((m_box + m_l1, nvar))
    l = np.zeros(m_box + m_l1)
    u = np.zeros(m_box + m_l1)
    for k in range(N):
        r = k * 6
        A[r:r + 6, s_idx(k):s_idx(k) + 6] = np.eye(6)
        A[r:r + 6, dv_idx(k):dv_idx(k) + 3] = -PhiB
        if k > 0:
            A[r:r + 6, s_idx(k - 1):s_idx(k - 1) + 6] = -Phi
            rhs = np.zeros(6)
        else:
            rhs = Phi @ s0
        l[r:r + 6] = rhs
        u[r:r + 6] = rhs
    r = m_dyn
    A[r:r + 6, s_idx(N - 1):s_idx(N - 1) + 6] = np.eye(6)
    l[r:r + 6] = s_t
    u[r:r + 6] = s_t
    r = m_box
    for k in range(N):
        A[r + 3 * k:r + 3 * k + 3, dv_idx(k):dv_idx(k) + 3] = np.eye(3)
    l[r:] = -dv_max
    u[r:] = dv_max

    qp = _qp_of(reg * np.eye(nvar), np.zeros(nvar), A, l, u,
                ConeSpec(m_box=m_box, m_l1=m_l1), lam, dtype, device)
    spec = CWSpec(N=N, dt=dt, n_mean=n_mean,
                  s_target=tuple(map(float, s_t)), lu=lu, tu=tu)
    return qp, spec


def _with_rows0(qp: QPData, rhs):
    """(l, u) with their first 6 rows set to rhs (..., 6); a batch of
    rhs gives (..., m) bounds."""
    shape = rhs.shape[:-1] + qp.l.shape[-1:]
    l = qp.l.expand(shape).clone()
    u = qp.u.expand(shape).clone()
    l[..., :6] = rhs
    u[..., :6] = rhs
    return l, u


def cw_sparse_bounds_for_s0(qp: QPData, spec: CWSpec, s0):
    """(l, u) of the sparse transcription for a dispersed SI s0 (..., 6)
    tensor: only the first 6 dynamics rows (rhs_0 = Phi s_0) depend on
    it, so dispersions share (P, q, A)."""
    Phi = torch.as_tensor(cw_stm(1.0, spec.dt / spec.tu), dtype=qp.dtype,
                          device=qp.l.device)
    s0 = spec.state_to_nd(torch.as_tensor(s0, dtype=qp.dtype,
                                          device=qp.l.device))
    return _with_rows0(qp, s0 @ Phi.mT)


def cw_bounds_for_s0(qp: QPData, spec: CWSpec, s0):
    """(l, u) for a dispersed initial state tensor s0 (..., 6), keeping
    P, q, A: only the 6 terminal-equality bounds depend on s0."""
    dev = qp.l.device
    PhiN = torch.as_tensor(
        np.linalg.matrix_power(cw_stm(spec.n_mean, spec.dt), spec.N),
        dtype=qp.dtype, device=dev)
    s0 = torch.as_tensor(s0, dtype=qp.dtype, device=dev)
    s_t = torch.tensor(spec.s_target, dtype=qp.dtype, device=dev)
    rown = torch.tensor(spec.row_scale, dtype=qp.dtype, device=dev)
    return _with_rows0(qp, (s_t - s0 @ PhiN.mT) / rown)


def dv_impulses(spec: CWSpec, x):
    """The solution vector as (N, 3) impulses."""
    return x.reshape(x.shape[:-1] + (spec.N, 3))


def propagate(spec: CWSpec, s0, x):
    """Roll the impulsive dynamics forward; returns states (N+1, 6).

    states[k] is the state at node k BEFORE the impulse dv_k; states[N]
    is the final (rendezvous) state. A physics check independent of the
    constraint residuals.
    """
    Phi = torch.as_tensor(cw_stm(spec.n_mean, spec.dt), dtype=x.dtype,
                          device=x.device)
    dvs = dv_impulses(spec, x)
    s = torch.as_tensor(s0, dtype=x.dtype, device=x.device)
    out = [s]
    for k in range(spec.N):
        s = Phi @ torch.cat([s[:3], s[3:] + dvs[k]])
        out.append(s)
    return torch.stack(out)
