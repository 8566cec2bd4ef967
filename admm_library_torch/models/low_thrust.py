"""Low-thrust rendezvous SOCP with thrust-magnitude cones (BASELINE
config 4).

N nodes, a second-order cone per node in the lossless-convexification
style (Acikmese & Ploen): a slack Gamma_k with

    minimize    sum_k Gamma_k * dt        (fuel proxy)
    subject to  s_{k+1} = F s_k + G u_k   (ZOH-discretised CW dynamics)
                ||u_k||_2 <= Gamma_k      (SOC(4) per node)
                0 <= Gamma_k <= u_max
                s_N = s_target

Variables are ordered by time step, block b = [u_k (3), Gamma_k (1),
s_{k+1} (6)] of size 10, so M = P + sigma I + Aᵀ rho A is
block-tridiagonal. Rows follow the [box | L1 | SOC] order.

The data is assembled in f64 numpy, as the JAX package's builder does,
and converted once to tensors of the given dtype and device. The
functions that act on solutions and dispersions take tensors.

`reference_continuation_entry()` returns the point at which the JAX
package's `solve` hands config 4 to its f64 continuation, stored in
low_thrust_entry_seed0.npz, so the port's continuation can start where
the reference's did.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..problem import ConeSpec, QPData, make_qp
from ..solution import Solution
from . import model_device
from .clohessy_wiltshire import _as_np, _with_rows0, cw_stm, state_to_nd

_REFERENCE_ENTRY = Path(__file__).with_name("low_thrust_entry_seed0.npz")


@dataclasses.dataclass(frozen=True)
class LowThrustSpec:
    """Static description of the low-thrust SOCP instance.

    The problem is built in canonical (nondimensional) units: length
    unit LU = ‖r0‖ (the initial separation), time unit TU = 1/n_mean (so
    the nondimensional mean motion is 1). All data is O(1), which makes
    the absolute eps_abs criterion physically meaningful (1e-6 ≈
    millimetres at LU ~ km). Solutions are nondimensional; the helpers
    below convert back to SI.
    """

    N: int
    dt: float                   # node spacing [s] (dimensional)
    n_mean: float               # mean motion [rad/s] (dimensional)
    lu: float = 1.0             # length unit [m]
    tu: float = 1.0             # time unit [s]

    @property
    def block(self) -> int:
        return 10               # u(3) + Gamma(1) + state(6)

    @property
    def n(self) -> int:
        return self.N * self.block

    def state_to_nd(self, s):
        """SI state tensor (m, m/s) -> nondimensional (LU, LU/TU)."""
        return state_to_nd(s, self.lu, self.tu)

    def accel_from_nd(self, u_nd):
        """Nondimensional control (LU/TU²) -> SI accel (m/s²)."""
        return u_nd * (self.lu / self.tu ** 2)


def _zoh_control_matrix(n_mean: float, dt: float, order: int = 24):
    """G = ∫_0^dt Phi(dt - tau) B dtau by Gauss-Legendre quadrature (f64
    numpy). The HCW STM is trigonometric/polynomial, so a 24-point rule
    is exact to machine precision for any realistic n*dt."""
    B = np.zeros((6, 3))
    B[3:, :] = np.eye(3)
    nodes, weights = np.polynomial.legendre.leggauss(order)
    taus = 0.5 * dt * (nodes + 1.0)        # [-1, 1] -> [0, dt]
    G = np.zeros((6, 3))
    for tau, w in zip(taus, weights):
        G += 0.5 * dt * w * (cw_stm(n_mean, dt - tau) @ B)
    return G


def build_low_thrust_socp(s0, s_target=None, N: int = 200, dt: float = 60.0,
                          n_mean: float = 1.1288e-3, u_max: float = 0.01,
                          state_reg: float = 1e-8, ctrl_reg: float = 1e-6,
                          dtype: torch.dtype = torch.float32, device=None):
    """Build the banded low-thrust rendezvous SOCP. Returns (QPData,
    LowThrustSpec).

    s0 enters only the first dynamics rows' bounds, so Monte-Carlo
    dispersions share (P, q, A) (see `lt_bounds_for_s0`).
    """
    device = model_device(device)
    s0 = _as_np(s0)
    s_t = np.zeros(6) if s_target is None else _as_np(s_target)
    lu = max(float(np.linalg.norm(s0[:3])), 1.0)
    tu = 1.0 / n_mean
    spec = LowThrustSpec(N=N, dt=dt, n_mean=n_mean, lu=lu, tu=tu)
    b = spec.block
    nvar = spec.n
    s0 = spec.state_to_nd(torch.from_numpy(s0)).numpy()
    s_t = spec.state_to_nd(torch.from_numpy(s_t)).numpy()
    dt_nd = dt / tu
    u_max = u_max * tu ** 2 / lu
    F = cw_stm(1.0, dt_nd)
    G = _zoh_control_matrix(1.0, dt_nd)

    def u_idx(k):
        return k * b

    def g_idx(k):
        return k * b + 3

    def s_idx(k):           # state s_{k+1} lives in block k
        return k * b + 4

    # --- objective: min sum Gamma_k dt (+ a tiny regularisation) ---
    Pd = np.full(nvar, state_reg)
    q = np.zeros(nvar)
    for k in range(N):
        Pd[u_idx(k):u_idx(k) + 3] = ctrl_reg
        Pd[g_idx(k)] = ctrl_reg
        q[g_idx(k)] = dt_nd

    m_dyn, m_term, m_g, m_soc = N * 6, 6, N, N * 4
    m = m_dyn + m_term + m_g + m_soc
    A = np.zeros((m, nvar))
    l = np.zeros(m)
    u = np.zeros(m)

    # dynamics: s_{k+1} - F s_k - G u_k = (F s_0 if k == 0 else 0)
    for k in range(N):
        r = k * 6
        A[r:r + 6, s_idx(k):s_idx(k) + 6] = np.eye(6)
        A[r:r + 6, u_idx(k):u_idx(k) + 3] = -G
        if k > 0:
            A[r:r + 6, s_idx(k - 1):s_idx(k - 1) + 6] = -F
            rhs = np.zeros(6)
        else:
            rhs = F @ s0
        l[r:r + 6] = rhs
        u[r:r + 6] = rhs

    r = m_dyn                                   # terminal equality
    A[r:r + 6, s_idx(N - 1):s_idx(N - 1) + 6] = np.eye(6)
    l[r:r + 6] = s_t
    u[r:r + 6] = s_t

    r = m_dyn + m_term                          # 0 <= Gamma_k <= u_max
    for k in range(N):
        A[r + k, g_idx(k)] = 1.0
    l[r:r + m_g] = 0.0
    u[r:r + m_g] = u_max

    r = m_dyn + m_term + m_g                    # (Gamma_k, u_k) in SOC(4)
    for k in range(N):
        A[r + 4 * k, g_idx(k)] = 1.0
        A[r + 4 * k + 1:r + 4 * k + 4, u_idx(k):u_idx(k) + 3] = np.eye(3)
    l[r:] = -np.inf
    u[r:] = np.inf

    cone = ConeSpec(m_box=m_dyn + m_term + m_g, soc_dims=(4,) * N)
    qp = make_qp(*(torch.as_tensor(a, dtype=dtype)
                   for a in (np.diag(Pd), q, A, l, u)),
                 cone=cone, device=device)
    return qp, spec


def lt_bounds_for_s0(qp: QPData, spec: LowThrustSpec, s0):
    """(l, u) for a dispersed SI initial state tensor s0 (..., 6),
    keeping P, q, A."""
    dev = qp.l.device
    F = torch.as_tensor(cw_stm(1.0, spec.dt / spec.tu), dtype=qp.dtype,
                        device=dev)
    s0 = spec.state_to_nd(torch.as_tensor(s0, dtype=qp.dtype, device=dev))
    return _with_rows0(qp, s0 @ F.mT)


def thrust_profile(spec: LowThrustSpec, x):
    """(u (N, 3), Gamma (N,)) of the solution vector, nondimensional
    (LU/TU²; spec.accel_from_nd converts to SI). Cone feasibility
    ‖u‖ <= Gamma is unit-free."""
    blocks = x.reshape(x.shape[:-1] + (spec.N, spec.block))
    return blocks[..., :3], blocks[..., 3]


def rollout(spec: LowThrustSpec, s0, x):
    """Integrate the discrete dynamics under the solved controls: the
    nondimensional states (N+1, 6) from the SI state s0. A physics check
    independent of the constraint residuals."""
    kw = dict(dtype=x.dtype, device=x.device)
    F = torch.as_tensor(cw_stm(1.0, spec.dt / spec.tu), **kw)
    G = torch.as_tensor(_zoh_control_matrix(1.0, spec.dt / spec.tu), **kw)
    us, _ = thrust_profile(spec, x)
    s = spec.state_to_nd(torch.as_tensor(s0, **kw))
    out = [s]
    for k in range(spec.N):
        s = F @ s + G @ us[k]
        out.append(s)
    return torch.stack(out)


def reference_continuation_entry(device=None) -> Solution:
    """The unsolved point that the JAX package's solve hands to its f64
    continuation on config 4 (bench_low_thrust: N=200, its f32 data
    solved as f64, the bench settings), on the CPU: STALLED after the
    shared pass's 4,525 iterations. Floating fields in f64."""
    device = model_device(device)
    with np.load(_REFERENCE_ENTRY) as f:
        return Solution(**{k: torch.as_tensor(f[k], device=device)
                           for k in f.files})
