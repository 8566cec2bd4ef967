"""Horizon-partitioned problem builders for consensus ADMM.

Splits a horizon-N optimal-control problem into B contiguous blocks in
the layout `parallel.consensus` expects: every block carries a
duplicated copy of its LEFT boundary state, local dynamics/bound rows,
and edge rows reading the boundary copies.

Variable layout per block (S = N // B steps):
    x_b = [ sL (ns) | u_0 (nu), s_1 (ns) | ... | u_{S-1}, s_S ]
Row layout per block ([local | left-edge | right-edge]):
    dynamics equalities   S*ns rows   s_{j+1} - F s_j - G u_j = 0
    control bounds        S*nu rows   |u_j| <= u_max
    left-edge rows        ns          read sL      (block 0: == s0)
    right-edge rows       ns          read s_S     (block B-1: == s_target)

The data is built in f64 numpy and converted once, as the JAX builder
does, so both packages hold identical problems. The builders build on
the CUDA card unless given a device.

`reference_s0()` returns the dispersions that the JAX package's
`partition_mpc_mc(jax.random.PRNGKey(0), 1024, ...)` draws for the
consensus_mc_1024 cell, stored in consensus_mc_s0_seed0.npz.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..parallel.consensus import ConsensusSpec
from ..problem import ConeSpec, QPData
from . import model_device
from .double_integrator import MPCSpec, dynamics_matrices
from .monte_carlo import disperse_s0

_REFERENCE_S0 = Path(__file__).with_name("consensus_mc_s0_seed0.npz")


def partition_mpc(s0, s_target, N: int, n_blocks: int, dim: int = 3,
                  dt: float = 1.0, u_max: float = 1.0,
                  state_reg: float = 1e-8,
                  dtype: torch.dtype = torch.float32, device=None):
    """Block-partitioned double-integrator rendezvous MPC.

    Returns (block-stacked QPData with leading (B,) axis, ConsensusSpec,
    MPCSpec). Equivalent to models.double_integrator.build_mpc_qp on the
    same horizon.
    """
    if N % n_blocks != 0:
        raise ValueError(f"N={N} not divisible by n_blocks={n_blocks}")
    device = model_device(device)
    S = N // n_blocks
    spec_mpc = MPCSpec(N=N, dim=dim, dt=dt)
    ns, nu = spec_mpc.ns, spec_mpc.nu
    F, G = dynamics_matrices(spec_mpc)
    s0 = np.asarray(torch.as_tensor(s0).cpu(), np.float64)
    s_t = np.asarray(torch.as_tensor(s_target).cpu(), np.float64)

    nb = ns + S * (nu + ns)
    m_dyn = S * ns
    m_local = m_dyn + S * nu
    mb = m_local + 2 * ns

    def s_idx(j):
        """Variable offset of state s_j inside a block (j=0 -> sL)."""
        return 0 if j == 0 else ns + (j - 1) * (nu + ns) + nu

    def u_idx(j):
        return ns + j * (nu + ns)

    # --- shared per-block structure (identical across blocks) ---
    A = np.zeros((mb, nb))
    for j in range(S):
        r = j * ns
        A[r:r + ns, s_idx(j + 1):s_idx(j + 1) + ns] = np.eye(ns)
        A[r:r + ns, s_idx(j):s_idx(j) + ns] = -F
        A[r:r + ns, u_idx(j):u_idx(j) + nu] = -G
    for j in range(S):
        r = m_dyn + j * nu
        A[r:r + nu, u_idx(j):u_idx(j) + nu] = np.eye(nu)
    A[m_local:m_local + ns, :ns] = np.eye(ns)               # left edge
    A[m_local + ns:, s_idx(S):s_idx(S) + ns] = np.eye(ns)   # right edge

    Pd = np.full(nb, state_reg)
    for j in range(S):
        Pd[u_idx(j):u_idx(j) + nu] = 1.0
    P = np.diag(Pd)

    l = np.zeros(mb)
    u = np.zeros(mb)
    l[m_dyn:m_local] = -u_max
    u[m_dyn:m_local] = u_max
    l[m_local:] = -np.inf
    u[m_local:] = np.inf

    B = n_blocks
    lb = np.broadcast_to(l, (B, mb)).copy()
    ub = np.broadcast_to(u, (B, mb)).copy()
    # Global end conditions live in the edge-row bounds of the end blocks.
    lb[0, m_local:m_local + ns] = s0
    ub[0, m_local:m_local + ns] = s0
    lb[B - 1, m_local + ns:] = s_t
    ub[B - 1, m_local + ns:] = s_t

    def conv(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    cone = ConeSpec(m_box=m_local)
    qp = QPData(P=conv(np.broadcast_to(P, (B, nb, nb)).copy()),
                q=conv(np.zeros((B, nb))),
                A=conv(np.broadcast_to(A, (B, mb, nb)).copy()),
                l=conv(lb), u=conv(ub),
                lam=torch.zeros((B, 0), dtype=dtype, device=device),
                cone=cone)
    spec = ConsensusSpec(n_blocks=B, nb=nb, m_local=m_local, ns=ns,
                         cone=cone)
    return qp, spec, spec_mpc


def partition_mpc_from_s0(s0s, s0_nominal, s_target, N: int,
                          n_blocks: int, dim: int = 3,
                          dtype: torch.dtype = torch.float32, device=None,
                          **kw):
    """Scenario-batched partitioned MPC for the given initial states s0s
    (batch, ns): l/u of shape (batch, n_blocks, mb), shared per-block
    P/A/q. Only block 0's left-edge rows depend on the initial state.
    Returns (QPData, ConsensusSpec, MPCSpec, s0s)."""
    device = model_device(device)
    qp, spec, mpc = partition_mpc(
        s0_nominal, s_target, N=N, n_blocks=n_blocks, dim=dim,
        dtype=dtype, device=device, **kw)
    if not isinstance(s0s, torch.Tensor):
        s0s = torch.from_numpy(np.array(s0s))
    s0s = s0s.to(dtype=dtype, device=device)
    B = s0s.shape[0]
    l = qp.l.expand((B,) + qp.l.shape).clone()
    u = qp.u.expand((B,) + qp.u.shape).clone()
    ml = spec.m_local
    l[:, 0, ml:ml + spec.ns] = s0s
    u[:, 0, ml:ml + spec.ns] = s0s
    return (QPData(P=qp.P, q=qp.q, A=qp.A, l=l, u=u, lam=qp.lam,
                   cone=qp.cone), spec, mpc, s0s)


def partition_mpc_mc(generator: torch.Generator, batch: int, s0_nominal,
                     s_target, N: int, n_blocks: int, dim: int = 3,
                     sigma_pos: float = 0.1, sigma_vel: float = 0.01,
                     dtype: torch.dtype = torch.float32, device=None,
                     **kw):
    """Scenario-batched partitioned MPC for consensus_solve_mc, the
    initial state dispersed by `generator` (Gaussian, sigma_pos on
    position and sigma_vel on velocity). Returns (QPData with l/u of
    shape (batch, n_blocks, mb), ConsensusSpec, MPCSpec, s0 batch)."""
    device = model_device(device)
    s0s = disperse_s0(generator, torch.as_tensor(s0_nominal, dtype=dtype),
                      sigma_pos, sigma_vel, batch, dtype, device)
    return partition_mpc_from_s0(s0s, s0_nominal, s_target, N=N,
                                 n_blocks=n_blocks, dim=dim, dtype=dtype,
                                 device=device, **kw)


def reference_s0() -> np.ndarray:
    """The JAX reference's consensus_mc_1024 dispersions, (1024, 6) f32
    (`partition_mpc_mc(PRNGKey(0), 1024, s0, zeros(6), N=50,
    n_blocks=10, dim=3)` with the bench's seed-0 s0)."""
    with np.load(_REFERENCE_S0) as f:
        return f["s0s"]


def assemble_trajectory(spec: ConsensusSpec, mpc: MPCSpec, x_blocks):
    """Stitch per-block solutions into global (controls (N, nu), states
    (N+1, ns)) numpy arrays using each block's owned variables."""
    B = spec.n_blocks
    S = mpc.N // B
    ns, nu = mpc.ns, mpc.nu
    xb = np.asarray(torch.as_tensor(x_blocks).detach().cpu())
    us, ss = [], [xb[0, :ns]]              # global s0 (block 0's left copy)
    for b in range(B):
        off = ns
        for _ in range(S):
            us.append(xb[b, off:off + nu])
            ss.append(xb[b, off + nu:off + nu + ns])
            off += nu + ns
    return np.stack(us), np.stack(ss)
