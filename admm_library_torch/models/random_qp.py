"""Random dense QP generators.

Benchmark config 1: a box-constrained random dense QP (n=100, m=200).

`reference_random_box_qp()` returns the instance that the JAX package's
`random_box_qp(jax.random.PRNGKey(0))` draws, stored in
random_qp_seed0.npz (a torch.Generator draws other numbers from the same
seed), so the port can solve the reference's own config-1 problem.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..problem import ConeSpec, QPData, make_qp, qp_from_numpy
from . import model_device

_REFERENCE = Path(__file__).with_name("random_qp_seed0.npz")


def _randn(generator, shape, dtype, device):
    """Normal draws on the generator's device, moved to `device`."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def random_box_qp(generator: torch.Generator, n: int = 100, m: int = 200,
                  dtype: torch.dtype = torch.float32, device=None,
                  cond_scale: float = 1.0) -> QPData:
    """Seeded random dense box-constrained QP with a nonempty interior.

    P = cond_scale·R Rᵀ + 0.1 I (strictly convex), A dense Gaussian,
    bounds built around A x_feas so the problem is always feasible.
    """
    device = model_device(device)
    R = _randn(generator, (n, n), dtype, device) / n ** 0.5
    P = cond_scale * (R @ R.T) + 0.1 * torch.eye(n, dtype=dtype,
                                                 device=device)
    q = _randn(generator, (n,), dtype, device)
    A = _randn(generator, (m, n), dtype, device) / n ** 0.5
    Ax = A @ _randn(generator, (n,), dtype, device)
    spread = _randn(generator, (m,), dtype, device).abs() + 0.1
    return make_qp(P, q, A, Ax - spread, Ax + spread,
                   cone=ConeSpec(m_box=m))


def random_eq_ineq_qp(generator: torch.Generator, n: int = 60,
                      m_eq: int = 10, m_in: int = 80,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> QPData:
    """Random QP mixing equality rows (l == u) and inequality rows."""
    device = model_device(device)
    m = m_eq + m_in
    R = _randn(generator, (n, n), dtype, device) / n ** 0.5
    P = R @ R.T + 0.1 * torch.eye(n, dtype=dtype, device=device)
    q = _randn(generator, (n,), dtype, device)
    A = _randn(generator, (m, n), dtype, device) / n ** 0.5
    Ax = A @ _randn(generator, (n,), dtype, device)
    spread = _randn(generator, (m,), dtype, device).abs() + 0.1
    l = torch.cat([Ax[:m_eq], Ax[m_eq:] - spread[m_eq:]])
    u = torch.cat([Ax[:m_eq], Ax[m_eq:] + spread[m_eq:]])
    return make_qp(P, q, A, l, u, cone=ConeSpec(m_box=m))


def reference_random_box_qp(device=None) -> QPData:
    """The JAX reference's config-1 instance (n=100, m=200, f32)."""
    device = model_device(device)
    with np.load(_REFERENCE) as f:
        arrays = {k: f[k] for k in ("P", "q", "A", "l", "u", "lam")}
    return qp_from_numpy(arrays, ConeSpec(m_box=arrays["A"].shape[0]),
                         device=device)
