"""Condensed-KKT factor and solve (OSQP §4):

    M = P + sigma*I + Aᵀ diag(rho) A,      M x̃ = rhs

M is symmetric positive definite. Backends:

  'chol' — dense Cholesky, triangular solves per iteration.
  'inv'  — explicit M⁻¹; each iteration's solve is one product, and the
           fused kernel (ops/fused.py) consumes M⁻¹ and M directly.

Right-hand sides keep the lane layout (B, n) against one shared factor.
A Cholesky that fails (M not positive definite in the working
precision) yields a NaN factor, so the solver's NaN tripwire sets
NUMERICAL_ERROR instead of raising.
"""
from __future__ import annotations

import torch


def condensed_matrix(P, A, sigma, rho_vec):
    """M = P + sigma I + Aᵀ diag(rho) A."""
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    return P + sigma * eye + A.transpose(-1, -2) @ (rho_vec[..., :, None] * A)


def _cholesky(M):
    L, info = torch.linalg.cholesky_ex(M)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def factor_condensed(P, A, sigma, rho_vec, backend: str):
    """Build the cached factor for `backend`: a dict holding 'M' (kept
    for refinement) and 'L' ('chol') or 'Minv' ('inv')."""
    M = condensed_matrix(P, A, sigma, rho_vec)
    if backend == "chol":
        return {"M": M, "L": _cholesky(M)}
    if backend == "inv":
        L = _cholesky(M)
        eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        return {"M": M, "Minv": Linv.transpose(-1, -2) @ Linv}
    raise ValueError(f"unknown or unported backend {backend!r}")


def _chol_solve(L, rhs):
    """Solve (L Lᵀ) x = rhs for rhs (..., n) against a shared L (n, n)."""
    n = L.shape[-1]
    flat = rhs.reshape(-1, n).T                  # (n, K)
    y = torch.linalg.solve_triangular(L, flat, upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)
    return x.T.reshape(rhs.shape)


def _matvec_M(fac, v):
    """M v for lane-batched v (..., n)."""
    return v @ fac["M"].mT


def solve_condensed(fac, rhs, backend: str, refine_steps: int = 0):
    """Solve M x = rhs with the cached factor, then `refine_steps`
    steps of iterative refinement."""
    if backend == "chol":
        def apply(r):
            return _chol_solve(fac["L"], r)
    elif backend == "inv":
        def apply(r):
            return r @ fac["Minv"].mT
    else:
        raise ValueError(f"unknown or unported backend {backend!r}")
    x = apply(rhs)
    for _ in range(refine_steps):
        x = x + apply(rhs - _matvec_M(fac, x))
    return x
