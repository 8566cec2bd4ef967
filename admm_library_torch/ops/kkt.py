"""Condensed-KKT factor and solve (OSQP §4):

    M = P + sigma*I + Aᵀ diag(rho) A,      M x̃ = rhs

M is symmetric positive definite. Backends:

  'chol'      — dense Cholesky, triangular solves per iteration.
  'inv'       — explicit M⁻¹; each iteration's solve is one product, and
                the fused kernel (ops/fused.py) consumes M⁻¹ and M.
  'banded'    — block-tridiagonal Cholesky for MPC structure
                (band_block = b): O(N b³) factor, two block sweeps per
                solve (ops/banded.py).
  'spike'     — the banded system partitioned into spike_parts pieces:
                interior inverses and a separator solve (ops/spike.py).
  'cg'        — matrix-free lockstep conjugate gradient on P, A, rho and
                sigma (adaptive rho needs no refactorisation).
  'pallas_cg' — M assembled once; each solve is one launch of the
                Jacobi-PCG kernel (ops/pallas_cg.py).

Right-hand sides keep the lane layout (B, n) against one shared factor.
Every backend but 'pallas_cg' also takes one factor per lane: P
(B, n, n), A (B, m, n) and rho (B, m) give factor leaves that lead with
B, solved against rhs (B, n) (`api.solve_batch`), or one factor per
horizon block shared by scenario lanes, leaves (S, ·) against rhs (B, S,
n) (the consensus drivers). A Cholesky that fails
(M not positive definite in the working precision) yields a NaN factor,
so the solver's NaN tripwire sets NUMERICAL_ERROR instead of raising.
"""
from __future__ import annotations

import torch

from ..core import graph
from ..problem import mv, vm
from . import banded as banded_ops
from . import spike as spike_ops
from . import pallas_cg
from .pallas_cg import pallas_cg_solve

# Lockstep CG tests its loop condition every this many steps
# (`cg_blocks`); extra steps with every lane frozen leave x unchanged.
_CG_CHECK = 8


def condensed_matrix(P, A, sigma, rho_vec):
    """M = P + sigma I + Aᵀ diag(rho) A."""
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    return P + sigma * eye + A.transpose(-1, -2) @ (rho_vec[..., :, None] * A)


def cholesky_or_nan(M):
    """Cholesky factor of M, all NaN where M is not positive definite
    (as the JAX package's cholesky returns)."""
    L, info = torch.linalg.cholesky_ex(M)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def factor_condensed(P, A, sigma, rho_vec, backend: str, band_block: int = 0,
                     spike_parts: int = 0):
    """Build the cached factor for `backend`: a dict holding 'M' and
    'L' ('chol'), 'Minv' ('inv'), the block factors 'Ld', 'Ll'
    ('banded') or the spike_factor leaves ('spike'); M alone
    ('pallas_cg'); or the operator pieces P, A, rho, sigma ('cg')."""
    if backend == "cg":
        # A fill, not a host-to-device copy: a captured prologue holds it.
        return {"P": P, "A": A, "rho": rho_vec,
                "sigma": torch.full((), sigma, dtype=P.dtype,
                                    device=P.device)}
    M = condensed_matrix(P, A, sigma, rho_vec)
    if backend == "pallas_cg":
        # CG needs exact symmetry, which the product's rounding need not
        # give.
        return {"M": 0.5 * (M + M.transpose(-1, -2))}
    if backend == "chol":
        return {"M": M, "L": cholesky_or_nan(M)}
    if backend == "inv":
        L = cholesky_or_nan(M)
        eye = torch.eye(M.shape[-1], dtype=M.dtype,
                        device=M.device).expand(L.shape)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        return {"M": M, "Minv": Linv.transpose(-1, -2) @ Linv}
    if backend == "banded":
        if band_block <= 0:
            raise ValueError("banded backend requires band_block > 0")
        diag, low = banded_ops.dense_to_block_tridiag(M, band_block)
        Ld, Ll = banded_ops.block_tridiag_cholesky(diag, low)
        return {"M": M, "Ld": Ld, "Ll": Ll}
    if backend == "spike":
        if band_block <= 0 or spike_parts <= 0:
            raise ValueError(
                "spike backend requires band_block > 0 and spike_parts > 0")
        return {"M": M, **spike_ops.spike_factor(M, band_block, spike_parts)}
    raise ValueError(f"unknown backend {backend!r}")


def _chol_solve(L, rhs):
    """Solve (L Lᵀ) x = rhs: rhs (..., n) against a shared L (n, n),
    rhs (B, n) against one factor per lane, L (B, n, n), or rhs (...,
    S, n) against one factor per block, L (S, n, n), with the scenario
    dimensions folded into each block's right-hand-side columns."""
    if L.dim() > 2 and rhs.dim() > L.dim() - 1:
        S, n = rhs.shape[-2:]
        cols = rhs.reshape(-1, S, n).permute(1, 2, 0)      # (S, n, K)
        y = torch.linalg.solve_triangular(L, cols, upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)
        return x.permute(2, 0, 1).reshape(rhs.shape)
    if L.dim() > 2:
        y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)
        return x[..., 0]
    n = L.shape[-1]
    flat = rhs.reshape(-1, n).T                  # (n, K)
    y = torch.linalg.solve_triangular(L, flat, upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)
    return x.T.reshape(rhs.shape)


def _matvec_M(fac, v):
    """M v for lane-batched v (..., n), against a shared or a per-lane
    factor; matrix-free for the 'cg' factor."""
    if "M" in fac:
        return mv(fac["M"], v)
    Av = mv(fac["A"], v)
    return mv(fac["P"], v) + fac["sigma"] * v + vm(fac["rho"] * Av, fac["A"])


def cg_blocks(max_iter: int):
    """The step counts of the blocks of one CG solve: `_CG_CHECK` steps
    each, the last one shorter where max_iter is not a multiple."""
    full, rest = divmod(max_iter, _CG_CHECK)
    return [_CG_CHECK] * full + ([rest] if rest else [])


def cg_start(fac, rhs, x0=None, tol: float = 1e-9):
    """The start of a lockstep CG solve of M x = rhs: the state dict (x,
    r, p, rs, tol2) that `cg_steps` advances."""
    x = torch.zeros_like(rhs) if x0 is None else x0
    r = rhs - _matvec_M(fac, x)
    return dict(x=x, r=r, p=r, rs=(r * r).sum(-1),
                tol2=(tol * tol) * torch.clamp((rhs * rhs).sum(-1), min=1.0))


def cg_live(cg):
    """The CG's loop condition before a block: a 0-d bool, true while a
    lane's residual is above its tolerance."""
    return (cg["rs"] > cg["tol2"]).any()


def cg_steps(fac, cg, steps: int):
    """`steps` lockstep CG steps from the state dict `cg`; a lane freezes
    once ‖r‖² ≤ tol²·max(‖rhs‖², 1) (its alpha and beta are 0)."""
    x, r, p, rs, tol2 = (cg[k] for k in ("x", "r", "p", "rs", "tol2"))
    for _ in range(steps):
        Mp = _matvec_M(fac, p)
        pMp = (p * Mp).sum(-1)
        active = rs > tol2
        alpha = torch.where(active, rs / torch.where(pMp > 0, pMp, 1.0), 0.0)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Mp
        rs_new = (r * r).sum(-1)
        beta = torch.where(active, rs_new / torch.where(rs > 0, rs, 1.0), 0.0)
        p = r + beta[..., None] * p
        rs = torch.where(active, rs_new, rs)
    return dict(x=x, r=r, p=p, rs=rs, tol2=tol2)


def cg_solve(fac, rhs, x0=None, tol: float = 1e-9, max_iter: int = 200):
    """Lockstep conjugate gradient on M x = rhs, all lanes of rhs's
    leading dims together; a lane freezes once ‖r‖² ≤ tol²·max(‖rhs‖², 1).
    Runs the blocks of `cg_blocks(max_iter)` while `cg_live` before each
    says a lane is still above its tolerance (a NaN residual counts as
    frozen) through `core.graph.while_blocks`: on the card inside a
    captured check a WHILE node and, where max_iter is no multiple of
    _CG_CHECK, an IF node whose condition stays on the device, elsewhere
    a host read before each block."""
    cg = graph.while_blocks(
        cg_start(fac, rhs, x0, tol), cg_live,
        lambda cg, steps: cg_steps(fac, cg, steps), cg_blocks(max_iter))
    return cg["x"]


def prepare(backend: str, rows: int, n: int, dtype, device) -> None:
    """The host-side set-up that a backend's solves of `rows` right-hand
    sides of length n in `dtype` on `device` need before a capture meets
    them: for 'pallas_cg' the kernel library and its launch plan
    (`pallas_cg.prepare`); nothing for the others."""
    if backend == "pallas_cg":
        pallas_cg.prepare(rows, n, dtype, device)


def solve_condensed(fac, rhs, backend: str, refine_steps: int = 0,
                    cg_tol: float = 1e-9, cg_max_iter: int = 200):
    """Solve M x = rhs with the cached factor, then `refine_steps`
    steps of iterative refinement (none for the CG backends)."""
    if backend == "cg":
        return cg_solve(fac, rhs, tol=cg_tol, max_iter=cg_max_iter)
    if backend == "pallas_cg":
        M = fac["M"]
        if M.dim() != 2:
            raise ValueError("pallas_cg requires an unbatched (shared) M")
        flat = rhs.reshape(-1, rhs.shape[-1])
        x = pallas_cg_solve(M, flat, iters=cg_max_iter, tol=cg_tol)
        return x.reshape(rhs.shape)
    if backend == "chol":
        def apply(r):
            return _chol_solve(fac["L"], r)
    elif backend == "inv":
        def apply(r):
            return mv(fac["Minv"], r)
    elif backend == "banded":
        def apply(r):
            return banded_ops.block_tridiag_solve(fac["Ld"], fac["Ll"], r)
    elif backend == "spike":
        def apply(r):
            return spike_ops.spike_solve(fac, r)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    x = apply(rhs)
    for _ in range(refine_steps):
        x = x + apply(rhs - _matvec_M(fac, x))
    return x
