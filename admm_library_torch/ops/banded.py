"""Block-tridiagonal Cholesky for MPC-banded KKT systems.

MPC problems over a horizon of N steps (states and controls interleaved
per step) give a condensed matrix M = P + σI + Aᵀ diag(ρ) A that is block
tridiagonal with a fixed block size b, so factoring it costs O(N b³)
instead of O((N b)³). Factorisation M = L Lᵀ with L block lower
bidiagonal:

    L_0 L_0ᵀ = D_0
    C_i      = B_i L_i⁻ᵀ                 (sub-diagonal factor block)
    L_{i+1} L_{i+1}ᵀ = D_{i+1} − C_i C_iᵀ

with D_i the diagonal and B_i the sub-diagonal blocks of M. The factor
and both substitution sweeps are loops on the host over the N blocks,
each step a few small batched operations on the factor's device.

Every function accepts leading batch dimensions on M (one factor per
lane, as `api.solve_batch` holds them). A b×b block that is not
positive definite makes its factor NaN (`kkt.cholesky_or_nan`), so the
solver's NaN tripwire stops the run instead of raising.
"""
from __future__ import annotations

import torch


def dense_to_block_tridiag(M, b: int):
    """Extract (diag, low) blocks of a dense block-tridiagonal matrix.

    M: (..., n, n) with n = N·b. Returns diag (..., N, b, b) and low
    (..., N−1, b, b) with low[i] = M[(i+1)b:(i+2)b, ib:(i+1)b]. Entries
    of M outside the band are ignored.
    """
    n = M.shape[-1]
    if n % b != 0:
        raise ValueError(f"matrix dim {n} not divisible by block size {b}")
    N = n // b
    lead = M.shape[:-2]
    blocks = M.reshape(lead + (N, b, N, b)).transpose(-3, -2)
    idx = torch.arange(N, device=M.device)
    return blocks[..., idx, idx, :, :], blocks[..., idx[1:], idx[:-1], :, :]


def block_tridiag_cholesky(diag, low):
    """Factor a block-tridiagonal SPD matrix.

    diag (..., N, b, b), low (..., N−1, b, b). Returns (Ld, Ll): Ld
    (..., N, b, b) the lower-triangular diagonal blocks of L, Ll
    (..., N−1, b, b) its dense sub-diagonal blocks C_i.
    """
    from .kkt import cholesky_or_nan
    L = cholesky_or_nan(diag[..., 0, :, :])
    Ld, Ll = [L], []
    for i in range(diag.shape[-3] - 1):
        # C = B L⁻ᵀ, computed as Cᵀ = L⁻¹ Bᵀ.
        C = torch.linalg.solve_triangular(
            L, low[..., i, :, :].mT, upper=False).mT
        L = cholesky_or_nan(diag[..., i + 1, :, :] - C @ C.mT)
        Ld.append(L)
        Ll.append(C)
    return (torch.stack(Ld, dim=-3),
            torch.stack(Ll, dim=-3) if Ll else low[..., :0, :, :])


def block_tridiag_solve(Ld, Ll, rhs):
    """Solve (L Lᵀ) x = rhs with the block factors.

    An unbatched factor (N, b, b) takes rhs (..., N·b): every leading
    dimension of rhs is folded into the columns of one (b, K) triangular
    solve per block. A factor with leading batch dimensions (..., N, b, b)
    takes rhs with the same leading dimensions, (..., N·b).
    """
    N, b = Ld.shape[-3], Ld.shape[-1]
    lead = Ld.shape[:-3]
    if lead:
        if rhs.shape[:-1] != lead:
            raise ValueError(
                f"rhs {tuple(rhs.shape)} does not match a factor batched "
                f"over {tuple(lead)}")
        r = rhs.reshape(lead + (N, b, 1))                  # (..., N, b, 1)
    else:
        r = rhs.reshape(-1, N, b).permute(1, 2, 0)         # (N, b, K)

    def tri(i, t):
        return torch.linalg.solve_triangular(Ld[..., i, :, :], t,
                                             upper=False)

    def tri_t(i, t):
        return torch.linalg.solve_triangular(Ld[..., i, :, :].mT, t,
                                             upper=True)

    # Forward: y_0 = L_0⁻¹ r_0;  y_i = L_i⁻¹ (r_i − C_{i−1} y_{i−1}).
    ys = [tri(0, r[..., 0, :, :])]
    for i in range(1, N):
        ys.append(tri(i, r[..., i, :, :] - Ll[..., i - 1, :, :] @ ys[-1]))
    # Backward: x_{N−1} = L_{N−1}⁻ᵀ y_{N−1};  x_i = L_i⁻ᵀ (y_i − C_iᵀ x_{i+1}).
    xs = [tri_t(N - 1, ys[-1])]
    for i in range(N - 2, -1, -1):
        xs.append(tri_t(i, ys[i] - Ll[..., i, :, :].mT @ xs[-1]))
    x = torch.stack(xs[::-1], dim=-3)                      # like r
    if lead:
        return x.reshape(rhs.shape)
    return x.permute(2, 0, 1).reshape(rhs.shape)
