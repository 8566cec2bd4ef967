"""Partitioned block-tridiagonal KKT solver (SPIKE / substructuring).

Solves the x-update's condensed system

    M x = rhs,   M = P + σI + Aᵀ diag(ρ) A   (block tridiagonal)

exactly across a partition of the horizon, so ADMM iterates equal the
unpartitioned solver's while the solve decomposes over pieces:

  * the N diagonal blocks are cut into `parts` pieces; the last block
    of each piece is its separator, the first Np−1 blocks its interior;
  * each interior is inverted once (the per-solve interior work is one
    batched product, the trade the 'inv' backend makes), together with
    the spikes V = A_int⁻¹ e_f E (left coupling) and
    W = A_int⁻¹ e_l B (right coupling);
  * eliminating the interiors leaves a Schur complement that is block
    tridiagonal in the `parts` separators, factored by ops/banded.py;
  * a solve is a batched interior product, a separator solve of
    `parts` blocks and a batched back-substitution.

The factor may carry leading batch dimensions (one factor per lane, as
`api.solve_batch` holds them); its leaves then lead with them.
"""
from __future__ import annotations

import torch

from . import banded as banded_ops


def _pmv(M, v):
    """Per-part products M[p] v[p]: M (..., parts, r, c) against v
    (..., parts, c), shared or lane-matched leading dimensions."""
    return torch.einsum("...pij,...pj->...pi", M, v)


def spike_factor(M, b: int, parts: int) -> dict:
    """Pre-factor a dense block-tridiagonal SPD M for partitioned solves.

    M: (..., n, n) with n = N·b, N divisible by `parts`, N // parts ≥ 2.
    Entries outside the band are ignored. Returns a dict:
      Ainv (..., parts, ni, ni)  interior inverses, ni = (N/parts − 1)·b
      V, W (..., parts, ni, b)   spikes A_int⁻¹ e_f E and A_int⁻¹ e_l B
      Bl   (..., parts, b, b)    separator rows × last interior columns
      E    (..., parts, b, b)    first interior rows × the previous
                                 part's separator columns (E[0] = 0)
      Tld, Tll                   block Cholesky of the separator Schur
                                 complement ((…, parts, b, b) and
                                 (…, parts−1, b, b))
    """
    from .kkt import cholesky_or_nan
    n = M.shape[-1]
    if n % b != 0:
        raise ValueError(f"matrix dim {n} not divisible by block size {b}")
    N = n // b
    if N % parts != 0:
        raise ValueError(f"{N} blocks not divisible by {parts} parts")
    Np = N // parts
    if Np < 2:
        raise ValueError(f"need >=2 blocks per part, got {Np}")
    npb = Np * b
    ni = (Np - 1) * b
    lead = M.shape[:-2]

    blocks = M.reshape(lead + (parts, npb, parts, npb)).transpose(-3, -2)
    idx = torch.arange(parts, device=M.device)
    Mpp = blocks[..., idx, idx, :, :]                # (..., parts, npb, npb)
    A_int = Mpp[..., :ni, :ni]
    Bl = Mpp[..., ni:, ni - b:ni]                    # sep rows, int cols
    Dsep = Mpp[..., ni:, ni:]
    # Cross-part coupling: first interior row-block of part p against the
    # separator (last) column-block of part p−1.
    sub = blocks[..., idx[1:], idx[:-1], :, :]       # (..., parts−1, npb, npb)
    zero = M.new_zeros(lead + (1, b, b))
    E = torch.cat([zero, sub[..., :b, ni:]], dim=-3)

    L = cholesky_or_nan(A_int)
    eye = torch.eye(ni, dtype=M.dtype, device=M.device).expand(L.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Ainv = Linv.mT @ Linv

    # Spikes: A⁻¹ restricted to the first / last b columns meets the
    # e_f / e_l embeddings directly.
    V = Ainv[..., :, :b] @ E                         # (..., parts, ni, b)
    W = Ainv[..., :, ni - b:] @ Bl.mT

    # Separator Schur complement, block tridiagonal in `parts`:
    #   Td[p] = Dsep[p] − Bl[p] W[p]_l − E[p+1]ᵀ V[p+1]_f
    #   Tl[p−1] (s_{p−1} ↔ s_p) = −Bl[p] V[p]_l
    Vf, Vl = V[..., :b, :], V[..., ni - b:, :]
    Wl = W[..., ni - b:, :]
    Td = Dsep - Bl @ Wl
    Td = Td - torch.cat([E[..., 1:, :, :].mT @ Vf[..., 1:, :, :], zero],
                        dim=-3)
    Tl = -(Bl[..., 1:, :, :] @ Vl[..., 1:, :, :])
    Tld, Tll = banded_ops.block_tridiag_cholesky(Td, Tl)
    return {"Ainv": Ainv, "V": V, "W": W, "Bl": Bl, "E": E,
            "Tld": Tld, "Tll": Tll}


def spike_solve(fac, rhs):
    """Solve M x = rhs with a spike_factor. An unbatched factor takes rhs
    (..., n); a factor batched over lanes takes rhs with the same
    leading dimensions."""
    Ainv, V, W, Bl, E = fac["Ainv"], fac["V"], fac["W"], fac["Bl"], fac["E"]
    parts, ni, b = V.shape[-3:]
    npb = ni + b
    lead = rhs.shape[:-1]
    r = rhs.reshape(lead + (parts, npb))
    ru, rs = r[..., :ni], r[..., ni:]

    g = _pmv(Ainv, ru)
    gl = g[..., ni - b:]
    gf_next = torch.cat([g[..., 1:, :b], g.new_zeros(lead + (1, b))],
                        dim=-2)
    E_next = torch.cat([E[..., 1:, :, :], E[..., :1, :, :].new_zeros(
        E.shape[:-3] + (1, b, b))], dim=-3)
    rs_t = rs - _pmv(Bl, gl) - _pmv(E_next.mT, gf_next)

    s = banded_ops.block_tridiag_solve(
        fac["Tld"], fac["Tll"], rs_t.reshape(lead + (parts * b,)))
    s = s.reshape(lead + (parts, b))
    s_prev = torch.cat([s.new_zeros(lead + (1, b)), s[..., :-1, :]], dim=-2)
    u = g - _pmv(V, s_prev) - _pmv(W, s)
    return torch.cat([u, s], dim=-1).reshape(lead + (parts * npb,))
