"""Modified Ruiz equilibration (OSQP §5).

Scaled problem:  P̄ = c·D P D,  q̄ = c·D q,  Ā = E A D,  l̄ = E l,  ū = E u,
L1 weights λ̄ = c·λ/E. Recovery: x = D x̄, z = E⁻¹ z̄, y = c⁻¹ E ȳ.

A second-order cone is invariant only under uniform positive scaling,
so E is forced constant within each SOC block (the geometric mean of
the block's Ruiz factors).

A batch of independent problems (P (B, n, n), A (B, m, n)) is
equilibrated lane by lane: d (B, n), e (B, m) and c (B, 1), so that
c broadcasts against the lanes' rows. A block-partitioned consensus
problem gets ONE scaling shared by all its blocks
(`ruiz_equilibrate_blocks`).
"""
from __future__ import annotations

import dataclasses

import torch

from ..problem import ConeSpec, QPData


@dataclasses.dataclass(frozen=True)
class Scaling:
    """Diagonal scaling state: d (n,), e (m,), cost scalar c; with a
    leading lane dimension d (B, n), e (B, m), c (B, 1)."""

    d: torch.Tensor
    e: torch.Tensor
    c: torch.Tensor

    @classmethod
    def identity(cls, n, m, dtype, device):
        return cls(d=torch.ones(n, dtype=dtype, device=device),
                   e=torch.ones(m, dtype=dtype, device=device),
                   c=torch.ones((), dtype=dtype, device=device))

    # --- variable recovery (scaled -> unscaled) ---
    def unscale_x(self, xb):
        return self.d * xb

    def unscale_z(self, zb):
        return zb / self.e

    def unscale_y(self, yb):
        return (self.e / self.c) * yb

    # --- warm-start injection (unscaled -> scaled) ---
    def scale_x(self, x):
        return x / self.d

    def scale_z(self, z):
        return self.e * z

    def scale_y(self, y):
        return (self.c / self.e) * y

    def astype(self, dtype):
        return Scaling(d=self.d.to(dtype), e=self.e.to(dtype),
                       c=self.c.to(dtype))


def _soc_block_uniform(e_step, cone: ConeSpec):
    """Replace per-row factors inside each SOC block by their geomean."""
    if not cone.soc_dims:
        return e_step
    mb = cone.m_box + cone.m_l1
    head = e_step[..., :mb]
    tail = e_step[..., mb:]
    parts = [head]
    if cone.soc_uniform:
        d = cone.soc_dims[0]
        blk = tail.reshape(tail.shape[:-1] + (cone.n_soc, d))
        g = torch.exp(torch.mean(torch.log(blk), dim=-1, keepdim=True))
        parts.append(g.expand(blk.shape).reshape(tail.shape))
    else:
        off = 0
        for d in cone.soc_dims:
            seg = torch.log(tail[..., off:off + d])
            g = torch.exp(torch.mean(seg, dim=-1, keepdim=True)
                          if seg.dim() > 1 else torch.mean(seg))
            parts.append(g.expand(seg.shape))
            off += d
    return torch.cat(parts, dim=-1)


def _bounds_and_lam(qp: QPData, e, c):
    l = torch.where(torch.isfinite(qp.l), e * qp.l, qp.l)
    u = torch.where(torch.isfinite(qp.u), e * qp.u, qp.u)
    mb, ml = qp.cone.m_box, qp.cone.m_l1
    lam = c * qp.lam / e[..., mb:mb + ml] if ml else qp.lam
    return l, u, lam


def scale_qp(qp: QPData, scaling: Scaling) -> QPData:
    """Apply a precomputed Scaling to dense problem data (q/l/u may carry
    a lane dimension). The re-centred rounds use it: their correction
    problems keep the original (P, A), so re-running Ruiz would
    recompute the same (d, e)."""
    d, e, c = scaling.d, scaling.e, scaling.c
    P = c * (d[:, None] * qp.P * d[None, :])
    q = c * (d * qp.q)
    A = e[:, None] * qp.A * d[None, :]
    l, u, lam = _bounds_and_lam(qp, e, c)
    return QPData(P=P, q=q, A=A, l=l, u=u, lam=lam, cone=qp.cone)


def scale_qp_blocks(qp_blk: QPData, scaling: Scaling, spec) -> QPData:
    """Apply one block-shared Scaling to block-stacked data: P (S, nb,
    nb), A (S, mb, nb), q/l/u/lam with a leading block axis (l, u and q
    may also lead with a scenario axis); the blocks' cone is the local
    cone of `spec`. The consensus re-centred rounds use it: their
    correction problems keep the original (P, A). The formulas are
    scale_qp's, broadcast over the leading axes."""
    if qp_blk.cone != spec.cone:
        raise ValueError("block data must carry the spec's local cone")
    return scale_qp(qp_blk, scaling)


def ruiz_equilibrate_blocks(qp_blk: QPData, spec, iters: int,
                            reduce_max=None):
    """Block-shared Ruiz equilibration for consensus problems.

    One diagonal scaling (d (nb,), e (mb,), c) computed jointly over the
    stacked per-block data (P (S, nb, nb), A (S, mb, nb)): the max norms
    reduce over the block axis too, and `reduce_max` (the horizon axis's
    pmax where the blocks are split over ranks) carries each max across
    ranks. A max is exact, so the scaling is bitwise the same however
    the blocks are split. A single shared scaling keeps the consensus
    averaging valid: per-block scalings would scale the two copies of a
    boundary state differently.

    Two invariances are enforced on e: SOC blocks of the local cone stay
    uniformly scaled, and the left- and right-edge row groups get the
    same factors (their geometric mean), so the duplicated boundary
    copies of neighbouring blocks live on identical scales and their
    pairwise average stays the exact subspace projection.

    `spec` is a parallel.consensus.ConsensusSpec. Returns (scaled
    QPData, Scaling); iters=0 gives the identity.
    """
    nb, mb = spec.nb, spec.mb
    ml, ns = spec.m_local, spec.ns
    dtype, device = qp_blk.dtype, qp_blk.device
    if iters <= 0:
        return qp_blk, Scaling.identity(nb, mb, dtype, device)
    if reduce_max is None:
        def reduce_max(t):
            return t

    def safe_inv_sqrt(v):
        v = torch.where((v < 1e-10) | ~torch.isfinite(v),
                        torch.ones_like(v), v)
        return 1.0 / torch.sqrt(v)

    def tie_edges(e_step):
        local = _soc_block_uniform(e_step[:ml], spec.cone)
        g = torch.sqrt(e_step[ml:ml + ns] * e_step[ml + ns:])
        return torch.cat([local, g, g])

    mb_box, ml1 = spec.cone.m_box, spec.cone.m_l1
    P, q, A = qp_blk.P, qp_blk.q, qp_blk.A
    d = torch.ones(nb, dtype=dtype, device=device)
    e = torch.ones(mb, dtype=dtype, device=device)
    c = torch.ones((), dtype=dtype, device=device)
    for _ in range(iters):
        # Joint column norms over (block, row).
        nx = reduce_max(torch.maximum(P.abs().amax(dim=(0, 1)),
                                      A.abs().amax(dim=(0, 1))))
        dx = safe_inv_sqrt(nx)
        de = tie_edges(safe_inv_sqrt(reduce_max(A.abs().amax(dim=(0, 2)))))
        P = dx[None, :, None] * P * dx[None, None, :]
        q = dx * q
        A = de[None, :, None] * A * dx[None, None, :]
        d = d * dx
        e = e * de
        # Cost normalisation incl. the L1 term (see ruiz_equilibrate).
        cost_scale = torch.maximum(
            reduce_max(P.abs().amax(dim=(0, 1))).mean(),
            reduce_max(q.abs().amax()))
        if ml1:
            lam_bar = c * qp_blk.lam / e[mb_box:mb_box + ml1]
            cost_scale = torch.maximum(cost_scale, reduce_max((
                lam_bar[..., :, None] * A[:, mb_box:mb_box + ml1, :]
            ).abs().amax()))
        gamma = 1.0 / torch.clamp(cost_scale, min=1e-10)
        P = gamma * P
        q = gamma * q
        c = c * gamma
    l, u, lam = _bounds_and_lam(qp_blk, e, c)
    return (QPData(P=P, q=q, A=A, l=l, u=u, lam=lam, cone=qp_blk.cone),
            Scaling(d=d, e=e, c=c))


def ruiz_equilibrate(qp: QPData, iters: int, reduce_max=None):
    """Return (scaled QPData, Scaling). iters=0 -> identity scaling.

    P (B, n, n) and A (B, m, n) equilibrate each lane on its own. With
    shared P and A a per-lane q (B, n) enters the one cost scale c
    through its max over every lane; `reduce_max` carries that max
    across the ranks that hold the other lanes (the data axis's pmax).
    """
    n, m = qp.n, qp.m
    dtype, device = qp.dtype, qp.device
    lanes = qp.P.dim() == 3
    if iters <= 0 and not lanes:
        return qp, Scaling.identity(n, m, dtype, device)

    def norm_cols(M):
        return M.abs().amax(dim=-2)

    def norm_rows(M):
        return M.abs().amax(dim=-1)

    def safe_inv_sqrt(v):
        v = torch.where((v < 1e-10) | ~torch.isfinite(v),
                        torch.ones_like(v), v)
        return 1.0 / torch.sqrt(v)

    mb, ml = qp.cone.m_box, qp.cone.m_l1
    P, q, A = qp.P, qp.q, qp.A
    lead = P.shape[:-2]
    d = torch.ones(lead + (n,), dtype=dtype, device=device)
    e = torch.ones(lead + (m,), dtype=dtype, device=device)
    c = torch.ones(lead + (1,) if lanes else (), dtype=dtype, device=device)
    for _ in range(iters):
        # Column norms of the symmetric KKT block for the x variables.
        dx = safe_inv_sqrt(torch.maximum(norm_cols(P), norm_cols(A)))
        de = _soc_block_uniform(safe_inv_sqrt(norm_rows(A)), qp.cone)
        P = dx[..., :, None] * P * dx[..., None, :]
        q = dx * q
        A = de[..., :, None] * A * dx[..., None, :]
        d = d * dx
        e = e * de
        # Cost normalisation (OSQP Alg. 2) with the L1 term: the scaled
        # per-column L1 gradient scale max_i λ̄ᵢ|Āᵢⱼ| belongs in the
        # normaliser, or c explodes on min-fuel LPs (P ≈ 0, q = 0).
        if lanes:
            cost_scale = torch.maximum(norm_cols(P).mean(-1),
                                       q.abs().amax(-1))[:, None]
        else:
            q_max = q.abs().max()
            if reduce_max is not None:
                q_max = reduce_max(q_max)
            cost_scale = torch.maximum(norm_cols(P).mean(), q_max)
        if ml:
            lam_bar = c * qp.lam / e[..., mb:mb + ml]
            lam_cols = norm_cols(lam_bar[..., :, None] * A[..., mb:mb + ml, :])
            cost_scale = torch.maximum(
                cost_scale,
                lam_cols.amax(-1, keepdim=True) if lanes else lam_cols.max())
        gamma = 1.0 / torch.clamp(cost_scale, min=1e-10)
        P = (gamma[..., None] if lanes else gamma) * P
        q = gamma * q
        c = c * gamma

    l, u, lam = _bounds_and_lam(qp, e, c)
    return (QPData(P=P, q=q, A=A, l=l, u=u, lam=lam, cone=qp.cone),
            Scaling(d=d, e=e, c=c))
