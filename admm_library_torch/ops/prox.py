"""Proximal operators and cone projections on the static product cone
[box | L1 | SOC] (see problem.ConeSpec). Elementwise and blockwise
tensor code; the fused CUDA kernel (ops/fused.py) computes the same
projections in its epilogues.
"""
from __future__ import annotations

import torch

from ..problem import ConeSpec


def project_box(v, l, u):
    """Euclidean projection onto [l, u] (entries may be ±inf)."""
    return torch.minimum(torch.maximum(v, l), u)


def soft_threshold(v, thresh):
    """Prox of thresh*|.|_1: sign(v) * max(|v| - thresh, 0)."""
    return torch.sign(v) * torch.clamp(v.abs() - thresh, min=0.0)


def soft_threshold_box(v, thresh, l, u):
    """Prox of thresh*|z| + indicator[l, u]: for a 1-D convex objective
    the constrained prox is the clip of the unconstrained one."""
    return project_box(soft_threshold(v, thresh), l, u)


def project_soc_block(t, u):
    """Projection onto {(t, u): ||u||_2 <= t}; t (...,), u (..., d-1).

    ||u|| <= t -> identity; ||u|| <= -t -> origin; else
    ((t + ||u||)/2) * (1, u/||u||).
    """
    nu = torch.linalg.vector_norm(u, dim=-1)
    safe = torch.where(nu > 0, nu, torch.ones_like(nu))
    c = 0.5 * (t + nu)
    in_cone = nu <= t
    in_polar = nu <= -t
    zero = torch.zeros_like(t)
    t_out = torch.where(in_cone, t, torch.where(in_polar, zero, c))
    scale = torch.where(in_cone, torch.ones_like(t),
                        torch.where(in_polar, zero, c / safe))
    return t_out, u * scale[..., None]


def project_soc_rows(v, soc_dims):
    """Project the last axis of v, laid out as concatenated SOC blocks
    (t, u_1..u_{d-1}). Uniform block dims take one reshaped projection;
    mixed dims loop over the blocks."""
    if not soc_dims:
        return v
    dims = tuple(soc_dims)
    if len(set(dims)) == 1:
        d = dims[0]
        blocks = v.reshape(v.shape[:-1] + (len(dims), d))
        t2, u2 = project_soc_block(blocks[..., 0], blocks[..., 1:])
        return torch.cat([t2[..., None], u2], dim=-1).reshape(v.shape)
    parts = []
    off = 0
    for d in dims:
        blk = v[..., off:off + d]
        t2, u2 = project_soc_block(blk[..., 0], blk[..., 1:])
        parts.append(torch.cat([t2[..., None], u2], dim=-1))
        off += d
    return torch.cat(parts, dim=-1)


def project_cone(v, l, u, lam_over_rho, cone: ConeSpec, offset=None):
    """Composite prox onto the product cone.

    v, l, u: (..., m); lam_over_rho: (..., m_l1) soft-threshold levels.
    offset (optional, (..., m)): evaluates the SHIFTED prox
    prox_g(v + a) - a on the L1 and SOC rows, in the offset's dtype (the
    re-centred rounds pass f64, so v + a rounds at f64 and not at the
    f32 scale of ||a||). Box rows ignore it: callers shift l/u instead.
    Results come back in v's dtype.
    """
    mb, ml = cone.m_box, cone.m_l1
    hi = offset.dtype if offset is not None else None
    parts = []
    if mb:
        parts.append(project_box(v[..., :mb], l[..., :mb], u[..., :mb]))
    if ml:
        vl = v[..., mb:mb + ml]
        ll, lu = l[..., mb:mb + ml], u[..., mb:mb + ml]
        if offset is not None:
            a = offset[..., mb:mb + ml]
            out = soft_threshold_box(
                vl.to(hi) + a, lam_over_rho.to(hi), ll.to(hi),
                lu.to(hi)) - a
            parts.append(out.to(v.dtype))
        else:
            parts.append(soft_threshold_box(vl, lam_over_rho, ll, lu))
    if cone.m_soc:
        vs = v[..., mb + ml:]
        if offset is not None:
            a = offset[..., mb + ml:]
            out = project_soc_rows(vs.to(hi) + a, cone.soc_dims) - a
            parts.append(out.to(v.dtype))
        else:
            parts.append(project_soc_rows(vs, cone.soc_dims))
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim=-1)
