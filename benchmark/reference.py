"""The plain reference: what "SOLVED to eps_abs/eps_rel" means, worked out
in f64 from the problem's own data and an answer (x, z, y).

It imports neither the program nor JAX. For

    minimize ½xᵀPx + qᵀx + Σ λ_i |z_i| (L1 rows)
    subject to Ax = z, z in C (boxes [l, u], L1 rows also boxed, SOC blocks)

an answer is judged by three ratios, each a worst case over the rows,
and by the largest of the three, its KKT ratio (`kkt_ratio`):

- primal:  ||Ax - z||_inf / eps_p,
           eps_p = eps_abs + eps_rel * max(||Ax||_inf, ||z||_inf);
- dual:    ||Px + q + Aᵀy||_inf / eps_d,
           eps_d = eps_abs + eps_rel * max(||Px||, ||Aᵀy||, ||q||,
                   max_ij λ_i |A_ij| over the L1 rows) (the L1 term's
                   gradient bound enters the dual scale);
- comp:    ||z - prox_g(z + y)||_inf / eps_p, where g is the indicator of
           C plus the L1 terms: zero exactly when z lies in C and y in the
           subdifferential of g at z (complementary slackness), so an
           answer with feasible residuals but a dual that does not belong
           to its z fails here.

A NaN anywhere reads as an infinite ratio.
"""
from __future__ import annotations

import torch

RATIOS = ("primal", "dual", "comp")


def _linf(v):
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    return v.abs().amax(-1)


def _soc_project(t, w):
    """Projection of (t, w) onto {||w|| <= t}, per block."""
    nw = torch.linalg.vector_norm(w, dim=-1)
    inside = nw <= t
    polar = nw <= -t
    a = 0.5 * (nw + t)
    safe = torch.clamp(nw, min=torch.finfo(t.dtype).tiny)
    pt = torch.where(inside, t, torch.where(polar, 0.0, a))
    pw = torch.where(inside[..., None], w,
                     torch.where(polar[..., None], 0.0,
                                 (a / safe)[..., None] * w))
    return pt, pw


def prox(v, l, u, lam, m_box, m_l1, soc_dims=()):
    """prox_g(v) row-block by row-block: clip on box rows, soft threshold
    by λ then clip on L1 rows, projection on SOC blocks."""
    parts = [torch.minimum(torch.maximum(v[..., :m_box], l[..., :m_box]),
                           u[..., :m_box])]
    if m_l1:
        s = slice(m_box, m_box + m_l1)
        vl = v[..., s]
        soft = torch.sign(vl) * torch.clamp(vl.abs() - lam, min=0.0)
        parts.append(torch.minimum(torch.maximum(soft, l[..., s]),
                                   u[..., s]))
    start = m_box + m_l1
    for d in soc_dims:
        blk = v[..., start:start + d]
        pt, pw = _soc_project(blk[..., 0], blk[..., 1:])
        parts.append(torch.cat([pt[..., None], pw], dim=-1))
        start += d
    return torch.cat(parts, dim=-1)


def ratios(data: dict, x, z, y, eps_abs: float, eps_rel: float) -> dict:
    """The three ratios per problem (tensors over the leading lane
    dimension of x, z, y; l and u may carry it too). `data` holds P, q,
    A, lam (shared) and l, u, m_box, m_l1 and optionally soc_dims."""
    f64 = torch.float64
    P, q, A = (data[k].to(f64) for k in ("P", "q", "A"))
    lam = data["lam"].to(f64)
    l, u = data["l"].to(f64), data["u"].to(f64)
    x, z, y = x.to(f64), z.to(f64), y.to(f64)
    mb, ml = data["m_box"], data["m_l1"]
    Ax = x @ A.mT
    Px = x @ P.mT
    Aty = y @ A
    l1_scale = ((lam[:, None] * A[mb:mb + ml]).abs().amax()
                if ml else torch.zeros((), dtype=f64, device=A.device))
    eps_p = eps_abs + eps_rel * torch.maximum(_linf(Ax), _linf(z))
    eps_d = eps_abs + eps_rel * torch.maximum(
        torch.maximum(_linf(Px), _linf(Aty)),
        torch.maximum(_linf(q).expand_as(eps_p), l1_scale.expand_as(eps_p)))
    r_p = _linf(Ax - z)
    r_d = _linf(Px + q + Aty)
    r_c = _linf(z - prox(z + y, l, u, lam, mb, ml,
                         tuple(data.get("soc_dims", ()))))
    out = dict(primal=r_p / eps_p, dual=r_d / eps_d, comp=r_c / eps_p)
    return {k: torch.nan_to_num(v, nan=float("inf")) for k, v in out.items()}


def kkt_ratio(data: dict, x, z, y, eps_abs: float, eps_rel: float,
              rows: int = 256):
    """(ratio, parts): the largest of the three ratios for each problem of
    (x, z, y) (a tensor over the flattened lanes) and the worst of each
    ratio over them, taken `rows` problems at a time so that a large
    batch fits beside the program."""
    x, z, y = (t.reshape(-1, t.shape[-1]) for t in (x, z, y))
    l, u = (t.reshape(-1, t.shape[-1]) if t.dim() > 1 else t
            for t in (data["l"], data["u"]))
    out, parts = [], {k: 0.0 for k in RATIOS}
    for i in range(0, x.shape[0], rows):
        s = slice(i, i + rows)
        part = dict(data, l=l[s] if l.dim() > 1 else l,
                    u=u[s] if u.dim() > 1 else u)
        r = ratios(part, x[s], z[s], y[s], eps_abs, eps_rel)
        for k in RATIOS:
            parts[k] = max(parts[k], float(r[k].max()))
        out.append(torch.maximum(torch.maximum(r["primal"], r["dual"]),
                                 r["comp"]))
    return torch.cat(out), parts
