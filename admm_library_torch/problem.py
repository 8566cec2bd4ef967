"""Canonical problem data.

    minimize    (1/2) xᵀ P x + qᵀ x  +  Σ_j λ_j |(A x)_j|          (L1 rows)
    subject to  l_i ≤ (A x)_i ≤ u_i                                 (box rows)
                (A x)_blk ∈ SOC(d)                                  (SOC rows)

Rows of A are ordered [box | L1 | SOC blocks] (a static `ConeSpec`), so
the z-update is a fixed composition of vectorised projections.
Tensors keep the JAX package's layout: P (n, n), q (n,), A (m, n),
l/u (m,), lam (m_l1,); l/u (and q) may carry a leading lane dimension.
A batch of independent problems (`api.solve_batch`) gives every tensor a
leading lane dimension: P (B, n, n), A (B, m, n), q (B, n), l/u (B, m),
lam (B, m_l1).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ConeSpec:
    """Static description of the row blocks of A: ``m_box`` box rows
    (equalities are box rows with l == u), then ``m_l1`` L1 rows, then
    one block of ``d`` rows per entry of ``soc_dims``."""

    m_box: int = 0
    m_l1: int = 0
    soc_dims: Tuple[int, ...] = ()

    @property
    def m_soc(self) -> int:
        return sum(self.soc_dims)

    @property
    def m(self) -> int:
        return self.m_box + self.m_l1 + self.m_soc

    @property
    def n_soc(self) -> int:
        return len(self.soc_dims)

    @property
    def soc_uniform(self) -> bool:
        """True when every SOC block has the same dimension."""
        return len(set(self.soc_dims)) <= 1

    def validate(self, m: int) -> None:
        if self.m != m:
            raise ValueError(
                f"ConeSpec covers {self.m} rows but A has {m} rows")


@dataclasses.dataclass(frozen=True)
class QPData:
    """Problem data as tensors; ±inf bounds are allowed on box rows."""

    P: torch.Tensor
    q: torch.Tensor
    A: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor
    lam: torch.Tensor
    cone: ConeSpec

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    @property
    def dtype(self) -> torch.dtype:
        return self.P.dtype

    @property
    def device(self) -> torch.device:
        return self.P.device

    def _map(self, fn) -> "QPData":
        return QPData(P=fn(self.P), q=fn(self.q), A=fn(self.A),
                      l=fn(self.l), u=fn(self.u), lam=fn(self.lam),
                      cone=self.cone)

    def astype(self, dtype: torch.dtype) -> "QPData":
        return self._map(lambda t: t.to(dtype))

    def to(self, device) -> "QPData":
        return self._map(lambda t: t.to(device))


def make_qp(P, q, A, l, u, cone: ConeSpec | None = None, lam=None,
            dtype: torch.dtype | None = None, device=None) -> QPData:
    """Build a QPData, defaulting to an all-box cone layout.

    Symmetrises P. The dtype is P's unless given; `lam` defaults to
    zeros(m_l1). With device=None a tensor P keeps its device, and
    other inputs (numpy arrays, lists) go to the CUDA card, as the
    model builders do: with no card that raises. Pass device="cpu" to
    build on the CPU.
    """
    if device is None and not isinstance(P, torch.Tensor):
        device = torch.device("cuda")
    P = torch.as_tensor(P, dtype=dtype, device=device)
    dtype, device = P.dtype, P.device
    q, A, l, u = (torch.as_tensor(t, dtype=dtype, device=device)
                  for t in (q, A, l, u))
    m = A.shape[-2]
    if cone is None:
        cone = ConeSpec(m_box=m)
    cone.validate(m)
    if lam is None:
        lam = torch.zeros(A.shape[:-2] + (cone.m_l1,), dtype=dtype,
                          device=device)
    else:
        lam = torch.as_tensor(lam, dtype=dtype, device=device)
    P = 0.5 * (P + P.transpose(-1, -2))
    return QPData(P=P, q=q, A=A, l=l, u=u, lam=lam, cone=cone)


def qp_from_numpy(arrays: Mapping[str, np.ndarray], cone: ConeSpec,
                  device, dtype: torch.dtype | None = None) -> QPData:
    """QPData from numpy arrays under the keys P, q, A, l, u, lam.

    Carries problem data built elsewhere (e.g. by the JAX package)
    across unchanged: no symmetrisation, and the arrays' own dtype
    unless `dtype` is given.
    """
    def conv(key):
        t = torch.from_numpy(np.array(arrays[key]))
        return t.to(device=device, dtype=dtype or t.dtype)

    qp = QPData(P=conv("P"), q=conv("q"), A=conv("A"), l=conv("l"),
                u=conv("u"), lam=conv("lam"), cone=cone)
    cone.validate(qp.m)
    return qp


def is_equality_row(qp: QPData) -> torch.Tensor:
    """Boolean mask of box rows with l == u (finite): OSQP boosts rho
    on these rows."""
    eq = (qp.l == qp.u) & torch.isfinite(qp.l)
    idx = torch.arange(qp.m, device=qp.l.device)
    return eq & (idx < qp.cone.m_box)


def mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M v for each row of v (..., c): one shared M (r, c), one M per
    lane, (B, r, c) against v (B, c), or one M per block shared by
    leading scenario dimensions, (S, r, c) against v (..., S, c)."""
    if M.dim() == 2:
        return v @ M.mT
    if v.dim() > M.dim() - 1:
        return _per_block(lambda Mb, vb: vb @ Mb.mT, M, v)
    return (M @ v[..., None])[..., 0]


def vm(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """vᵀ M for each row of v (..., r), with M shaped as in `mv`."""
    if M.dim() == 2:
        return v @ M
    if v.dim() > M.dim() - 1:
        return _per_block(lambda Mb, vb: vb @ Mb, M, v)
    return (v[..., None, :] @ M)[..., 0, :]


def _per_block(prod, M, v):
    """prod per block, each block's rows of every scenario at once: v
    (..., S, k) folds to (S, K, k) against M (S, ·, ·), one batched
    product instead of M broadcast over the scenarios."""
    lead = v.shape[:-2]
    S, k = v.shape[-2:]
    vb = v.reshape(-1, S, k).transpose(0, 1)
    out = prod(M, vb)
    return out.transpose(0, 1).reshape(lead + (S, out.shape[-1]))


def objective(qp: QPData, x: torch.Tensor, z: torch.Tensor | None = None):
    """Objective ½xᵀPx + qᵀx + Σ λ|z_l1| (z supplies the L1 term)."""
    quad = 0.5 * (vm(x, qp.P) * x).sum(-1)
    lin = (qp.q * x).sum(-1)
    if qp.cone.m_l1 > 0:
        w = z if z is not None else mv(qp.A, x)
        sl = w[..., qp.cone.m_box:qp.cone.m_box + qp.cone.m_l1]
        return quad + lin + (qp.lam * sl.abs()).sum(-1)
    return quad + lin
