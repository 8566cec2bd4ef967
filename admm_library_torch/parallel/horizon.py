"""Horizon-sharded ADMM with an exact distributed SPIKE x-update.

The multi-rank companion of the 'spike' KKT backend (ops/spike.py): one
long-horizon MPC problem, or a scenario batch of them, with variables,
constraint rows and the block-tridiagonal KKT system split along the
TIME axis over a (data, horizon) mesh (parallel/runtime.make_mesh) —
the layout of parallel/consensus_mc.py, but without the consensus
reformulation: the x-update solves the whole condensed system exactly
across ranks, so the iterates (and the iteration count) are those of
the unpartitioned solver.

Traffic per iteration along 'horizon':
  x-update   one neighbour exchange (the next part's first block of g)
             and one all_gather of the reduced interface right-hand
             side ((B_loc, parts, b)); every rank then solves the small
             separator system itself, the same on every rank.
  products   one neighbour exchange each way (A x needs the previous
             part's last state block; Aᵀy returns the next part's first
             rows).
Per check: a max over 'horizon' for the residuals, sums over 'data' for
the shared rho; the loop over checks is `graph.CheckLoop.run_checks`
(on the card one WHILE node over the checks and refactors, with no host
read; on a mesh with an axis > 1 one agreed read of the loop and
refactor flags a check).

Scope: box + L1 + uniform-SOC cones laid out [box | L1 | SOC] per part
with the same per-type counts in every part (box and L1 rows padded with
free rows; SOC blocks time-local, of one dimension, the same count per
part), P diagonal, P and A shared across scenarios, precision 'single'
or 'double'. The driver has no Ruiz scaling, restart averaging, stall
exit or hybrid staging: its job is the horizon-split program, held to
solve_batch_shared's iterates with those off.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import graph
from ..ops import banded as banded_ops
from ..ops.kkt import cholesky_or_nan
from ..ops.prox import project_cone
from ..problem import ConeSpec, QPData, mv, vm
from ..settings import Settings
from ..solution import Status
from . import runtime
from .consensus import Local, _neighbor_next, _neighbor_prev, _pmax
from .runtime import DATA_AXIS, HORIZON_AXIS, Mesh

_UNSOLVED = int(Status.UNSOLVED)
_SOLVED = int(Status.SOLVED)


@dataclasses.dataclass(frozen=True)
class HorizonSpec:
    """Static layout of the horizon-partitioned problem.

    parts  time partitions (each owns Np = N/parts variable blocks)
    b      variable block size (band_block of the source MPC)
    npb    Np * b variables per part
    mp     padded constraint rows per part
    cone   per-part cone layout [box | L1 | SOC], the same in every
           part (padded with free rows)
    """

    parts: int
    b: int
    npb: int
    mp: int
    cone: ConeSpec = ConeSpec()

    @property
    def ni(self) -> int:
        return self.npb - self.b


class HorizonParts(NamedTuple):
    """Partitioned problem data (leading axis = parts).

    A_loc  (parts, mp, npb)  rows of part p against part p's variables
    A_halo (parts, mp, b)    rows of part p against part p-1's LAST
                             variable block (zero for p = 0)
    P_diag (parts, npb)      diagonal objective (the MPC family's P)
    q      (parts, npb)
    l, u   ([B,] parts, mp)  bounds (scenario batch optional)
    lam    (parts, ml_loc)   per-part L1 weights (0 on padded rows)
    """

    A_loc: torch.Tensor
    A_halo: torch.Tensor
    P_diag: torch.Tensor
    q: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor
    lam: torch.Tensor


def _host64(t):
    return np.asarray(torch.as_tensor(t).detach().cpu().double().numpy())


def partition_qp(qp: QPData, b: int, parts: int, row_time):
    """Slice a banded MPC-family QP into HorizonParts (host numpy, f64).

    qp: P diagonal (checked), A (m, n), l/u possibly scenario-batched
    (B, m). row_time: (m,) ints mapping each constraint row to a time
    step in [0, N); rows are grouped into parts of Np consecutive steps
    and padded with free rows (A = 0, bounds ±inf) to a common per-part
    count. Every row's support must lie inside its part's variables
    plus the previous part's last block (the banded property), and a
    row that reaches the previous part may touch only the part's first
    block (the SPIKE factor keeps only that coupling).

    Each part's rows are laid out [box | L1 | SOC] with the same
    per-type counts in every part: box and L1 segments pad with free
    rows (±inf bounds, lam = 0: both proxes are the identity there);
    SOC blocks must lie wholly inside a part, be of one dimension and
    have the same count in every part.

    Returns (HorizonParts on qp's device in qp's dtype, HorizonSpec);
    HorizonSpec.cone carries the shared per-part ConeSpec.
    """
    A = _host64(qp.A)
    Pd_full = _host64(qp.P)
    if not np.allclose(Pd_full, np.diag(np.diag(Pd_full))):
        raise ValueError("partition_qp supports diagonal-P MPC problems")
    Pd_full = np.diag(Pd_full)
    q = _host64(qp.q)
    l = _host64(qp.l)
    u = _host64(qp.u)
    lam = _host64(qp.lam)
    cone = qp.cone
    mb_g, ml_g = cone.m_box, cone.m_l1
    m, n = A.shape
    N = n // b
    if N % parts or N // parts < 2:
        raise ValueError(f"{N} blocks not partitionable into {parts}")
    Np = N // parts
    npb = Np * b
    row_time = np.asarray(row_time)
    row_part = row_time // Np

    # --- per-part row sets, split by cone segment ---
    ridx = np.arange(m)
    is_box = ridx < mb_g
    is_l1 = (ridx >= mb_g) & (ridx < mb_g + ml_g)
    if cone.m_soc:
        if not cone.soc_uniform:
            raise ValueError("horizon partition needs uniform SOC dims")
        d = cone.soc_dims[0]
        blk_part = row_part[mb_g + ml_g::d]
        # Every SOC block must sit wholly inside one part.
        for kblk in range(cone.n_soc):
            rows_b = row_part[mb_g + ml_g + kblk * d:
                              mb_g + ml_g + (kblk + 1) * d]
            if len(set(rows_b.tolist())) != 1:
                raise ValueError(f"SOC block {kblk} straddles parts")
    box_rows = [np.nonzero(is_box & (row_part == p))[0]
                for p in range(parts)]
    l1_rows = [np.nonzero(is_l1 & (row_part == p))[0]
               for p in range(parts)]
    if cone.m_soc:
        soc_blocks = [np.nonzero(blk_part == p)[0] for p in range(parts)]
        n_soc_loc = len(soc_blocks[0])
        if any(len(sb) != n_soc_loc for sb in soc_blocks):
            raise ValueError(
                "per-part SOC block counts differ — pad the model or "
                "choose a partition aligned with the cone layout")
        soc_rows = [np.concatenate(
            [mb_g + ml_g + kblk * d + np.arange(d) for kblk in sb])
            if len(sb) else np.zeros(0, np.int64) for sb in soc_blocks]
        msoc_loc = n_soc_loc * d
    else:
        d, n_soc_loc, msoc_loc = 0, 0, 0
        soc_rows = [np.zeros(0, np.int64) for _ in range(parts)]
    mb_loc = max(len(r) for r in box_rows)
    ml_loc = max(len(r) for r in l1_rows) if ml_g else 0
    mp = mb_loc + ml_loc + msoc_loc
    cone_loc = ConeSpec(m_box=mb_loc, m_l1=ml_loc,
                        soc_dims=(d,) * n_soc_loc)

    batched = l.ndim == 2
    B = l.shape[0] if batched else 1
    A_loc = np.zeros((parts, mp, npb))
    A_halo = np.zeros((parts, mp, b))
    l_p = np.full((B, parts, mp), -np.inf)
    u_p = np.full((B, parts, mp), np.inf)
    lam_p = np.zeros((parts, ml_loc))
    l2 = l if batched else l[None]
    u2 = u if batched else u[None]
    for p in range(parts):
        # Per-part layout [box(pad) | L1(pad) | SOC]; global row order
        # within each segment is preserved.
        segs = [(box_rows[p], 0), (l1_rows[p], mb_loc),
                (soc_rows[p], mb_loc + ml_loc)]
        rows = np.concatenate([r for r, _ in segs]).astype(np.int64)
        dest = np.concatenate(
            [off + np.arange(len(r)) for r, off in segs]).astype(np.int64)
        c0 = p * npb
        Ap = A[rows]
        # Banded support check: nothing outside [c0 - b, c0 + npb).
        out = np.abs(Ap).sum(0)
        lo = max(c0 - b, 0)
        if out[:lo].sum() > 0 or out[c0 + npb:].sum() > 0:
            raise ValueError(f"part {p}: rows reach outside the band")
        A_loc[p, dest] = Ap[:, c0:c0 + npb]
        if p > 0:
            A_halo[p, dest] = Ap[:, c0 - b:c0]
            # The SPIKE factor keeps the cross-part coupling only on the
            # part's first variable block: a halo row reaching further
            # would silently lose coupling.
            halo_rows = np.abs(Ap[:, c0 - b:c0]).sum(1) > 0
            beyond = np.abs(Ap[:, c0 + b:c0 + npb]).sum(1)
            if halo_rows.any() and (beyond[halo_rows] > 0).any():
                raise ValueError(
                    f"part {p}: halo rows reach past the first "
                    "variable block — unsupported coupling pattern")
        l_p[:, p, dest] = l2[:, rows]
        u_p[:, p, dest] = u2[:, rows]
        if len(l1_rows[p]):
            lam_p[p, :len(l1_rows[p])] = lam[l1_rows[p] - mb_g]
    if not batched:
        l_p, u_p = l_p[0], u_p[0]

    def out_t(a):
        return torch.tensor(a, dtype=qp.dtype, device=qp.device)

    hp = HorizonParts(
        A_loc=out_t(A_loc), A_halo=out_t(A_halo),
        P_diag=out_t(Pd_full.reshape(parts, npb)),
        q=out_t(q.reshape(parts, npb)), l=out_t(l_p), u=out_t(u_p),
        lam=out_t(lam_p))
    return hp, HorizonSpec(parts=parts, b=b, npb=npb, mp=mp, cone=cone_loc)


def mpc_row_time(N: int, ns: int, nu: int):
    """Row -> time map of the double-integrator MPC layout
    (models/double_integrator.py: N*ns dynamics rows by step, ns
    terminal rows at step N-1, N*nu control rows by step)."""
    return np.concatenate([
        np.repeat(np.arange(N), ns),
        np.full(ns, N - 1),
        np.repeat(np.arange(N), nu)])


def lt_row_time(N: int):
    """Row -> time map of the low-thrust SOCP layout (models/
    low_thrust.py: N*6 dynamics rows by step, 6 terminal rows at step
    N-1, N Gamma-bound rows by step, N SOC(4) blocks by step)."""
    return np.concatenate([
        np.repeat(np.arange(N), 6),
        np.full(6, N - 1),
        np.arange(N),
        np.repeat(np.arange(N), 4)])


def cw_sparse_row_time(N: int):
    """Row -> time map of the banded CW min-fuel transcription
    (models/clohessy_wiltshire.build_cw_rendezvous_sparse: N*6 dynamics
    rows by step, 6 terminal rows at step N-1, N*3 L1 impulse rows by
    step)."""
    return np.concatenate([
        np.repeat(np.arange(N), 6),
        np.full(6, N - 1),
        np.repeat(np.arange(N), 3)])


# ---------------------------------------------------------------------
# Distributed SPIKE factor and solve (ops/spike.py with the part axis
# split between ranks): the interior eliminations are rank-local batched
# products; only the separator system is global (an all_gather and the
# same small solve on every rank).
# ---------------------------------------------------------------------


def _spike_factor_sharded(Mpp, E, spec: HorizonSpec, loc: Local):
    """Mpp (S, npb, npb) this rank's part-diagonal blocks, E (S, b, b)
    the coupling of each part's first row block to the PREVIOUS part's
    separator (zero on part 0). Returns the rank-local factor pieces;
    `E_next` is the next part's E (cyclic: the last part masks it)."""
    S = Mpp.shape[0]
    ni, b = spec.ni, spec.b
    A_int = Mpp[:, :ni, :ni]
    Bl = Mpp[:, ni:, ni - b:ni]
    Dsep = Mpp[:, ni:, ni:]
    L = cholesky_or_nan(A_int)
    eye = torch.eye(ni, dtype=Mpp.dtype, device=Mpp.device).expand(L.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Ainv = Linv.mT @ Linv
    V = Ainv[:, :, :b] @ E
    W = Ainv[:, :, ni - b:] @ Bl.mT
    Vf, Vl = V[:, :b, :], V[:, ni - b:, :]

    def next_part(t):
        # The neighbour helpers shift along dim -2: flatten (b, b) first.
        return _neighbor_next(t.reshape(S, b * b), loc).reshape(S, b, b)

    return {"Ainv": Ainv, "V": V, "W": W, "Bl": Bl, "E": E,
            "E_next": next_part(E),
            "Td_part": Dsep - Bl @ W[:, ni - b:],
            "EtVf_next": next_part(E.mT @ Vf),
            "Tl_loc": -(Bl @ Vl)}                     # valid for p >= 1


def _spike_reduce_factor(fac, loc: Local):
    """Assemble and factor the separator system, the same on every rank:
    Td[p] -= EtVf of part p+1; Tl[p-1] = Tl_loc[p] for p >= 1."""
    is_last = loc.is_last[:, :, None]
    Td = fac["Td_part"] - torch.where(is_last, 0.0, fac["EtVf_next"])
    Td_all = runtime.all_gather(Td, loc.mesh, HORIZON_AXIS)
    Tl_all = runtime.all_gather(fac["Tl_loc"], loc.mesh, HORIZON_AXIS)[1:]
    Tld, Tll = banded_ops.block_tridiag_cholesky(Td_all, Tl_all)
    return {"Tld": Tld, "Tll": Tll}


def _spike_solve_sharded(fac, rhs, loc: Local, spec: HorizonSpec):
    """rhs (B, S, npb) rank-local; returns x of the same shape. One
    neighbour exchange and one all_gather along 'horizon'; the separator
    solve is the same on every rank."""
    ni, b = spec.ni, spec.b
    ru, rs = rhs[..., :ni], rhs[..., ni:]
    g = mv(fac["Ainv"], ru)
    gf_next = _neighbor_next(g[..., :b], loc)               # (B, S, b)
    rs_t = (rs - mv(fac["Bl"], g[..., ni - b:])
            - torch.where(loc.is_last, 0.0, vm(gf_next, fac["E_next"])))
    rs_all = runtime.all_gather(rs_t, loc.mesh, HORIZON_AXIS, dim=-2)
    lead = rs_all.shape[:-2]
    s_all = banded_ops.block_tridiag_solve(
        fac["Tld"], fac["Tll"], rs_all.reshape(lead + (spec.parts * b,)))
    s_all = s_all.reshape(lead + (spec.parts, b))
    s_prev_all = torch.cat([torch.zeros_like(s_all[..., :1, :]),
                            s_all[..., :-1, :]], dim=-2)
    s = s_all.index_select(-2, loc.block_ids)
    s_prev = s_prev_all.index_select(-2, loc.block_ids)
    u = g - mv(fac["V"], s_prev) - mv(fac["W"], s)
    return torch.cat([u, s], dim=-1)


class HorizonSolution(NamedTuple):
    """x (B, parts, npb), z and y (B, parts, mp); per-scenario status,
    iters and residuals (B,); rho the shared penalty."""

    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    rho: torch.Tensor


def _rho_vec(rb, eq, soc_rows, settings: Settings, cone: ConeSpec):
    """Per-row penalties: boosted on equality rows and, with
    rho_soc_scale != 1, on SOC rows."""
    rv = torch.where(eq, settings.rho_eq_scale * rb, rb)
    if cone.m_soc and settings.rho_soc_scale != 1.0:
        rv = torch.where(soc_rows, settings.rho_soc_scale * rb, rv)
    return rv


def _spmv_A(hp: HorizonParts, loc: Local, ni: int, x):
    """A x with the halo term: x (B, S, npb) -> (B, S, mp)."""
    x_last_prev = _neighbor_prev(x[..., ni:], loc)
    halo = mv(hp.A_halo, x_last_prev)
    return mv(hp.A_loc, x) + torch.where(loc.is_first, 0.0, halo)


def _spmv_At(hp: HorizonParts, loc: Local, ni: int, v):
    """Aᵀ v scattered back onto x: v (B, S, mp) -> (B, S, npb)."""
    mine = vm(v, hp.A_halo)                             # (B, S, b)
    from_next = _neighbor_next(torch.where(loc.is_first, 0.0, mine), loc)
    from_next = torch.where(loc.is_last, 0.0, from_next)
    out = vm(v, hp.A_loc)
    return torch.cat([out[..., :ni], out[..., ni:] + from_next], dim=-1)


def _linf_scen(loc: Local, *vs):
    """Per-scenario inf-norms of each v over (parts, rows), reduced over
    'horizon' (one collective)."""
    return _pmax(torch.stack([v.abs().amax(dim=(-2, -1)) for v in vs]), loc)


def horizon_check(state, variant, *, spec: HorizonSpec, settings: Settings,
                  mesh: Mesh):
    """One residual check of `_run_horizon`: check_every iterations of
    the distributed-SPIKE ADMM with finished scenarios frozen, the
    per-scenario residuals and status and, in the rho-test variant
    (`variant[1]`; the driver has no restart), the shared rho from the
    still-active scenarios' geometric mean. Returns the state entries it
    changes; 'flags' holds (any scenario UNSOLVED, refactor) as int32,
    agreed over the ranks by the host."""
    _, rho_test = variant
    hp = HorizonParts(**state["hp"])
    loc = Local(mesh=mesh, block_ids=state["block_ids"],
                n_blocks=spec.parts)
    fac = state["fac"]
    ni = spec.ni
    sigma, alpha = settings.sigma, settings.alpha
    cone = spec.cone
    mb_loc, ml_loc = cone.m_box, cone.m_l1
    tiny = torch.finfo(hp.q.dtype).tiny
    k = settings.check_every

    def body_iter(x, z, y, rho_vec):
        rhs = sigma * x - hp.q + _spmv_At(hp, loc, ni, rho_vec * z - y)
        xt = _spike_solve_sharded(fac, rhs, loc, spec)
        zt = _spmv_A(hp, loc, ni, xt)
        x_new = alpha * xt + (1.0 - alpha) * x
        w = alpha * zt + (1.0 - alpha) * z
        v = w + y / rho_vec
        lam_r = (hp.lam / rho_vec[..., mb_loc:mb_loc + ml_loc]
                 if ml_loc else hp.lam)
        z_new = project_cone(v, hp.l, hp.u, lam_r, cone)
        y_new = y + rho_vec * (w - z_new)
        return x_new, z_new, y_new

    def residuals(x, z, y):
        Ax = _spmv_A(hp, loc, ni, x)
        Px = hp.P_diag * x
        Aty = _spmv_At(hp, loc, ni, y)
        return tuple(_linf_scen(loc, Ax - z, Px + hp.q + Aty, Ax, z, Px,
                                Aty)) + (state["nq"],)

    rho_bar, status = state["rho_bar"], state["status"]
    rho_vec = _rho_vec(rho_bar, state["eq"], state["soc_rows"], settings,
                       cone)
    active = status == _UNSOLVED
    x, z, y = state["x"], state["z"], state["y"]
    xn, zn, yn = x, z, y
    for _ in range(k):
        xn, zn, yn = body_iter(xn, zn, yn, rho_vec)
    am = active[:, None, None]
    x, z, y = (torch.where(am, a, o) for a, o in ((xn, x), (zn, z), (yn, y)))
    iters = state["iters"] + active.to(torch.int32) * k

    rp_n, rd_n, nAx, nz, nPx, nAty, nq_ = residuals(x, z, y)
    eps_p = settings.eps_abs + settings.eps_rel * torch.maximum(nAx, nz)
    eps_d = settings.eps_abs + settings.eps_rel * torch.maximum(
        torch.maximum(nPx, nAty), nq_)
    solved = (rp_n <= eps_p) & (rd_n <= eps_d)
    numerr = ~(torch.isfinite(rp_n) & torch.isfinite(rd_n))
    status = torch.where(
        active,
        torch.where(numerr, int(Status.NUMERICAL_ERROR),
                    torch.where(solved, _SOLVED, _UNSOLVED)),
        status).to(torch.int32)
    r_p = torch.where(active, rp_n, state["r_prim"])
    r_d = torch.where(active, rd_n, state["r_dual"])

    still = status == _UNSOLVED
    do = torch.zeros((), dtype=torch.bool, device=x.device)
    new_rho = state["new_rho"]
    if rho_test:
        sp = r_p / torch.clamp(torch.maximum(nAx, nz), min=tiny)
        sd = r_d / torch.clamp(
            torch.maximum(torch.maximum(nPx, nAty), nq_), min=tiny)
        logr = torch.where(still, torch.log(torch.sqrt(
            torch.clamp(sp, min=tiny) / torch.clamp(sd, min=tiny))), 0.0)
        tot = runtime.psum(logr.sum(), mesh, DATA_AXIS)
        cnt = runtime.psum(still.sum(), mesh, DATA_AXIS)
        ratio = torch.exp(tot / torch.clamp(cnt, min=1))
        new_rho = torch.clamp(rho_bar * ratio, settings.rho_min,
                              settings.rho_max)
        tol = settings.adaptive_rho_tol
        do = ((ratio > tol) | (ratio < 1.0 / tol)) & (cnt > 0)
    return dict(x=x, z=z, y=y, iters=iters, status=status, r_prim=r_p,
                r_dual=r_d, new_rho=new_rho, it=state["it"] + k,
                flags=torch.stack([still.any(), do]).to(torch.int32))


def horizon_factor(hp: HorizonParts, rb, eq, soc_rows, settings: Settings,
                   spec: HorizonSpec, loc: Local):
    """The distributed-SPIKE factor of rho-bar `rb`: this rank's interior
    Cholesky factors and the reduced separator system."""
    dtype, dev = hp.q.dtype, hp.q.device
    S = hp.q.shape[0]
    ni, b, npb = spec.ni, spec.b, spec.npb
    rv = _rho_vec(rb, eq, soc_rows, settings, spec.cone)
    Mpp = (hp.A_loc.mT @ (rv[..., None] * hp.A_loc)
           + settings.sigma * torch.eye(npb, dtype=dtype, device=dev)
           + torch.diag_embed(hp.P_diag))
    # The next part's A_haloᵀ ρ A_halo lands on OUR separator block.
    corner = _neighbor_next(
        (hp.A_halo.mT @ (rv[..., None] * hp.A_halo)).reshape(S, b * b),
        loc).reshape(S, b, b)
    Mpp[:, ni:, ni:] += torch.where(loc.is_last[:, :, None], 0.0, corner)
    # E couples OUR first variable block to the previous part's
    # separator: A_locᵀ ρ A_halo (partition_qp keeps it inside the first
    # b variable rows).
    E = (hp.A_loc.mT @ (rv[..., None] * hp.A_halo))[:, :b, :]
    E = torch.where(loc.is_first[:, :, None], 0.0, E)
    fac = _spike_factor_sharded(Mpp, E, spec, loc)
    return {**fac, **_spike_reduce_factor(fac, loc)}


def horizon_step(state, variant, *, spec: HorizonSpec, settings: Settings,
                 mesh: Mesh):
    """A segment of `_run_horizon`'s loop: REFACTOR (rho-bar takes the
    last check's proposal, and `horizon_factor` its factor), or the check
    `variant` (`horizon_check`)."""
    if variant != graph.REFACTOR:
        return horizon_check(state, variant, spec=spec, settings=settings,
                             mesh=mesh)
    loc = Local(mesh=mesh, block_ids=state["block_ids"],
                n_blocks=spec.parts)
    rho_bar = state["new_rho"]
    return dict(rho_bar=rho_bar, fac=horizon_factor(
        HorizonParts(**state["hp"]), rho_bar, state["eq"],
        state["soc_rows"], settings, spec, loc))


def _run_horizon(hp: HorizonParts, spec: HorizonSpec, settings: Settings,
                 loc: Local, x0, z0, y0):
    """Rank-local driver: a lockstep loop over residual checks
    (`horizon_check`) and refactors (`horizon_step`'s REFACTOR: the
    interior Cholesky factors and the separator system),
    `graph.CheckLoop.run_checks`: on the card, for the 'spike' x-update,
    one CUDA graph whose WHILE node runs them where `graph.capturable`
    allows, else the host loop that reads one agreed flag tensor a
    check.

    hp holds this rank's parts, with l/u (B_loc, S, mp). Plain ADMM as
    parallel.batch.run_admm_batch_shared's core loop (x-solve, relax,
    prox, dual update, per-scenario freezing, shared adaptive rho) with
    the x-solve distributed. Every residual is reduced over 'horizon',
    so the ranks of a data row take the same decisions; the loop and
    refactor flags are agreed over every rank.
    """
    dtype, dev = hp.q.dtype, hp.q.device
    mp = spec.mp
    B_loc = x0.shape[0]
    cone = spec.cone
    mb_loc, ml_loc = cone.m_box, cone.m_l1
    l0 = hp.l[0]
    row_idx = torch.arange(mp, device=dev)
    # Only box rows are equalities (cf. problem.is_equality_row).
    eq = (l0 == hp.u[0]) & torch.isfinite(l0) & (row_idx < mb_loc)
    is_soc_row = row_idx >= mb_loc + ml_loc

    nq = _linf_scen(loc, hp.q[None])[0]
    if ml_loc:
        # L1 gradient scale in the dual-norm reference (cf. core.admm.
        # l1_grad_scale_raw): max_j max_i lam_i |A[i, j]| over the L1
        # rows, whose column support is local + halo.
        sl = slice(mb_loc, mb_loc + ml_loc)
        lamA = torch.maximum(
            (hp.lam[:, :, None] * hp.A_loc[:, sl, :].abs()).amax(),
            (hp.lam[:, :, None] * hp.A_halo[:, sl, :].abs()).amax())
        nq = torch.maximum(nq, _pmax(lamA, loc))

    rho_bar = torch.tensor(settings.rho, dtype=dtype, device=dev)
    big = torch.full((B_loc,), float("inf"), dtype=dtype, device=dev)
    state = dict(hp=hp._asdict(),
                 fac=horizon_factor(hp, rho_bar, eq, is_soc_row, settings,
                                    spec, loc),
                 eq=eq, soc_rows=is_soc_row, block_ids=loc.block_ids, nq=nq,
                 x=x0, z=z0, y=y0, rho_bar=rho_bar, new_rho=rho_bar,
                 it=torch.zeros((), dtype=torch.int64, device=dev),
                 iters=torch.zeros(B_loc, dtype=torch.int32, device=dev),
                 status=torch.full((B_loc,), _UNSOLVED, dtype=torch.int32,
                                   device=dev),
                 r_prim=big, r_dual=big,
                 flags=torch.ones(2, dtype=torch.int32, device=dev))
    mesh = loc.mesh
    step = functools.partial(horizon_step, spec=spec, settings=settings,
                             mesh=mesh)
    # The key holds plain values (cf. consensus.loop_static).
    loop = graph.CheckLoop(
        "run_horizon", step, state, settings, "spike", mesh=mesh,
        spec=spec, block_ids=tuple(loc.block_ids.tolist()),
        mesh_shape=tuple(sorted(mesh.shape.items())),
        mesh_coords=tuple(sorted(mesh.coords.items())))
    # flags: (liveness of any scenario on any rank, the shared refactor
    # decision), agreed over every rank by the plain loop.
    loop.run_checks(settings, 0,
                    agree=functools.partial(runtime.agree, mesh=mesh))
    x, z, y, status, iters, r_p, r_d, rho_bar = loop.result(
        "x", "z", "y", "status", "iters", "r_prim", "r_dual", "rho_bar")
    status = torch.where(status == _UNSOLVED, int(Status.MAX_ITER),
                         status).to(torch.int32)
    return x, z, y, status, iters, r_p, r_d, rho_bar


def solve_horizon_sharded(hp: HorizonParts, spec: HorizonSpec, mesh: Mesh,
                          settings: Settings = Settings()
                          ) -> HorizonSolution:
    """Solve the horizon-partitioned problem over a (data, horizon) mesh.

    hp.l/hp.u must be scenario-batched (B, parts, mp); B must divide by
    the data axis and parts by the horizon axis. Every rank passes the
    whole problem, solves its scenarios' parts on mesh.device and gets
    the gathered solution. Precision follows settings.precision:
    'double' runs in f64, anything else in f32 (the hybrid staging
    lives in the unpartitioned drivers).
    """
    if hp.l.dim() != 3:
        raise ValueError("hp must be scenario-batched: l/u (B, parts, mp)")
    B = hp.l.shape[0]
    nd, nh = mesh.shape[DATA_AXIS], mesh.shape[HORIZON_AXIS]
    if B % nd or spec.parts % nh:
        raise ValueError(
            f"batch {B} x parts {spec.parts} not divisible by mesh "
            f"({nd} x {nh})")
    dtype = (torch.float64 if settings.precision == "double"
             else torch.float32)
    dev = mesh.device
    S, Bl = spec.parts // nh, B // nd
    h, d = mesh.coords[HORIZON_AXIS], mesh.coords[DATA_AXIS]
    blk = slice(h * S, (h + 1) * S)
    scn = slice(d * Bl, (d + 1) * Bl)
    loc = Local(mesh=mesh, n_blocks=spec.parts,
                block_ids=torch.arange(h * S, (h + 1) * S, device=dev))

    def mine(t, *idx):
        return t[idx].to(device=dev, dtype=dtype)

    hp_loc = HorizonParts(
        A_loc=mine(hp.A_loc, blk), A_halo=mine(hp.A_halo, blk),
        P_diag=mine(hp.P_diag, blk), q=mine(hp.q, blk),
        l=mine(hp.l, scn, blk), u=mine(hp.u, scn, blk),
        lam=mine(hp.lam, blk))

    def zeros(width):
        return torch.zeros((Bl, S, width), dtype=dtype, device=dev)

    x, z, y, status, iters, r_p, r_d, rho = _run_horizon(
        hp_loc, spec, settings, loc, zeros(spec.npb), zeros(spec.mp),
        zeros(spec.mp))

    def gather(t):
        t = runtime.all_gather(t, mesh, HORIZON_AXIS, dim=1)
        return runtime.all_gather(t, mesh, DATA_AXIS, dim=0)

    per_scen = [runtime.all_gather(t, mesh, DATA_AXIS, dim=0)
                for t in (status, iters, r_p, r_d)]
    return HorizonSolution(gather(x), gather(z), gather(y), *per_scen, rho)
