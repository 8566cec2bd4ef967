"""Consensus ADMM over time-partitioned horizon blocks.

The horizon [0, N) is split into B contiguous blocks; each block owns
its segment's controls and states plus a DUPLICATED copy of its left
boundary state, and the duplicates are forced to agree through the ADMM
z-update. The constraint matrix stays block-local: each block's rows are

    [ local rows (box/L1/SOC) | left-edge rows (ns) | right-edge rows (ns) ]

where the edge rows read the boundary-copy variables. The agreement
z_i^R == z_{i+1}^L is the indicator of a linear subspace whose Euclidean
projection is the pairwise average of the two copies, evaluated with one
neighbour exchange per direction per iteration. So:

  * the x-update matrix M_b = P_b + σI + A_bᵀ ρ A_b is block diagonal
    across the mesh: each rank factors and solves only its own blocks;
  * per iteration the ranks exchange two ns-sized edge slices
    (runtime.ring_shift), and per check a few scalar max reductions;
  * both sides of a pair compute 0.5·(a + b) from the same two values,
    so the duplicated copies of z stay bitwise equal.

Block 0's left-edge rows are an equality to s0 and block B-1's right-edge
rows an equality to s_target, selected by masks, so every block runs the
same program.

Every rank holds the global problem and keeps its slice of blocks along
the mesh's horizon axis; the solution is gathered back to every rank.
The loop over checks is `graph.CheckLoop.run_checks`, as
parallel.batch.run_admm_batch_shared's: on the card (a 1x1 mesh) one
WHILE node runs the checks and the refactors with no host read; on a
mesh with an axis > 1 the host loop reads the device once per check
(status and the rho decision, agreed over every rank before the read).

Scaling: ONE block-shared Ruiz equilibration (core.scaling.
ruiz_equilibrate_blocks) with the left/right edge-row factors tied.
Residuals and termination use UNSCALED quantities. Hybrid precision runs
an f32 phase, then re-centred f32 rounds for box cones (the agreement
rows shift through a z-space offset) or a warm-started f64 phase for
L1 and SOC cones.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from ..core import admm, graph
from ..core.admm import l1_grad_scale_raw
from ..core.scaling import Scaling, ruiz_equilibrate_blocks, scale_qp_blocks
from ..ops import kkt
from ..ops.prox import project_cone
from ..precision import clean64
from ..problem import ConeSpec, QPData, mv, vm
from ..settings import Settings
from ..solution import Status
from . import runtime
from .runtime import HORIZON_AXIS, Mesh

_UNSOLVED = int(Status.UNSOLVED)
_SOLVED = int(Status.SOLVED)


@dataclasses.dataclass(frozen=True)
class ConsensusSpec:
    """Static layout of a block-partitioned consensus problem.

    Every block has the same shapes: nb local variables, mb = m_local +
    2*ns rows laid out [local | left-edge | right-edge]. `cone`
    describes the LOCAL rows only.
    """

    n_blocks: int
    nb: int                 # variables per block
    m_local: int            # local constraint rows per block
    ns: int                 # boundary state dimension
    cone: ConeSpec          # cone of the local rows

    @property
    def mb(self) -> int:
        return self.m_local + 2 * self.ns


class ConsensusSolution(NamedTuple):
    """Result of a consensus solve; x/z/y keep the (B, .) block layout
    (with a leading scenario axis for consensus_solve_mc) and are
    UNSCALED. history is the (slots, 3) residual ring buffer [(iter,
    r_prim, r_dual)] when settings.history > 0."""

    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    rho: torch.Tensor
    history: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Local:
    """This rank's share of a partitioned solve: the mesh, the global
    indices (S,) of its blocks along the horizon axis, and the (S, 1)
    masks of the global first and last block."""

    mesh: Mesh
    block_ids: torch.Tensor
    n_blocks: int
    is_first: torch.Tensor = dataclasses.field(init=False)
    is_last: torch.Tensor = dataclasses.field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "is_first", (self.block_ids == 0)[:, None])
        object.__setattr__(self, "is_last",
                           (self.block_ids == self.n_blocks - 1)[:, None])


def _neighbor_prev(v_edge, loc: Local):
    """Value of `v_edge` (..., S, ns) from the PREVIOUS block: slot 0
    receives the previous rank's last block (cyclic; block 0 masks the
    wrap)."""
    from_prev = runtime.ring_shift(v_edge[..., -1:, :], loc.mesh,
                                   HORIZON_AXIS, 1)
    return torch.cat([from_prev, v_edge[..., :-1, :]], dim=-2)


def _neighbor_next(v_edge, loc: Local):
    """Value of `v_edge` (..., S, ns) from the NEXT block."""
    from_next = runtime.ring_shift(v_edge[..., :1, :], loc.mesh,
                                   HORIZON_AXIS, -1)
    return torch.cat([v_edge[..., 1:, :], from_next], dim=-2)


def _pmax(v, loc: Local):
    return runtime.pmax(v, loc.mesh, HORIZON_AXIS)


def _linf_global(v, loc: Local):
    return _pmax(v.abs().amax(), loc)


def _linf_scen(v, loc: Local):
    """Per-scenario inf-norm: max over the trailing (blocks, rows) axes
    locally, then over the horizon axis."""
    return _pmax(v.abs().amax(dim=(-2, -1)), loc)


def _sum_scen(v, loc: Local):
    return runtime.psum(v.sum(dim=(-2, -1)), loc.mesh, HORIZON_AXIS)


def infeasibility_blocks(qp_blk: QPData, spec: ConsensusSpec,
                         settings: Settings, loc: Local, scaling_vecs,
                         dx, dy):
    """OSQP §3.4 infeasibility certificates for the block-partitioned
    problem. dx (..., S, nb) and dy (..., S, mb) are SCALED iterate
    deltas over a check interval; a leading scenario axis broadcasts,
    and the trailing (block, row) axes reduce locally and across the
    horizon axis, so every rank returns the same per-scenario verdicts.

    The block problem's constraint set is: local cones on local rows,
    equality bounds on the END edge rows, and the pairwise AGREEMENT
    subspace on interior edge rows. Certificate conditions:
      primal (ray dy):  ‖A_bᵀdy_b‖∞ ≈ 0 per block;
                        dy_R(b) + dy_L(b+1) ≈ 0 on agreement pairs
                        (the subspace's dual is its orthogonal
                        complement, the ANTI-diagonal);
                        support over local rows + end equalities < 0.
      dual (ray dx):    ‖P dx‖∞ ≈ 0; qᵀdx < 0;
                        (A dx) in the recession cone of local rows;
                        (A dx) = 0 on end equalities;
                        (A dx)_R(b) = (A dx)_L(b+1) on agreement pairs.
    """
    ml, ns = spec.m_local, spec.ns
    cone = spec.cone
    dtype = dx.dtype
    d_s, e_s, c_s = scaling_vecs
    einv = 1.0 / e_s
    cd_inv = 1.0 / (c_s * d_s)
    eps_pi = settings.eps_pinf
    eps_di = settings.eps_dinf
    tiny = torch.finfo(dtype).tiny
    mbl = cone.m_box + cone.m_l1
    is_first, is_last = loc.is_first, loc.is_last
    inf = float("inf")

    def count_bad(bad):
        return runtime.psum(bad.to(torch.int32).sum(dim=(-2, -1)),
                            loc.mesh, HORIZON_AXIS)

    # ---- primal infeasibility from dy ----
    dy_u = (e_s / c_s) * dy
    ndy = _linf_scen(dy_u, loc)
    dyn = dy_u / torch.clamp(ndy, min=tiny)[..., None, None]
    Aty = vm((c_s / e_s) * dyn, qp_blk.A) * cd_inv
    cond_A = _linf_scen(Aty, loc) <= eps_pi
    # Pair condition on agreement rows (masked on end blocks).
    pair = dyn[..., ml + ns:] + _neighbor_next(dyn[..., ml:ml + ns], loc)
    pair = torch.where(is_last, 0.0, pair)
    cond_pair = _linf_scen(pair, loc) <= eps_pi
    # Support: local box(+L1) rows + END equality edge rows.
    lu_l = qp_blk.l * einv
    lu_u = qp_blk.u * einv

    def support(rows_dyn, rows_l, rows_u, mask=None):
        up = torch.where(rows_dyn > eps_pi, torch.where(
            torch.isfinite(rows_u), rows_u * rows_dyn, inf), 0.0)
        lo = torch.where(rows_dyn < -eps_pi, torch.where(
            torch.isfinite(rows_l), rows_l * rows_dyn, inf), 0.0)
        val = up + lo if mask is None else torch.where(mask, up + lo, 0.0)
        return _sum_scen(val, loc)

    sup = support(dyn[..., :mbl], lu_l[..., :mbl], lu_u[..., :mbl])
    sup = sup + support(dyn[..., ml:ml + ns], lu_l[..., ml:ml + ns],
                        lu_u[..., ml:ml + ns], is_first)
    sup = sup + support(dyn[..., ml + ns:], lu_l[..., ml + ns:],
                        lu_u[..., ml + ns:], is_last)
    if cone.m_soc:
        blk = dyn[..., mbl:ml].reshape(dyn.shape[:-1]
                                       + (cone.n_soc, cone.soc_dims[0]))
        ok = (torch.linalg.vector_norm(blk[..., 1:], dim=-1)
              <= -blk[..., 0] + eps_pi)
        sup = torch.where(count_bad(~ok) > 0, inf, sup)
    pinf = (ndy > 0) & cond_A & cond_pair & (sup <= eps_pi)

    # ---- dual infeasibility from dx ----
    dx_u = d_s * dx
    ndx = _linf_scen(dx_u, loc)
    dxn = dx_u / torch.clamp(ndx, min=tiny)[..., None, None]
    Pdx = mv(qp_blk.P, dxn / d_s) * cd_inv
    cond_P = _linf_scen(Pdx, loc) <= eps_di
    Adx = einv * mv(qp_blk.A, dxn / d_s)
    qdx = _sum_scen((cd_inv * qp_blk.q) * dxn, loc)
    if cone.m_l1:
        sl = slice(cone.m_box, mbl)
        lam_u = qp_blk.lam * e_s[sl] / c_s
        qdx = qdx + _sum_scen(lam_u * Adx[..., sl].abs(), loc)
    cond_q = qdx <= -eps_di

    def recession_bad(rows_Adx, rows_l, rows_u, mask):
        ok_up = (rows_Adx <= eps_di) | ~torch.isfinite(rows_u)
        ok_lo = (rows_Adx >= -eps_di) | ~torch.isfinite(rows_l)
        return count_bad(mask & ~(ok_up & ok_lo))

    nbad = (recession_bad(Adx[..., :mbl], lu_l[..., :mbl], lu_u[..., :mbl],
                          True)
            + recession_bad(Adx[..., ml:ml + ns], lu_l[..., ml:ml + ns],
                            lu_u[..., ml:ml + ns], is_first)
            + recession_bad(Adx[..., ml + ns:], lu_l[..., ml + ns:],
                            lu_u[..., ml + ns:], is_last))
    dpair = Adx[..., ml + ns:] - _neighbor_next(Adx[..., ml:ml + ns], loc)
    dpair = torch.where(is_last, 0.0, dpair)
    cond_dpair = _linf_scen(dpair, loc) <= eps_di
    if cone.m_soc:
        blk = Adx[..., mbl:ml].reshape(Adx.shape[:-1]
                                       + (cone.n_soc, cone.soc_dims[0]))
        ok = (torch.linalg.vector_norm(blk[..., 1:], dim=-1)
              <= blk[..., 0] + eps_di)
        nbad = nbad + count_bad(~ok)
    dinf = (ndx > 0) & cond_P & cond_q & (nbad == 0) & cond_dpair
    return pinf, dinf


def consensus_body(qp_blk: QPData, spec: ConsensusSpec, settings: Settings,
                   loc: Local, fac, x, z, y, rho_vec, backend, z_off=None):
    """One consensus-ADMM iteration on this rank's S blocks.

    Iterates carry a local (S, .) layout, optionally with a leading
    scenario axis (B, S, .); the per-block data (P, A, q, factor,
    rho_vec) stay shared across scenarios (dispersions enter only l/u).

    z_off: optional (..., mb) SCALED re-centring offset. Local box rows
    shift through the bounds (the caller passes l/u already shifted);
    the agreement rows shift through this offset: the correction's
    consensus set is {z_c : z_c + off in agreement}, an affine subspace
    whose projection is avg((v + off) pairs) - off.
    """
    ml, ns = spec.m_local, spec.ns
    a = settings.alpha
    rhs = settings.sigma * x - qp_blk.q + vm(rho_vec * z - y, qp_blk.A)
    xt = kkt.solve_condensed(
        fac, rhs, backend, refine_steps=settings.refine_steps,
        cg_tol=settings.cg_tol, cg_max_iter=settings.cg_max_iter)
    zt = mv(qp_blk.A, xt)
    x_new = a * xt + (1.0 - a) * x
    w = a * zt + (1.0 - a) * z
    v = w + y / rho_vec

    # --- z-update ---
    cone = spec.cone
    mb_box = cone.m_box
    lam_over_rho = (qp_blk.lam / rho_vec[..., mb_box:mb_box + cone.m_l1]
                    if cone.m_l1 else qp_blk.lam)
    z_loc = project_cone(v[..., :ml], qp_blk.l[..., :ml], qp_blk.u[..., :ml],
                         lam_over_rho, cone)

    # Consensus averaging with neighbours; the global ends clamp to the
    # equality bounds stored in l (== u) of the edge rows. Under
    # re-centring the averaging happens in total coordinates (v + off)
    # and the offset is subtracted back out.
    v_left = v[..., ml:ml + ns]
    v_right = v[..., ml + ns:]
    if z_off is not None:
        off_left = z_off[..., ml:ml + ns]
        off_right = z_off[..., ml + ns:]
        v_left = v_left + off_left
        v_right = v_right + off_right
    avg_left = 0.5 * (v_left + _neighbor_prev(v_right, loc))
    avg_right = 0.5 * (v_right + _neighbor_next(v_left, loc))
    if z_off is not None:
        avg_left = avg_left - off_left
        avg_right = avg_right - off_right
    z_left = torch.where(loc.is_first, qp_blk.l[..., ml:ml + ns], avg_left)
    z_right = torch.where(loc.is_last, qp_blk.l[..., ml + ns:], avg_right)

    z_new = torch.cat([z_loc, z_left, z_right], dim=-1)
    y_new = y + rho_vec * (w - z_new)
    return x_new, z_new, y_new


def _edge_scale(settings: Settings) -> float:
    """The penalty boost of the edge rows (agreement rows are
    equality-like): rho_edge_scale, else rho_eq_scale."""
    return (settings.rho_edge_scale if settings.rho_edge_scale > 0
            else settings.rho_eq_scale)


def _rho_vec(rho_bar, box_eq, edge, eq_scale: float, edge_scale: float):
    """Per-row penalties: rho_bar on local rows, boosted on local
    equality rows and on every edge row."""
    return torch.where(box_eq, eq_scale * rho_bar,
                       torch.where(edge, edge_scale * rho_bar, rho_bar))


class _Rho:
    """Per-row penalties and the KKT factor of a consensus phase:
    rho_bar on local rows, boosted on local equality rows
    (rho_eq_scale) and on every edge row (rho_edge_scale; agreement rows
    are equality-like). `box_eq` is (S, mb), shared across scenarios."""

    def __init__(self, qp_blk: QPData, spec: ConsensusSpec,
                 settings: Settings, backend: str, box_eq):
        self.qp, self.settings, self.backend = qp_blk, settings, backend
        self.box_eq = box_eq
        self.edge = (torch.arange(spec.mb, device=box_eq.device)
                     >= spec.m_local)
        self.edge_scale = _edge_scale(settings)

    def vec(self, rho_bar):
        return _rho_vec(rho_bar, self.box_eq, self.edge,
                        self.settings.rho_eq_scale, self.edge_scale)

    def factor(self, rho_bar):
        s = self.settings
        return kkt.factor_condensed(self.qp.P, self.qp.A, s.sigma,
                                    self.vec(rho_bar), self.backend,
                                    s.band_block)

    def refresh(self, fac, rho_bar):
        """The factor after a rho change: matrix-free CG only takes the
        new penalties, every other backend refactors."""
        if self.backend == "cg":
            return dict(fac, rho=self.vec(rho_bar))
        return self.factor(rho_bar)


def _l1_scale(qp_blk: QPData, spec: ConsensusSpec, cd_inv, loc: Local):
    """L1 gradient scale for the dual-norm reference (core.admm.
    l1_grad_scale): block-local L1 rows at [m_box, m_box + m_l1), the
    max over the horizon axis."""
    cone = spec.cone
    if not cone.m_l1:
        return torch.zeros((), dtype=qp_blk.dtype, device=qp_blk.device)
    mbx = cone.m_box
    lamA = (qp_blk.lam[..., :, None]
            * qp_blk.A[..., mbx:mbx + cone.m_l1, :].abs()).amax(dim=(-3, -2))
    return _pmax((cd_inv * lamA).abs().amax(), loc)


def _eps(res, settings: Settings):
    _, _, nAx, nz, nPx, nAty, nq = res
    eps_p = settings.eps_abs + settings.eps_rel * torch.maximum(nAx, nz)
    eps_d = settings.eps_abs + settings.eps_rel * torch.maximum(
        torch.maximum(nPx, nAty), nq)
    return eps_p, eps_d


def _ratio(res, settings: Settings):
    eps_p, eps_d = _eps(res, settings)
    return torch.maximum(res[0] / eps_p, res[1] / eps_d)


def _status(res, settings, pinf_dinf):
    """Status codes of a check: NaN residuals, solved, then (where
    certificates run) primal and dual infeasibility."""
    r_p, r_d = res[0], res[1]
    eps_p, eps_d = _eps(res, settings)
    solved = (r_p <= eps_p) & (r_d <= eps_d)
    numerr = ~(torch.isfinite(r_p) & torch.isfinite(r_d))
    st = torch.where(solved, _SOLVED, _UNSOLVED)
    if pinf_dinf is not None:
        pinf, dinf = pinf_dinf
        st = torch.where(
            st == _UNSOLVED,
            torch.where(pinf, int(Status.PRIMAL_INFEASIBLE),
                        torch.where(dinf, int(Status.DUAL_INFEASIBLE), st)),
            st)
    return torch.where(numerr, int(Status.NUMERICAL_ERROR),
                       st).to(torch.int32)


def _balance(res, rho_bar, settings: Settings, geomean=None):
    """OSQP §5.2 residual balancing: (new_rho, changed). With `geomean`
    the per-scenario ratios are pooled by it first."""
    r_p, r_d, nAx, nz, nPx, nAty, nq = res
    tiny = torch.finfo(rho_bar.dtype).tiny
    sp = r_p / torch.clamp(torch.maximum(nAx, nz), min=tiny)
    sd = r_d / torch.clamp(torch.maximum(torch.maximum(nPx, nAty), nq),
                           min=tiny)
    if geomean is not None:
        sp, sd = geomean(sp), geomean(sd)
    ratio = torch.sqrt(sp / torch.clamp(sd, min=tiny))
    new_rho = torch.clamp(rho_bar * ratio, settings.rho_min,
                          settings.rho_max)
    tol = settings.adaptive_rho_tol
    return new_rho, (ratio > tol) | (ratio < 1.0 / tol)


class PhaseResult(NamedTuple):
    x: torch.Tensor          # local, scaled
    z: torch.Tensor
    y: torch.Tensor
    status: torch.Tensor
    iters: torch.Tensor
    r_prim: torch.Tensor
    r_dual: torch.Tensor
    rho_bar: torch.Tensor
    hist: torch.Tensor


def phase_state(qp_blk: QPData, rho: _Rho, scaling_vecs, fac, loc: Local,
                z_off):
    """The read-only part of a consensus check's state: the scaled block
    problem, the scaling vectors, the KKT factor (rewritten by a
    refactor), the penalty masks, this rank's block indices and, where
    given, the re-centring offset."""
    d_s, e_s, c_s = scaling_vecs
    state = dict(qp=dict(P=qp_blk.P, q=qp_blk.q, A=qp_blk.A, l=qp_blk.l,
                         u=qp_blk.u, lam=qp_blk.lam),
                 scaling=dict(d=d_s, e=e_s, c=c_s), fac=fac,
                 box_eq=rho.box_eq, edge=rho.edge, block_ids=loc.block_ids)
    if z_off is not None:
        state["z_off"] = z_off
    return state


def phase_carry(x0, z0, y0, rho_bar, status, big, slots: int):
    """The starting carry of both consensus loops: iterates, the last
    check's iterates, the restart sums, rho and its proposal, the
    iteration counter, status and residuals (`big`), the history and the
    flags."""
    dtype, dev = x0.dtype, x0.device
    return dict(x=x0, z=z0, y=y0, x_chk=x0, y_chk=y0,
                x_sum=torch.zeros_like(x0), z_sum=torch.zeros_like(z0),
                y_sum=torch.zeros_like(y0), rho_bar=rho_bar, new_rho=rho_bar,
                it=torch.zeros((), dtype=torch.int64, device=dev),
                status=status, r_prim=big, r_dual=big,
                hist=torch.full((slots, 3), -1.0, dtype=dtype, device=dev),
                flags=torch.ones(2, dtype=torch.int32, device=dev))


def loop_static(spec, settings: Settings, loc: Local, restart_checks: int):
    """(the step's static arguments, the cache key's). The key holds
    plain values: `Local` holds tensors and `Mesh` compares by identity,
    so it takes the block indices (one host read, before the loop) and
    the mesh's shape and coordinates instead."""
    args = dict(spec=spec, n_blocks=loc.n_blocks,
                edge_scale=_edge_scale(settings),
                use_cert=settings.eps_pinf > 0 or settings.eps_dinf > 0,
                restart_checks=restart_checks)
    key = dict(args, block_ids=tuple(loc.block_ids.tolist()),
               mesh_shape=tuple(sorted(loc.mesh.shape.items())),
               mesh_coords=tuple(sorted(loc.mesh.coords.items())))
    return args, key


def restart_cadence(settings: Settings) -> int:
    """Restart boundary in residual checks (0 disables)."""
    return settings.restart_every and max(
        1, settings.restart_every // settings.check_every)


def _global_res(qp_blk: QPData, loc: Local, einv, cd_inv, nlam, x, z, y):
    """Globally reduced unscaled residual norms (7-tuple)."""
    Ax = mv(qp_blk.A, x)
    Px = mv(qp_blk.P, x)
    Aty = vm(y, qp_blk.A)
    return (_linf_global(einv * (Ax - z), loc),
            _linf_global(cd_inv * (Px + qp_blk.q + Aty), loc),
            _linf_global(einv * Ax, loc), _linf_global(einv * z, loc),
            _linf_global(cd_inv * Px, loc),
            _linf_global(cd_inv * Aty, loc),
            torch.maximum(_linf_global(cd_inv * qp_blk.q, loc), nlam))


def consensus_check(state, variant, *, spec: ConsensusSpec,
                    settings: Settings, backend: str, mesh: Mesh,
                    n_blocks: int, edge_scale: float, use_cert: bool,
                    restart_checks: int):
    """One residual check of `run_consensus`: check_every iterations,
    the globally reduced residuals, the certificates from the
    pre-restart deltas, the restarted averaging, the status and, in the
    rho-test variant, the residual-balancing proposal. Returns the state
    entries it changes; 'flags' holds (status left UNSOLVED, refactor)
    as int32, agreed over the ranks by the host."""
    restart, rho_test = variant
    loc = Local(mesh=mesh, block_ids=state["block_ids"], n_blocks=n_blocks)
    qp_blk = QPData(**state["qp"], cone=spec.cone)
    sc = state["scaling"]
    vecs = (sc["d"], sc["e"], sc["c"])
    einv = 1.0 / sc["e"]
    cd_inv = 1.0 / (sc["c"] * sc["d"])
    k = settings.check_every
    rho_bar = state["rho_bar"]
    rho_vec = _rho_vec(rho_bar, state["box_eq"], state["edge"],
                       settings.rho_eq_scale, edge_scale)
    x, z, y = state["x"], state["z"], state["y"]
    for _ in range(k):
        x, z, y = consensus_body(qp_blk, spec, settings, loc, state["fac"],
                                 x, z, y, rho_vec, backend,
                                 z_off=state.get("z_off"))
    res = _global_res(qp_blk, loc, einv, cd_inv, state["nlam"], x, z, y)
    # Certificates use PRE-restart deltas: a restart replaces the
    # iterate with a window average, which wrecks the delta ray.
    cert = (infeasibility_blocks(qp_blk, spec, settings, loc, vecs,
                                 x - state["x_chk"], y - state["y_chk"])
            if use_cert else None)
    x_chk, y_chk = x, y

    # Restarted averaging: the comparison uses globally reduced norms,
    # so every rank takes the same decision, and the average keeps the
    # agreement-row pairing. The window always holds restart_checks
    # checks: the loop starts at check 0.
    sums = [state[n] + t for n, t in (("x_sum", x), ("z_sum", z),
                                      ("y_sum", y))]
    if restart:
        xa, za, ya = (s / float(restart_checks) for s in sums)
        res_a = _global_res(qp_blk, loc, einv, cd_inv, state["nlam"], xa,
                            za, ya)
        take = _ratio(res_a, settings) < _ratio(res, settings)
        x, z, y = (torch.where(take, a, b)
                   for a, b in ((xa, x), (za, z), (ya, y)))
        res = tuple(torch.where(take, ra, rc)
                    for ra, rc in zip(res_a[:6], res[:6])) + (res[6],)
        sums = [torch.zeros_like(s) for s in sums]

    status = _status(res, settings, cert)
    r_prim, r_dual = res[0], res[1]
    do = torch.zeros((), dtype=torch.bool, device=x.device)
    new_rho = state["new_rho"]
    if rho_test:
        new_rho, changed = _balance(res, rho_bar, settings)
        do = changed & (status == _UNSOLVED)
    it = state["it"] + k
    out = dict(x=x, z=z, y=y, x_chk=x_chk, y_chk=y_chk, x_sum=sums[0],
               z_sum=sums[1], y_sum=sums[2], status=status, r_prim=r_prim,
               r_dual=r_dual, new_rho=new_rho, it=it,
               flags=torch.stack([(status != _UNSOLVED).to(torch.int32),
                                  do.to(torch.int32)]))
    hist = state["hist"]
    if hist.shape[0]:
        row = torch.stack([it.to(hist.dtype), r_prim.to(hist.dtype),
                           r_dual.to(hist.dtype)])
        out["hist"] = admm.hist_write(hist, state["it"] // k, row)
    return out


def consensus_refactor(state, *, settings: Settings, backend: str,
                       edge_scale: float):
    """The REFACTOR of both consensus loops: rho-bar takes the last
    check's proposal ('new_rho'), and the factor follows it (`_Rho.
    refresh` on the state's problem and penalty masks: matrix-free CG
    only takes the new penalties, every other backend refactors)."""
    rho_bar = state["new_rho"]
    rho_vec = _rho_vec(rho_bar, state["box_eq"], state["edge"],
                       settings.rho_eq_scale, edge_scale)
    if backend == "cg":
        fac = dict(state["fac"], rho=rho_vec)
    else:
        fac = kkt.factor_condensed(state["qp"]["P"], state["qp"]["A"],
                                   settings.sigma, rho_vec, backend,
                                   settings.band_block)
    return dict(rho_bar=rho_bar, fac=fac)


def consensus_step(state, variant, *, check, settings: Settings,
                   backend: str, edge_scale: float, **kw):
    """A segment of a consensus loop: REFACTOR (`consensus_refactor`), or
    the check `variant` through `check` (`consensus_check` or
    consensus_mc's)."""
    if variant == graph.REFACTOR:
        return consensus_refactor(state, settings=settings, backend=backend,
                                  edge_scale=edge_scale)
    return check(state, variant, settings=settings, backend=backend,
                 edge_scale=edge_scale, **kw)


def run_consensus(qp_blk: QPData, spec: ConsensusSpec, settings: Settings,
                  loc: Local, x0, z0, y0, backend: str, scaling_vecs,
                  z_off=None, rho0=None) -> PhaseResult:
    """Rank-local driver: a lockstep loop over residual checks
    (`consensus_check`) and refactors (`consensus_refactor`),
    `graph.CheckLoop.run_checks`: on the card one CUDA graph whose WHILE
    node runs them where `graph.capturable` allows, else the host loop
    that reads one agreed flag tensor a check. Every residual is reduced
    over the horizon axis, so every rank takes the same decisions.
    scaling_vecs = (d, e, c) of the block-shared Ruiz scaling; residuals
    and termination are UNSCALED."""
    dtype, dev = qp_blk.dtype, qp_blk.device
    d_s, e_s, c_s = scaling_vecs
    cd_inv = 1.0 / (c_s * d_s)
    idx = torch.arange(spec.mb, device=dev)
    box_eq = ((qp_blk.l == qp_blk.u) & torch.isfinite(qp_blk.l)
              & (idx < spec.cone.m_box))
    rho = _Rho(qp_blk, spec, settings, backend, box_eq)
    rho_bar = (torch.tensor(settings.rho, dtype=dtype, device=dev)
               if rho0 is None else rho0.to(dtype))
    state = phase_state(qp_blk, rho, scaling_vecs, rho.factor(rho_bar), loc,
                        z_off)
    state["nlam"] = _l1_scale(qp_blk, spec, cd_inv, loc)
    state.update(phase_carry(
        x0, z0, y0, rho_bar,
        torch.tensor(_UNSOLVED, dtype=torch.int32, device=dev),
        torch.tensor(float("inf"), dtype=dtype, device=dev),
        max(settings.history, 0)))
    restart_checks = restart_cadence(settings)
    args, key = loop_static(spec, settings, loc, restart_checks)
    step = functools.partial(consensus_step, check=consensus_check,
                             settings=settings, backend=backend,
                             mesh=loc.mesh, **args)
    loop = graph.CheckLoop("run_consensus", step, state, settings, backend,
                           mesh=loc.mesh, **key)
    # flags: (status left UNSOLVED, refactor), agreed over every rank by
    # the plain loop.
    loop.run_checks(settings, restart_checks, done=True,
                    agree=functools.partial(runtime.agree, mesh=loc.mesh))
    x, z, y, status, it, r_prim, r_dual, rho_bar, hist = loop.result(
        "x", "z", "y", "status", "it", "r_prim", "r_dual", "rho_bar",
        "hist")
    status = torch.where(status == _UNSOLVED, int(Status.MAX_ITER),
                         status).to(torch.int32)
    return PhaseResult(x, z, y, status, it.to(torch.int32), r_prim, r_dual,
                       rho_bar, hist)


def _scaled_inputs(scaling: Scaling, dtype, x0, z0, y0, z_off):
    d_s, e_s, c_s = (t.to(dtype) for t in (scaling.d, scaling.e, scaling.c))
    offs = None if z_off is None else (e_s * z_off).to(dtype)
    return ((d_s, e_s, c_s), (x0 / d_s).to(dtype), (e_s * z0).to(dtype),
            ((c_s / e_s) * y0).to(dtype), offs)


def _consensus_phase(qp_blk: QPData, spec: ConsensusSpec, loc: Local,
                     settings: Settings, scaling: Scaling, backend: str,
                     x0, z0, y0, z_off=None, rho0=None) -> ConsensusSolution:
    """One scaled solve phase on this rank's blocks. Inputs and outputs
    are UNSCALED and local; `qp_blk` is the scaled problem, `scaling`
    its factors; rho0 an optional initial penalty (warm rho across
    phases)."""
    vecs, xs, zs, ys, offs = _scaled_inputs(scaling, qp_blk.dtype, x0, z0,
                                            y0, z_off)
    d_s, e_s, c_s = vecs
    r = run_consensus(qp_blk, spec, settings, loc, xs, zs, ys, backend,
                      vecs, z_off=offs, rho0=rho0)
    return ConsensusSolution(
        x=d_s * r.x, z=r.z / e_s, y=(e_s / c_s) * r.y, status=r.status,
        iters=r.iters, r_prim=r.r_prim, r_dual=r.r_dual, rho=r.rho_bar,
        history=r.hist)


def recentered_rounds_blocks(qp_blk: QPData, spec: ConsensusSpec,
                             settings: Settings, sol32, phase_fn,
                             loc: Local):
    """Re-centred f32 refinement rounds for box-cone consensus problems
    (cf. parallel/batch._solve_shared_recentered), shared by
    consensus_solve and consensus_solve_mc: sol32 only needs
    x/y/z/iters/rho, and a leading scenario axis broadcasts. Runs on
    this rank's blocks; the round loop's exit is agreed over every rank.

    Each round re-solves the SAME block problem with f64-shifted data:
    bounds shift by Ax on finite rows; the agreement rows shift through
    the z-space offset (the consensus averaging is a linear-subspace
    projection, so it shifts affinely); and both primal and dual are
    re-centred: the correction's linear term is the true dual residual

        g_c = P x + q + A' y_base,

    with y_base the accumulated dual MASKED to active, equality and
    agreement rows (strictly inactive rows get exact-0 duals, so
    complementarity junk cannot accumulate across rounds). The round
    solves for the dual CORRECTION dy from 0, and the total dual is
    y_base + dy: every correction quantity is O(residual), so f32
    iterations reach eps 1e-8 with no f64 iteration.

    Returns local (x, z, y) in f64 and the per-scenario (status, iters,
    r_p, r_d).
    """
    f32, f64 = torch.float32, torch.float64
    qp64 = qp_blk.astype(f64)
    ml, ns = spec.m_local, spec.ns
    x_t, y_t, z_t = clean64(sol32.x), clean64(sol32.y), clean64(sol32.z)
    iters = sol32.iters
    # Phase 1's adapted rho: the correction shares the original's
    # curvature, so starting there saves the rho random walk. Rounds
    # run to convergence (no recenter_max_iter cap: consensus has no
    # polish stage to land a partial round).
    rho_w = sol32.rho
    s_c = settings.replace(
        precision="single",
        sigma=max(settings.sigma, 1e-5),
        rho_eq_scale=min(settings.rho_eq_scale, 1e2),
        rho_edge_scale=(min(settings.rho_edge_scale, 1e2)
                        if settings.rho_edge_scale > 0 else -1.0),
        # Correction problems are feasible by construction; their rows
        # mix shifted and original domains, so certificates there are
        # meaningless.
        eps_pinf=0.0, eps_dinf=0.0)

    # Dual baseline mask: edge rows are equality-like (always kept);
    # local rows keep their dual only within act_tol of a bound (above
    # the phase-1 primal resolution hybrid_eps).
    edge = torch.arange(spec.mb, device=qp64.device) >= ml
    act_tol = 10.0 * max(settings.hybrid_eps, settings.eps_abs)

    def mask_dual(y, z):
        scale = 1.0 + z.abs()
        near_l = torch.isfinite(qp64.l) & (z - qp64.l <= act_tol * scale)
        near_u = torch.isfinite(qp64.u) & (qp64.u - z <= act_tol * scale)
        return torch.where(near_l | near_u | edge, y, 0.0)

    nq = _pmax(torch.maximum(qp64.q.abs().amax(), l1_grad_scale_raw(qp64)),
               loc)

    def true_resid(x_t, y_t, z_t):
        Ax = mv(qp64.A, x_t)
        Px = mv(qp64.P, x_t)
        Aty = vm(y_t, qp64.A)
        r_p = _linf_scen(Ax - z_t, loc)
        r_d = _linf_scen(Px + qp64.q + Aty, loc)
        eps_p = settings.eps_abs + settings.eps_rel * torch.maximum(
            _linf_scen(Ax, loc), _linf_scen(z_t, loc))
        eps_d = settings.eps_abs + settings.eps_rel * torch.maximum(
            torch.maximum(_linf_scen(Px, loc), _linf_scen(Aty, loc)), nq)
        return Ax, Px, r_p, r_d, (r_p <= eps_p) & (r_d <= eps_d)

    def every(solved):
        flag = (~solved).any().to(torch.int32)[None]
        return not bool(runtime.agree(flag, loc.mesh).item())

    solved_all = False
    solved = r_p = r_d = None
    for _ in range(max(settings.recenter_rounds, 0)):
        y_t = mask_dual(y_t, z_t)
        Ax, Px, r_p, r_d, solved = true_resid(x_t, y_t, z_t)
        solved_all = every(solved)                  # host read per round
        if solved_all:
            break
        g = Px + qp64.q + vm(y_t, qp64.A)           # O(residual) term
        l_c = torch.where(torch.isfinite(qp64.l), qp64.l - Ax, qp64.l)
        u_c = torch.where(torch.isfinite(qp64.u), qp64.u - Ax, qp64.u)
        qp_c = QPData(P=qp_blk.P.to(f32), q=g.to(f32), A=qp_blk.A.to(f32),
                      l=l_c.to(f32), u=u_c.to(f32), lam=qp_blk.lam.to(f32),
                      cone=qp_blk.cone)
        # Offsets matter only on the agreement rows. The averaging uses
        # only the DIFFERENCE of a pair's offsets, so pass its
        # antisymmetric part, off_L(b+1) = -off_R(b) = (Ax_L(b+1) -
        # Ax_R(b))/2: raw Ax is O(1) boundary state whose f32 rounding
        # poisons the agreement constraint, the gap is O(disagreement).
        # Both sides of a pair take the gap of the same two values, and
        # the end blocks' outer edges are masked.
        AxL, AxR = Ax[..., ml:ml + ns], Ax[..., ml + ns:]
        off_L = torch.where(loc.is_first, 0.0,
                            0.5 * (AxL - _neighbor_prev(AxR, loc)))
        off_R = torch.where(loc.is_last, 0.0,
                            -0.5 * (_neighbor_next(AxL, loc) - AxR))
        off = torch.cat([torch.zeros_like(Ax[..., :ml]), off_L, off_R],
                        dim=-1)
        solc = phase_fn(qp_c, s_c, torch.zeros_like(x_t, dtype=f32),
                        (z_t - Ax).to(f32), torch.zeros_like(y_t, dtype=f32),
                        off.to(f32), rho_w.to(f32))
        rho_w = solc.rho                # warm rho into the next round
        x_t = x_t + clean64(solc.x)
        y_t = y_t + clean64(solc.y)     # dual CORRECTION on masked base
        z_t = Ax + clean64(solc.z)
        iters = iters + solc.iters
    if not solved_all:
        y_t = mask_dual(y_t, z_t)
        _, _, r_p, r_d, solved = true_resid(x_t, y_t, z_t)
    status = torch.where(solved, _SOLVED, int(Status.MAX_ITER)).to(
        torch.int32)
    return x_t, z_t, y_t, status, iters, r_p, r_d


def _backend(settings: Settings, device) -> str:
    """'auto' takes the explicit inverse on a CUDA device (each x-update
    one batched product per block instead of two triangular solves) and
    Cholesky elsewhere; the reference makes the same choice with the TPU
    in the card's place."""
    if settings.backend != "auto":
        return settings.backend
    return "inv" if torch.device(device).type == "cuda" else "chol"


def _hybrid_s32(settings: Settings) -> Settings:
    """f32-phase settings: relaxed eps and f32 condition-number caps."""
    return settings.replace(
        precision="single",
        eps_abs=max(settings.hybrid_eps, settings.eps_abs),
        eps_rel=max(settings.hybrid_eps, settings.eps_rel),
        sigma=max(settings.sigma, 1e-5),
        rho_eq_scale=min(settings.rho_eq_scale, 1e2),
        rho_edge_scale=(min(settings.rho_edge_scale, 1e2)
                        if settings.rho_edge_scale > 0 else -1.0))


def solve_pipeline(qp_s: QPData, qp_loc: QPData, spec: ConsensusSpec,
                   settings: Settings, scaling: Scaling, phase, rounds,
                   finish, x0, z0, y0):
    """The precision pipeline shared by both drivers: one phase in the
    problem's dtype ('single') or in f64 ('double'); 'hybrid' runs an
    f32 phase, then the re-centred f32 rounds (box cones) or a
    warm-started f64 phase (L1, SOC). `phase(qp, settings, x, z, y,
    off=None, rho0=None, scaling=None)` runs one phase on local data;
    `rounds(sol32, phase_c)` the rounds; `finish(x, z, y, status, iters,
    r_prim, r_dual, rho, history)` gathers the solution."""
    if settings.precision == "single":
        return finish(*phase(qp_s, settings, x0, z0, y0))
    f32, f64 = torch.float32, torch.float64
    if settings.precision == "double":
        return finish(*phase(qp_s.astype(f64), settings, x0.to(f64),
                             z0.to(f64), y0.to(f64)))
    sol32 = phase(qp_s.astype(f32), _hybrid_s32(settings), x0.to(f32),
                  z0.to(f32), y0.to(f32))
    dtype = qp_loc.dtype
    cone = spec.cone
    if cone.m_l1 == 0 and cone.m_soc == 0 and settings.recenter_rounds > 0:
        s32 = scaling.astype(f32)

        def phase_c(qp_c, s_c, x_c, z_c, y_c, off_c, rho0):
            # Correction problems reuse the ORIGINAL scaling (same P, A).
            return phase(scale_qp_blocks(qp_c, s32, spec), s_c, x_c, z_c,
                         y_c, off=off_c, rho0=rho0, scaling=s32)

        x_t, z_t, y_t, status, iters, r_p, r_d = rounds(sol32, phase_c)
        return finish(x_t.to(dtype), z_t.to(dtype), y_t.to(dtype), status,
                      iters, r_p.to(dtype), r_d.to(dtype), sol32.rho,
                      sol32.history)
    # L1 / SOC local cones: a warm-started f64 phase.
    sol64 = phase(qp_s.astype(f64), settings.replace(precision="single"),
                  clean64(sol32.x), clean64(sol32.z), clean64(sol32.y))
    return finish(sol64.x.to(dtype), sol64.z.to(dtype), sol64.y.to(dtype),
                  sol64.status, sol32.iters + sol64.iters,
                  sol64.r_prim.to(dtype), sol64.r_dual.to(dtype),
                  sol64.rho.to(dtype), sol64.history)


def consensus_solve(qp_blk: QPData, spec: ConsensusSpec, mesh: Mesh,
                    settings: Settings = Settings(),
                    x0=None, z0=None, y0=None, rho0=None
                    ) -> ConsensusSolution:
    """Solve a block-partitioned problem over the mesh's horizon axis.

    qp_blk: per-block problem data stacked on a leading (B,) axis — P
    (B, nb, nb), A (B, mb, nb), q/l/u accordingly (rows per the
    ConsensusSpec layout), the same global problem on every rank. B
    must be divisible by the axis size. Each rank solves its slice of
    blocks on mesh.device and returns the gathered global solution.
    Optional UNSCALED (x0, z0, y0) warm start in the (B, .) block layout
    and rho0 penalty warm start (pass the previous solution's .rho).
    """
    B = spec.n_blocks
    H = mesh.shape[HORIZON_AXIS]
    if B % H:
        raise ValueError(f"n_blocks={B} not divisible by mesh axis {H}")
    dev = mesh.device
    backend = _backend(settings, dev)
    dtype = qp_blk.dtype
    S = B // H
    h = mesh.coords[HORIZON_AXIS]
    sl = slice(h * S, (h + 1) * S)
    loc = Local(mesh=mesh, n_blocks=B,
                block_ids=torch.arange(h * S, (h + 1) * S, device=dev))

    def mine(t, shape):
        if t is None:
            return torch.zeros((S,) + shape, dtype=dtype, device=dev)
        return torch.as_tensor(t)[sl].to(device=dev, dtype=dtype)

    qp_loc = QPData(P=qp_blk.P[sl], q=qp_blk.q[sl], A=qp_blk.A[sl],
                    l=qp_blk.l[sl], u=qp_blk.u[sl], lam=qp_blk.lam[sl],
                    cone=qp_blk.cone).to(dev)
    x0, z0, y0 = (mine(t, (w,)) for t, w in ((x0, spec.nb), (z0, spec.mb),
                                             (y0, spec.mb)))
    # Block-shared Ruiz scaling, computed once in the input dtype and
    # reused by every phase and round (the correction problems keep P, A).
    qp_s, scaling = ruiz_equilibrate_blocks(
        qp_loc, spec, settings.scaling_iters,
        reduce_max=lambda t: _pmax(t, loc))
    rho_start = None if rho0 is None else torch.as_tensor(rho0).to(dev)

    def phase(qp_p, s, x_p, z_p, y_p, off=None, rho0=rho_start,
              scaling=scaling):
        return _consensus_phase(qp_p, spec, loc, s, scaling, backend, x_p,
                                z_p, y_p, z_off=off, rho0=rho0)

    def gather(t):
        return runtime.all_gather(t, mesh, HORIZON_AXIS, dim=0)

    def finish(x, z, y, status, iters, r_p, r_d, rho, hist):
        return ConsensusSolution(x=gather(x), z=gather(z), y=gather(y),
                                 status=status, iters=iters, r_prim=r_p,
                                 r_dual=r_d, rho=rho, history=hist)

    def rounds(sol32, phase_c):
        return recentered_rounds_blocks(qp_loc, spec, settings, sol32,
                                        phase_c, loc)

    return solve_pipeline(qp_s, qp_loc, spec, settings, scaling, phase,
                          rounds, finish, x0, z0, y0)
