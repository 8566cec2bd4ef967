"""Fused ADMM iteration kernel for the shared-matrix lane batch.

`fused_iterate_shared` runs k = check_every complete ADMM iterations on
a (B, ·) lane batch that shares A, M⁻¹ and M:

    rhs = σx − q + (ρ∘z − y)·A
    x̃   = rhs·M⁻¹;  refine_steps times: r = rhs − x̃·M;  x̃ += r·M⁻¹
    z̃   = x̃·Aᵀ
    x⁺  = αx̃ + (1−α)x;   w = αz̃ + (1−α)z
    z⁺  = Π(w + y/ρ);    y⁺ = y + ρ(w − z⁺)

Π clips box rows, soft-thresholds and clips L1 rows and projects uniform
SOC blocks.

The CUDA kernel (csrc/fused_iterate.cu) replaces
admm_library_tpu/ops/fused.py::fused_iterate_shared, a Pallas kernel
that keeps every shared matrix resident in TPU VMEM for the whole
k-block. One H100 SM holds 227 KB, but the whole card holds 132 times
that: the kernel is one persistent cooperative launch per k-block whose
blocks each own a tile of A and of M⁻¹/M, keep it in shared memory for
all k iterations where it fits (2.44 MB in all at n=450, 18.5 KB per
SM) and stream it from L2 where it does not. Every product is spread
over the whole grid, split over its reduction axis as well as its
outputs; grid-wide barriers separate each product's partial sums from
the phase that adds them in a fixed order and applies the elementwise
step (rhs assembly, refinement, relaxation, prox, dual update).
`plan` chooses the partition from the shapes, the SM count and the
shared memory a block may use.

Above F64_BATCH lanes that split design gives way to the cluster design
(`ClusterPlan`), which `plan` chooses from B alone. There the work is
large: at B=1024, n=450 a 25-iteration block is 52.1 GFLOP, 0.78 ms of
f32 FFMA over the H100, and each product moves every lane's left
operand and the matrix through L2 to each block that multiplies them.
The split design spent most of its 5.9 ms on product phases far from
the FFMA rate, and the rest on 250 grid barriers and 125 summing phases.
The cluster design gives each thread-block cluster its own lanes, so the
grid needs no barrier and no partial sums (5 cluster barriers an
iteration), and runs each block's share of a product as a Hopper
SGEMM: 9 × 8 register tiles on the FFMA units, fed through a ring of
TMA boxes by a producer warp, with the elementwise steps in the
products' epilogues. It measured 3.0–3.3 ms a block at B=1024 on the
H100 (PERF.md §6).

`fused_iterate_shared_reference` is the same math in plain PyTorch (the
JAX kernel's `_iter_math`). The wrapper uses it for CPU tensors only;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..core import graph
from ..problem import ConeSpec
from .prox import project_cone
from . import _build

SMALL_BATCH = 8                 # B up to this: GEMV-shaped, one lane per tile
F64_BATCH = 256                 # B up to this: the split design (Plan);
                                # above it the cluster design (ClusterPlan)
# Bytes of the split design's accumulator: f64, as latency and barriers
# set its pace and the FMA units idle, so that a product of f32 operands
# is rounded once, whatever the partition (measured on the H100: an
# f32-accumulated kernel's error at B=128 was 1.7 times the cuBLAS
# twin's, and config 5's batch then took 375 iterations to an f64 KKT
# residual of 1.00002e-6; f64 accumulation, 350 and 9.995e-7).
ACC_BYTES = 8
LEFT_BYTES = 32 * 1024          # shared memory for the staged left operand
# Cost model of one block's share of a product: FFMA at half the SM's
# issue rate (the operands come from shared memory) and its share of the
# L2 bandwidth, both per nanosecond (H100 SXM, ~1.7 GHz).
_FMA_PER_NS = 128 * 1.7 * 0.5
_L2_BYTES_PER_NS = 30.0
_STREAM_BYTES_PER_NS = 8.0

_c_entry = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up4(v: int) -> int:
    return _cdiv(v, 4) * 4


def padded_ld(cols: int) -> int:
    """Row length in floats of a tile in shared memory: a multiple of 4
    (16-byte rows for float4 loads) and not of 8, so that float4 loads
    of neighbouring rows fall in different banks."""
    c = _up4(cols)
    return c if c % 8 else c + 4


def lane_tile(B: int) -> int:
    """Lanes of one thread's register tile (times 4 output columns).
    Measured on the H100 at B=128 and 1024, 4 lanes beat 8."""
    return 1 if B <= SMALL_BATCH else 4


def threads(tl: int) -> int:
    """Threads per block: 512 in the GEMV-shaped regime, where loads in
    flight set the pace, 256 above it (registers for the tile)."""
    return 512 if tl == 1 else 256


@dataclasses.dataclass(frozen=True)
class Tiling:
    """A cut of a (rows, cols) shared matrix and of the lanes over the
    grid: tile t = (lane group, row chunk, column chunk), row-major in
    that order, is block t's work in each product on that matrix. Chunks
    are multiples of 4 long, except the last."""

    lane_groups: int
    lanes: int
    row_splits: int
    row_chunk: int
    col_splits: int
    col_chunk: int

    @property
    def tiles(self) -> int:
        return self.lane_groups * self.row_splits * self.col_splits

    def tile(self, t: int, B: int, rows: int, cols: int):
        """(lanes, rows, cols) ranges of tile t."""
        g, rest = divmod(t, self.row_splits * self.col_splits)
        i, j = divmod(rest, self.col_splits)
        return (range(g * self.lanes, min(B, (g + 1) * self.lanes)),
                range(i * self.row_chunk, min(rows, (i + 1) * self.row_chunk)),
                range(j * self.col_chunk, min(cols, (j + 1) * self.col_chunk)))

    def as_ints(self):
        return [self.lane_groups, self.lanes, self.row_splits,
                self.row_chunk, self.col_splits, self.col_chunk]


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's partition of one (B, n, m) problem over the grid.

    `a` cuts A (m, n): the rhs product reduces over its row chunks and
    writes its column chunks; the z̃ product reduces over its column
    chunks and writes its row chunks, from the same tile. `nn` cuts M⁻¹
    and M (n, n) for the x̃ products. A tile is resident in shared
    memory for the whole launch where the flag says so, else streamed
    from L2 in every product. Shared memory, in floats: [A tile | M⁻¹
    tile | M tile | left operand (lane_chunk × ld_left) | partial sums
    (threads × lane_tile × 4 accumulators)]."""

    grid: int
    lane_tile: int
    lane_chunk: int
    a: Tiling
    nn: Tiling
    a_resident: bool
    minv_resident: bool
    m_resident: bool
    ld_a: int
    ld_nn: int
    ld_left: int
    smem_bytes: int

    def offsets(self):
        """Float offsets of (A, M⁻¹, M, left, partial sums) in shared
        memory, and the total floats."""
        a = self.a.row_chunk * self.ld_a if self.a_resident else 0
        nn = self.nn.row_chunk * self.ld_nn
        minv = nn if self.minv_resident else 0
        mm = nn if self.m_resident else 0
        left = self.lane_chunk * self.ld_left
        red = threads(self.lane_tile) * self.lane_tile * ACC_BYTES
        offs = [0, a, a + minv, a + minv + mm, a + minv + mm + left]
        return offs, offs[-1] + red

    design = "split"

    def describe(self):
        return dict(design=self.design, grid=self.grid,
                    lane_tile=self.lane_tile, a=self.a.as_ints(),
                    nn=self.nn.as_ints(), a_resident=self.a_resident,
                    minv_resident=self.minv_resident,
                    m_resident=self.m_resident, smem_bytes=self.smem_bytes)

    def as_ints(self):
        offs, _ = self.offsets()
        return ([self.grid, self.lane_tile, self.lane_chunk,
                 threads(self.lane_tile),
                 self.smem_bytes, int(self.a_resident),
                 int(self.minv_resident), int(self.m_resident), self.ld_a,
                 self.ld_nn, self.ld_left] + offs
                + self.a.as_ints() + self.nn.as_ints())


def _tiling(B, rows, cols, lane_groups, row_splits, col_splits):
    lanes = _cdiv(B, lane_groups)
    rc = _up4(_cdiv(rows, row_splits))
    cc = _up4(_cdiv(cols, col_splits))
    return Tiling(_cdiv(B, lanes), lanes, _cdiv(rows, rc), rc,
                  _cdiv(cols, cc), cc)


def _candidates(B, rows, cols, grid, tl):
    """Tilings that use as many of the grid's blocks as their row split
    allows, with at least tl lanes per group (one seen once)."""
    seen = set()
    nl = 1
    while nl <= min(grid, _cdiv(B, tl)):
        for rs in range(1, grid // nl + 1):
            t = _tiling(B, rows, cols, nl, rs, grid // (nl * rs))
            if t.tiles <= grid and t not in seen:
                seen.add(t)
                yield t
        nl *= 2


def _lane_chunk(lanes, tl, ld_left):
    return min(_cdiv(lanes, tl), LEFT_BYTES // (4 * ld_left * tl)) * tl


def _product_ns(t: Tiling, B, k_chunk, out_chunk, splits, n_out, tl,
                streamed, grid):
    """Modelled time of one block's share of one product and of the
    phase that adds its partial sums. A streamed tile is read once per
    lane chunk with few loads in flight, so at a fraction of the L2
    rate."""
    fma = _cdiv(t.lanes, tl) * tl * k_chunk * out_chunk
    moved = t.lanes * (4 * k_chunk + ACC_BYTES * out_chunk)
    moved += ACC_BYTES * splits * B * n_out / grid
    ns = fma / _FMA_PER_NS + moved / _L2_BYTES_PER_NS
    if streamed:
        chunks = _cdiv(t.lanes, _lane_chunk(t.lanes, tl, padded_ld(k_chunk)))
        ns += 4 * k_chunk * out_chunk * chunks / _STREAM_BYTES_PER_NS
    return ns


def _best_under(options, room):
    """The cheapest (cost, key, ...) of options [(bytes, cost, ...)]
    whose bytes fit room, or None."""
    fits = [o[1:] for o in options if o[0] <= room]
    return min(fits, key=lambda o: o[:2]) if fits else None


@functools.lru_cache(maxsize=256)
def plan(B: int, n: int, m: int, refine_steps: int, sms: int,
         smem_bytes: int, max_clusters: int | None = None):
    """The kernel's design and partition of (B, n, m), for a card with
    `sms` SMs and `smem_bytes` of shared memory per block.

    Above F64_BATCH lanes, the cluster design (`ClusterPlan`): as many
    clusters of `cluster_size(n, m)` blocks as the card holds at once
    (`max_clusters`, or sms // C where not given), at most one for each
    CLUSTER_LANES lanes, the lanes spread evenly over them.

    Up to F64_BATCH, the split design (`Plan`) over a grid of one block
    per SM: a cut of A (rhs and z-tilde products) and a cut of M⁻¹ and
    M (the x-tilde products) are chosen together for the least modelled
    time per iteration, each tile resident in shared memory where the
    room left allows, among cuts whose left operand fits LEFT_BYTES for
    one register tile of lanes."""
    if B > F64_BATCH:
        return _cluster_plan(B, n, m, sms, smem_bytes, max_clusters)
    tl = lane_tile(B)
    red = threads(tl) * tl * 4 * ACC_BYTES
    budget = smem_bytes - red - LEFT_BYTES - 1024
    if budget < 0:
        raise ValueError(f"{smem_bytes} bytes of shared memory per block "
                         "is too little for the fused kernel")

    def left_fits(t):
        return 4 * tl * padded_ld(max(t.row_chunk, t.col_chunk)) <= LEFT_BYTES

    # A: (resident bytes, cost, tiles, tiling, resident).
    a_opts = []
    for t in _candidates(B, m, n, sms, tl):
        if not left_fits(t):
            continue
        tile = 4 * t.row_chunk * padded_ld(t.col_chunk)
        for res in (True, False):
            cost = (_product_ns(t, B, t.row_chunk, t.col_chunk, t.row_splits,
                                n, tl, not res, sms)
                    + _product_ns(t, B, t.col_chunk, t.row_chunk,
                                  t.col_splits, m, tl, not res, sms))
            a_opts.append((tile if res else 0, cost, t.tiles, t, res))
    # M⁻¹ and M: (resident bytes, cost, tiles, tiling, M⁻¹ res, M res).
    n_opts = []
    for t in _candidates(B, n, n, sms, tl):
        if not left_fits(t):
            continue
        tile = 4 * t.row_chunk * padded_ld(t.col_chunk)

        def one(streamed):
            return _product_ns(t, B, t.row_chunk, t.col_chunk, t.row_splits,
                               n, tl, streamed, sms)
        for res_minv, res_m in ((True, True), (True, False), (False, False)):
            cost = ((1 + refine_steps) * one(not res_minv)
                    + refine_steps * one(not res_m))
            n_opts.append(((res_minv + res_m) * tile, cost, t.tiles, t,
                           res_minv, res_m))
    best = None
    for a_bytes, a_cost, a_tiles, ta, a_res in a_opts:
        if a_bytes > budget:
            continue
        nb = _best_under(n_opts, budget - a_bytes)
        if nb is None:
            continue
        key = (a_cost + nb[0], a_tiles + nb[1])
        if best is None or key < best[0]:
            best = (key, ta, a_res, nb[2], nb[3], nb[4])
    if best is None:
        raise ValueError(f"no partition of ({B}, {n}, {m}) fits the fused "
                         "kernel's shared memory")
    _, ta, a_res, tn, minv_res, m_res = best
    ld_left = padded_ld(max(ta.row_chunk, ta.col_chunk, tn.row_chunk))
    p = Plan(grid=sms, lane_tile=tl,
             lane_chunk=_lane_chunk(max(ta.lanes, tn.lanes), tl, ld_left),
             a=ta, nn=tn, a_resident=a_res, minv_resident=minv_res,
             m_resident=m_res, ld_a=padded_ld(ta.col_chunk),
             ld_nn=padded_ld(tn.col_chunk), ld_left=ld_left, smem_bytes=0)
    total = 4 * p.offsets()[1]
    if total > smem_bytes:
        raise ValueError(f"fused kernel plan needs {total} bytes of "
                         f"shared memory, {smem_bytes} available")
    return dataclasses.replace(p, smem_bytes=total)


# The cluster design's fixed shapes (csrc/fused_iterate.cu, namespace
# big): a tile of CLUSTER_LANES lanes × CLUSTER_COLS columns, computed by
# 8 consumer warps (a thread's register tile 9 lanes × 8 columns) fed by
# one producer warp; stages of CLUSTER_KC reduction steps in a ring of
# CLUSTER_STAGES; the groups' sums; the ring's mbarriers.
CLUSTER_COLS = 64
CLUSTER_LANES = 72
CLUSTER_KC = 32
CLUSTER_STAGES = 4
CLUSTER_GROUPS = 4
CLUSTER_THREADS = 64 * CLUSTER_GROUPS + 32
CLUSTER_MAX = 8


def cluster_smem_bytes() -> int:
    """Shared memory of a block of the cluster design: the ring (each
    stage the left operand's CLUSTER_LANES × KC box, then the matrix's KC
    × 64 or 64 × KC), the groups' sums, two 8-byte mbarriers a stage, and
    1024 bytes to align the ring for the 128-byte swizzle."""
    stage = (CLUSTER_LANES + CLUSTER_COLS) * CLUSTER_KC
    floats = (CLUSTER_STAGES * stage
              + CLUSTER_GROUPS * CLUSTER_LANES * CLUSTER_COLS)
    return 4 * floats + 16 * CLUSTER_STAGES + 1024


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """The large-batch design's partition (B > F64_BATCH): `grid` blocks
    in clusters of `cluster`; cluster g owns lanes [g lanes, (g+1)
    lanes) outright, its block of rank j the output columns [j cols_n,
    (j+1) cols_n) of the n-wide products and the rows [j cols_m, (j+1)
    cols_m) of A in the z̃ product, over the whole reduction axis, in
    tiles of CLUSTER_LANES lanes × CLUSTER_COLS columns. Scratch rows
    are ld_n and ld_m floats, multiples of 4 (16-byte rows for the bulk
    copies); the entry point copies A, M⁻¹ and M into rows of ld_n
    floats where ld_n is not n."""

    grid: int
    cluster: int
    lanes: int
    ld_n: int
    ld_m: int
    cols_n: int
    cols_m: int

    design = "cluster"
    threads = CLUSTER_THREADS

    @property
    def smem_bytes(self) -> int:
        return cluster_smem_bytes()

    def as_ints(self):
        return [self.grid, self.cluster, self.threads, self.smem_bytes,
                self.lanes, self.ld_n, self.ld_m, self.cols_n, self.cols_m]

    def describe(self):
        return dataclasses.asdict(self) | {"design": self.design,
                                           "threads": self.threads,
                                           "smem_bytes": self.smem_bytes}


def cluster_size(n: int, m: int) -> int:
    """Blocks of a cluster: one tile of columns each where n and m allow,
    at most CLUSTER_MAX (portable cluster sizes)."""
    return min(CLUSTER_MAX, _cdiv(max(n, m), CLUSTER_COLS))


def _cluster_plan(B, n, m, sms, smem_bytes, max_clusters):
    C = cluster_size(n, m)
    wave = sms // C if max_clusters is None else min(sms // C, max_clusters)
    if wave < 1:
        raise ValueError(f"no cluster of {C} blocks fits the card")
    if cluster_smem_bytes() > smem_bytes:
        raise ValueError(f"fused kernel plan needs {cluster_smem_bytes()} "
                         f"bytes of shared memory, {smem_bytes} available")
    lanes = _cdiv(B, min(wave, _cdiv(B, CLUSTER_LANES)))
    return ClusterPlan(grid=_cdiv(B, lanes) * C, cluster=C, lanes=lanes,
                       ld_n=_up4(n), ld_m=_up4(m),
                       cols_n=4 * _cdiv(n, 4 * C), cols_m=4 * _cdiv(m, 4 * C))


def prox_units(cone: ConeSpec):
    """(first row, rows) of each unit of the prox phase: one box or L1
    row, or one whole uniform SOC block. One thread owns one unit of
    one lane, so an SOC projection never crosses threads."""
    rows = cone.m_box + cone.m_l1
    units = [(c, 1) for c in range(rows)]
    d = cone.soc_dims[0] if cone.m_soc else 0
    units += [(rows + b * d, d) for b in range(cone.n_soc)]
    return units


def _entry():
    """The C entry points, with their argument types declared."""
    global _c_entry
    if _c_entry is None:
        lib = _build.load_library("fused_iterate")
        fn = lib.admm_fused_iterate_f32
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ptr] * 17 + [i32] * 7 + [f32] * 3
                       + [i32, i32, ptr, i32, ptr])
        fn.restype = ctypes.c_int
        lib.admm_fused_device_limits.argtypes = [i32, ptr, ptr]
        lib.admm_fused_device_limits.restype = ctypes.c_int
        lib.admm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.admm_cuda_error_string.restype = ctypes.c_char_p
        lib.admm_fused_max_clusters.argtypes = [i32, ptr]
        lib.admm_fused_max_clusters.restype = ctypes.c_int
        _c_entry = (fn, lib.admm_fused_device_limits,
                    lib.admm_cuda_error_string, lib.admm_fused_max_clusters)
    return _c_entry


@functools.lru_cache(maxsize=None)
def device_limits(index: int):
    """(SM count, shared memory a block may opt in to) of a CUDA card."""
    _, limits, err_str, _ = _entry()
    sms, smem = ctypes.c_int(), ctypes.c_int()
    rc = limits(index, ctypes.byref(sms), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"fused kernel: device query failed ({rc}: "
                           f"{err_str(rc).decode()})")
    return sms.value, smem.value


@functools.lru_cache(maxsize=None)
def max_clusters(index: int, cluster: int) -> int:
    """Clusters of `cluster` blocks of the cluster design that CUDA card
    `index` holds at once (cudaOccupancyMaxActiveClusters)."""
    _, _, err_str, query = _entry()
    count = ctypes.c_int()
    with torch.cuda.device(index):
        rc = query(cluster, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"fused kernel: cluster occupancy query failed "
                           f"({rc}: {err_str(rc).decode()})")
    return count.value


def device_plan(B: int, n: int, m: int, refine_steps: int, index: int):
    """`plan` for CUDA card `index`, with its SM count, shared memory and,
    for the cluster design, its cluster occupancy."""
    sms, smem = device_limits(index)
    clusters = (max_clusters(index, cluster_size(n, m))
                if B > F64_BATCH else None)
    return plan(B, n, m, refine_steps, sms, smem, clusters)


def _lam_over_rho(lam, rho_vec, cone: ConeSpec):
    mb, ml = cone.m_box, cone.m_l1
    return lam / rho_vec[mb:mb + ml] if ml else lam


def fused_iterate_shared_reference(A, Minv, M, q, rho_vec, lam, l, u,
                                   x, z, y, cone: ConeSpec, sigma: float,
                                   alpha: float, k: int,
                                   refine_steps: int = 1):
    """Plain PyTorch twin of the kernel: k iterations, returns (x, z, y)."""
    lam_r = _lam_over_rho(lam, rho_vec, cone)
    for _ in range(k):
        rhs = sigma * x - q + (rho_vec * z - y) @ A
        xt = rhs @ Minv
        for _ in range(refine_steps):
            r = rhs - xt @ M
            xt = xt + r @ Minv
        zt = xt @ A.mT
        x_new = alpha * xt + (1.0 - alpha) * x
        w = alpha * zt + (1.0 - alpha) * z
        v = w + y / rho_vec
        z_new = project_cone(v, l, u, lam_r, cone)
        y = y + rho_vec * (w - z_new)
        x, z = x_new, z_new
    return x, z, y


def _check_cuda(B, n, m, cone, **tensors):
    dev = tensors["x"].device
    shapes = {"A": (m, n), "Minv": (n, n), "M": (n, n), "q": (n,),
              "rho_vec": (m,), "lam": (cone.m_l1,), "l": (B, m),
              "u": (B, m), "x": (B, n), "z": (B, m), "y": (B, m)}
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused kernel takes float32, {name} is {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_iterate_shared(A, Minv, M, q, rho_vec, lam, l, u, x, z, y,
                         cone: ConeSpec, sigma: float, alpha: float,
                         k: int, refine_steps: int = 1):
    """Run k fused ADMM iterations on the shared-matrix batch.

    A (m, n), Minv and M (n, n), q (n,), rho_vec (m,), lam (m_l1,) are
    shared; l/u are (B, m) or (m,); x (B, n), z and y (B, m). Returns new
    (x, z, y). CPU tensors go through the plain twin; CUDA tensors
    through the kernel, which raises on any error.
    """
    if cone.m_soc and not cone.soc_uniform:
        raise ValueError("fused kernel requires uniform SOC block dims")
    B, n = x.shape
    m = z.shape[-1]
    if l.dim() == 1:
        l = l.expand(B, m).contiguous()
        u = u.expand(B, m).contiguous()
    if x.device.type == "cpu":
        return fused_iterate_shared_reference(
            A, Minv, M, q, rho_vec, lam, l, u, x, z, y, cone=cone,
            sigma=sigma, alpha=alpha, k=k, refine_steps=refine_steps)
    if not x.is_cuda:
        raise ValueError(f"fused kernel: unsupported device {x.device}")
    _check_cuda(B, n, m, cone, A=A, Minv=Minv, M=M, q=q, rho_vec=rho_vec,
                lam=lam, l=l, u=u, x=x, z=z, y=y)
    fn, _, err_str, _ = _entry()
    p = device_plan(B, n, m, int(refine_steps), x.device.index)
    lam_r = _lam_over_rho(lam, rho_vec, cone).contiguous()
    xo, zo, yo = (t.clone() for t in (x, z, y))
    if p.design == "cluster":
        # Rows of a multiple of 4 floats for the bulk copies: the scratch
        # here, and A, M⁻¹ and M copied by the entry point into part_n
        # where n is not such a multiple. Nothing is summed across
        # blocks.
        rhs, xt, r = (torch.empty((B, p.ld_n), device=x.device)
                      for _ in range(3))
        part_n = (torch.empty((m + 2 * n) * p.ld_n, device=x.device)
                  if p.ld_n != n else None)
        part_m = torch.empty((2, B, p.ld_m), device=x.device)
        barrier = None
    else:
        rhs, xt, r = (torch.empty_like(xo) for _ in range(3))
        # Inside a CUDA graph capture the scratch comes from the graph's
        # pool and the barrier's zero fill is a node of the graph, so
        # every replay starts the counter from 0.
        part_n = torch.empty((max(p.a.row_splits, p.nn.row_splits), B, n),
                             dtype=torch.float64, device=x.device)
        part_m = torch.empty((p.a.col_splits, B, m), dtype=torch.float64,
                             device=x.device)
        barrier = torch.zeros(1, dtype=torch.int32, device=x.device)
    ints = (ctypes.c_int * len(p.as_ints()))(*p.as_ints())
    soc_dim = cone.soc_dims[0] if cone.m_soc else 0

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(ptr(A), ptr(Minv), ptr(M), ptr(q), ptr(rho_vec),
                ptr(lam_r) if cone.m_l1 else None, ptr(l), ptr(u),
                ptr(xo), ptr(zo), ptr(yo), ptr(rhs), ptr(xt), ptr(r),
                ptr(part_n), ptr(part_m), ptr(barrier),
                B, n, m, cone.m_box, cone.m_l1, cone.n_soc, soc_dim,
                float(sigma), float(alpha), float(1.0 - alpha), int(k),
                int(refine_steps), ints, len(ints), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_iterate_shared: CUDA launch failed ({rc}: "
            f"{err_str(rc).decode()})")
    graph.count_launch(fused_iterate_shared, x.device)
    fused_iterate_shared.calls_by_design[p.design] += 1
    return xo, zo, yo


# Times the kernel ran (graph.Counted): one per call on CUDA tensors; for
# a call inside a captured graph (core/graph.py), one per replay of that
# graph, or, inside a conditional body, one per pass of that body.
fused_iterate_shared = graph.Counted(fused_iterate_shared)
# The wrapper's calls on CUDA tensors by the design they ran, counted on
# the host: each eager launch and each capture of one once (`launches`
# counts the replays too).
fused_iterate_shared.calls_by_design = {"split": 0, "cluster": 0}
