"""Batched Jacobi-preconditioned conjugate gradient on the shared
condensed KKT matrix.

`pallas_cg_solve` runs a fixed `iters` steps of lockstep PCG on
M x = rhs for a (B, n) batch of right-hand sides against one shared SPD
M, with the Jacobi preconditioner dinv = 1/diag(M). A lane freezes once
‖r‖² ≤ tol²·max(‖rhs‖², 1) and its x no longer changes. rho enters only
through M's assembly, so an adaptive-rho update costs one product,
never a factorisation.

The CUDA kernels (csrc/pallas_cg.cu) replace
admm_library_tpu/ops/pallas_cg.py::pallas_cg_solve, a Pallas kernel
that keeps M resident in TPU VMEM. One SM's shared memory holds M only
up to n ~ 240 in f32, so `plan` picks one of two designs:

- "resident": a thread-block cluster of C ∈ {1, 2, 4, 8} blocks owns a
  tile of lanes, and each block holds a column slice of M in its shared
  memory for the whole launch (three cluster barriers per CG step);
- "stream": where no cluster of 8 can hold M (n = 2000, for example),
  one block owns a tile of lanes and streams M from L2 every step.

`pallas_cg_solve_reference` is the same math in plain PyTorch (the JAX
kernel's `_cg_math`). The wrappers use it for CPU tensors only; for
CUDA tensors they launch a kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import graph
from . import _build

# The lane tiles and cluster sizes the kernels are compiled for: the
# stream design's tiles, the resident design's (odd tiles let a batch
# fill one wave of clusters) and its portable cluster sizes.
LANE_TILES = (1, 2, 4, 8)
RESIDENT_TILES = (1, 2, 3, 4, 5, 6, 8)
CLUSTERS = (1, 2, 4, 8)
# Dynamic shared memory one block may use on Hopper.
SMEM_LIMIT = 232448
# Thread blocks the card runs in one wave (one per SM of an H100).
_WAVE = 132
# The kernels' block shape (csrc/pallas_cg.cu).
_THREADS = 512
_WARPS = _THREADS // 32
_SLOTS = 6
# Up to this n the resident product keeps k whole (one group).
_WHOLE_K = 128

_c_entry = None


def bind(lib):
    """The C entry points of a built kernel library, with their argument
    types declared: ({dtype: solve}, smem_bytes, max_clusters,
    error_string)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for dt, name in ((torch.float32, "admm_pcg_f32"),
                     (torch.float64, "admm_pcg_f64")):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 5 + [i32] * 3 + [ctypes.c_double, i32, i32, ptr]
        fn.restype = i32
        fns[dt] = fn
    lib.admm_pcg_smem_bytes.argtypes = [i32] * 4
    lib.admm_pcg_smem_bytes.restype = ctypes.c_longlong
    lib.admm_pcg_max_clusters.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    lib.admm_pcg_max_clusters.restype = i32
    lib.admm_pcg_error_string.argtypes = [i32]
    lib.admm_pcg_error_string.restype = ctypes.c_char_p
    return (fns, lib.admm_pcg_smem_bytes, lib.admm_pcg_max_clusters,
            lib.admm_pcg_error_string)


def _entry():
    """The package's kernel library, built on first use."""
    global _c_entry
    if _c_entry is None:
        _c_entry = bind(_build.load_library("pallas_cg"))
    return _c_entry


def _cg_math(M, dinv, rhs, x0, iters: int, tol: float):
    """The masked lockstep PCG loop on (B, n) lanes; M is symmetric, so
    the batched product is v @ M."""
    tiny = torch.finfo(rhs.dtype).tiny
    x = x0
    r = rhs - x @ M
    z = r * dinv
    p = z
    rz = (r * z).sum(-1, keepdim=True)
    rr = (r * r).sum(-1, keepdim=True)
    # clamp keeps a NaN, as jnp.maximum does.
    tol2 = (tol * tol) * torch.clamp((rhs * rhs).sum(-1, keepdim=True),
                                     min=1.0)
    zero = torch.zeros_like(rz)
    for _ in range(iters):
        Mp = p @ M
        pMp = (p * Mp).sum(-1, keepdim=True)
        active = rr > tol2
        alpha = torch.where(active, rz / torch.clamp(pMp, min=tiny), zero)
        x = x + alpha * p
        r = r - alpha * Mp
        z = r * dinv
        rz_new = (r * z).sum(-1, keepdim=True)
        rr_new = (r * r).sum(-1, keepdim=True)
        beta = torch.where(active, rz_new / torch.clamp(rz, min=tiny), zero)
        p = z + beta * p
        rz = torch.where(active, rz_new, rz)
        rr = torch.where(active, rr_new, rr)
    return x


def _lanes(M, rhs, x0):
    """(B, n) rhs and x0, and dinv, from the wrapper's argument forms."""
    if M.dim() != 2:
        raise ValueError("pallas_cg requires an unbatched (shared) M")
    rhs2 = rhs[None, :] if rhs.dim() == 1 else rhs
    if x0 is None:
        x02 = torch.zeros_like(rhs2)
    else:
        x02 = x0[None, :] if x0.dim() == 1 else x0
    dinv = (1.0 / torch.diagonal(M)).to(rhs2.dtype)
    return rhs2, x02, dinv


def pallas_cg_solve_reference(M, rhs, x0=None, iters: int = 100,
                              tol: float = 1e-7):
    """Plain PyTorch twin of the kernel, with the wrapper's contract."""
    rhs2, x02, dinv = _lanes(M, rhs, x0)
    out = _cg_math(M, dinv, rhs2, x02, int(iters), float(tol))
    return out[0] if rhs.dim() == 1 else out


def auto_lane_tile(B: int) -> int:
    """The stream design's lane tile: the smallest that keeps the grid
    within half a wave.

    Every block streams all of M from L2 each step, so one lane per
    block multiplies that traffic, while many lanes per block leave few
    blocks and much work per block: at n=450, B=128, 200 steps, f32,
    4.49 / 3.58 / 4.38 / 7.36 ms for 1 / 2 / 4 / 8 lanes per block
    (NVIDIA H100 80GB HBM3, 700.00 W). `plan` takes it where M cannot
    be held in a cluster's shared memory.
    """
    for t in LANE_TILES:
        if -(-B // t) <= _WAVE // 2:
            return t
    return LANE_TILES[-1]


def stream_smem_bytes(lane_tile: int, n: int, itemsize: int) -> int:
    """Dynamic shared memory of one stream block: x, r, z, p and Mp of
    its lanes, the reduction scratch and the per-lane scalars."""
    return (5 * lane_tile * n + _WARPS * 3 * lane_tile
            + _SLOTS * lane_tile) * itemsize


def resident_smem_bytes(cluster: int, lane_tile: int, n: int,
                        itemsize: int) -> int:
    """Dynamic shared memory of one block of a resident cluster, every
    buffer counted as csrc/pallas_cg.cu's `layout` does: p twice in full
    (rows padded to 16 bytes), the slice of M (n × w, w = ⌈n/C⌉), the
    product's per-group partial sums (k whole up to n = 128), the
    reduction scratch and the slots the cluster's blocks store into."""
    vw = 16 // itemsize
    w = -(-n // cluster)
    np_ = -(-n // vw) * vw
    groups = 1 if n <= _WHOLE_K else max(1, _THREADS // w)
    kchunk = -(-(-(-n // groups)) // vw) * vw    # ⌈⌈n/groups⌉/vw⌉·vw
    groups = -(-n // kchunk)
    lt = lane_tile
    elems = (2 * lt * np_ + n * w + groups * lt * w + _WARPS * 3 * lt
             + 6 * cluster * lt)
    return elems * itemsize


def plan(B: int, n: int, itemsize: int, sms: int, smem: int, max_clusters):
    """(design, C, LT) for a (B, n) solve of items of `itemsize` bytes
    on a card with `sms` SMs and `smem` bytes of shared memory per
    block; `max_clusters(C, LT)` is how many clusters of C blocks the
    card holds at once.

    "resident" with the smallest C whose blocks fit `smem` and that the
    card can place, then the smallest LT whose ⌈B/LT⌉ clusters fit in
    one wave (at most `max_clusters(C, LT)` and `sms // C` clusters),
    or else the largest LT that fits. Above n = 128 the
    cluster is then doubled while the doubled cluster still holds every
    lane in one wave at the same LT: it halves each block's product
    behind the same three barriers (n=450, B=1, f32, 200 steps: 0.99 ms
    with 8 blocks, 1.11-1.14 with 4 on an NVIDIA H100 80GB HBM3, 700 W;
    scripts/compare_pcg_plans.py), where at n ≤ 128 the barriers
    outweigh the product. "stream" (C = 1) only
    where no C ≤ 8 fits, with `auto_lane_tile(B)` cut to the largest
    tile whose block fits.
    """
    def fit(C):
        """(LT, one wave) at cluster size C, or None if no tile fits."""
        tiles = [t for t in RESIDENT_TILES
                 if resident_smem_bytes(C, t, n, itemsize) <= smem]
        wave = {t: min(max_clusters(C, t), sms // C) for t in tiles}
        tiles = [t for t in tiles if wave[t] >= 1]
        if not tiles:
            return None
        for t in tiles:
            if -(-B // t) <= wave[t]:
                return t, True
        return tiles[-1], False

    for i, C in enumerate(CLUSTERS):
        got = fit(C)
        if got is None:
            continue
        LT, one_wave = got
        for C2 in CLUSTERS[i + 1:] if n > _WHOLE_K and one_wave else ():
            if fit(C2) != (LT, True):
                break
            C = C2
        return "resident", C, LT
    auto = auto_lane_tile(B)
    fit_stream = [t for t in LANE_TILES
                  if t <= auto and stream_smem_bytes(t, n, itemsize) <= smem]
    return "stream", 1, max(fit_stream, default=1)


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, cluster: int, lane_tile: int, n: int,
                  itemsize: int) -> int:
    _, _, query, err_str = _entry()
    count = ctypes.c_int()
    with torch.cuda.device(index):
        rc = query(cluster, lane_tile, n, itemsize, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"pallas_cg: cluster occupancy query failed "
                           f"({rc}: {err_str(rc).decode()})")
    return count.value


@functools.lru_cache(maxsize=None)
def device_plan(B: int, n: int, itemsize: int, index: int):
    """`plan` for CUDA card `index`: its SM count, shared memory and
    cluster occupancy, each asked of the card (once per shape: a solve
    calls the kernel hundreds of times)."""
    from .fused import device_limits
    sms, smem = device_limits(index)
    return plan(B, n, itemsize, sms, min(smem, SMEM_LIMIT),
                lambda C, t: _max_clusters(index, C, t, n, itemsize))


def prepare(B: int, n: int, dtype, device) -> None:
    """Load the kernel library and resolve `device_plan` for a (B, n)
    solve in `dtype` on `device`, on the host: a loop whose checks launch
    the kernel calls this before its first segment, so that no capture
    meets the build, the library's loading or the card's occupancy
    query for the first time. Nothing for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    _entry()
    device_plan(B, n, dtype.itemsize,
                torch.cuda.current_device() if device.index is None
                else device.index)


def _check_cuda(M, rhs2, x02):
    B, n = rhs2.shape
    for name, t, shape in (("M", M, (n, n)), ("rhs", rhs2, (B, n)),
                           ("x0", x02, (B, n))):
        if t.device != rhs2.device:
            raise ValueError(f"{name} is on {t.device}, rhs on {rhs2.device}")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"pallas_cg kernel takes float32 or float64, "
                            f"{name} is {t.dtype}")
        if t.dtype != rhs2.dtype:
            raise TypeError(f"{name} is {t.dtype}, rhs is {rhs2.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def pallas_cg_solve_planned(M, rhs, x0=None, iters: int = 100,
                            tol: float = 1e-7, plan=None):
    """`pallas_cg_solve` with the launch given: `plan` is a
    (design, C, LT) tuple as `plan` returns it, or None for the card's
    own plan. A plan the card refuses raises; nothing falls back. CPU
    tensors go through the plain twin, whatever the plan."""
    if rhs.device.type == "cpu":
        return pallas_cg_solve_reference(M, rhs, x0, iters, tol)
    rhs2, x02, dinv = _lanes(M, rhs, x0)
    if not rhs2.is_cuda:
        raise ValueError(f"pallas_cg kernel: unsupported device {rhs2.device}")
    _check_cuda(M, rhs2, x02)
    B, n = rhs2.shape
    fns, _, _, err_str = _entry()
    if plan is None:
        plan = device_plan(B, n, rhs2.element_size(), rhs2.device.index)
    design, cluster, tile = plan
    if design not in ("resident", "stream"):
        raise ValueError(f"pallas_cg: unknown design {design!r}")
    out = torch.empty_like(rhs2)
    with torch.cuda.device(rhs2.device):
        stream = torch.cuda.current_stream(rhs2.device).cuda_stream
        rc = fns[rhs2.dtype](M.data_ptr(), dinv.data_ptr(),
                             rhs2.data_ptr(), x02.data_ptr(),
                             out.data_ptr(), B, n, int(iters),
                             float(tol) * float(tol), int(tile),
                             int(cluster) if design == "resident" else 0,
                             stream)
    if rc != 0:
        raise RuntimeError(f"pallas_cg_solve: CUDA launch failed ({rc}: "
                           f"{err_str(rc).decode()}) for plan {plan}")
    graph.count_launch(pallas_cg_solve, rhs2.device)
    return out[0] if rhs.dim() == 1 else out


def pallas_cg_solve(M, rhs, x0=None, iters: int = 100, tol: float = 1e-7):
    """Solve M x = rhs by `iters` steps of lockstep Jacobi PCG.

    M (n, n) SPD, shared; rhs (n,) or (B, n); x0 defaults to zeros.
    Returns x with rhs's shape. CPU tensors go through the plain twin;
    CUDA tensors through the kernel `device_plan` picks, which raises
    on any error.
    """
    return pallas_cg_solve_planned(M, rhs, x0, iters, tol)


# Times a kernel ran (either design, from either entry point;
# graph.Counted): one per call on CUDA tensors; for a call inside a
# captured graph (core/graph.py), one per replay of that graph, or,
# inside a conditional body, one per pass of that body.
pallas_cg_solve = graph.Counted(pallas_cg_solve)
