"""Batched Jacobi-preconditioned conjugate gradient on the shared
condensed KKT matrix.

`pallas_cg_solve` runs a fixed `iters` steps of lockstep PCG on
M x = rhs for a (B, n) batch of right-hand sides against one shared SPD
M, with the Jacobi preconditioner dinv = 1/diag(M). A lane freezes once
‖r‖² ≤ tol²·max(‖rhs‖², 1) and its x no longer changes. rho enters only
through M's assembly, so an adaptive-rho update costs one product,
never a factorisation.

The CUDA kernel (csrc/pallas_cg.cu) replaces
admm_library_tpu/ops/pallas_cg.py::pallas_cg_solve, a Pallas kernel
that keeps M resident in TPU VMEM. On the H100 M (810 KB in f32 at the
flagship n=450) does not fit one SM's shared memory, so it stays in L2
and each thread block streams it once per CG step for its tile of
lanes, which keep their CG vectors in shared memory for the whole
launch.

`pallas_cg_solve_reference` is the same math in plain PyTorch (the JAX
kernel's `_cg_math`). The wrapper uses it for CPU tensors only; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# The lane tiles the kernel is compiled for.
LANE_TILES = (1, 2, 4, 8)
# Dynamic shared memory one block may use on Hopper.
_SMEM_LIMIT = 232448
# Thread blocks the card runs in one wave (one per SM of an H100).
_WAVE = 132

_c_entry = None


def _entry():
    """The C entry points, with their argument types declared."""
    global _c_entry
    if _c_entry is None:
        lib = _build.load_library("pallas_cg")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fns = {}
        for dt, name in ((torch.float32, "admm_pcg_f32"),
                         (torch.float64, "admm_pcg_f64")):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 5 + [i32] * 3 + [ctypes.c_double, i32, ptr]
            fn.restype = i32
            fns[dt] = fn
        lib.admm_pcg_smem_bytes.argtypes = [i32, i32, i32]
        lib.admm_pcg_smem_bytes.restype = ctypes.c_longlong
        lib.admm_pcg_error_string.argtypes = [i32]
        lib.admm_pcg_error_string.restype = ctypes.c_char_p
        _c_entry = (fns, lib.admm_pcg_smem_bytes, lib.admm_pcg_error_string)
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
    """The smallest lane tile that keeps the grid within half a wave.

    Every block streams all of M from L2 each step, so one lane per
    block multiplies that traffic, while many lanes per block leave few
    blocks and much work per block: at n=450, B=128, 200 steps, f32,
    4.49 / 3.58 / 4.38 / 7.36 ms for 1 / 2 / 4 / 8 lanes per block
    (NVIDIA H100 80GB HBM3, 700.00 W).
    """
    for t in LANE_TILES:
        if -(-B // t) <= _WAVE // 2:
            return t
    return LANE_TILES[-1]


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


def pallas_cg_solve(M, rhs, x0=None, iters: int = 100, tol: float = 1e-7):
    """Solve M x = rhs by `iters` steps of lockstep Jacobi PCG.

    M (n, n) SPD, shared; rhs (n,) or (B, n); x0 defaults to zeros.
    Returns x with rhs's shape. CPU tensors go through the plain twin;
    CUDA tensors through the kernel, which raises on any error. The
    lanes per thread block are `auto_lane_tile(B)`.
    """
    if rhs.device.type == "cpu":
        return pallas_cg_solve_reference(M, rhs, x0, iters, tol)
    rhs2, x02, dinv = _lanes(M, rhs, x0)
    if not rhs2.is_cuda:
        raise ValueError(f"pallas_cg kernel: unsupported device {rhs2.device}")
    B, n = rhs2.shape
    tile = auto_lane_tile(B)
    _check_cuda(M, rhs2, x02)
    fns, smem_bytes, err_str = _entry()
    if smem_bytes(tile, n, rhs2.element_size()) > _SMEM_LIMIT:
        raise ValueError(f"pallas_cg kernel: n={n} with {tile} lanes per "
                         f"block exceeds the shared memory of one block")
    out = torch.empty_like(rhs2)
    with torch.cuda.device(rhs2.device):
        stream = torch.cuda.current_stream(rhs2.device).cuda_stream
        rc = fns[rhs2.dtype](M.data_ptr(), dinv.data_ptr(),
                             rhs2.data_ptr(), x02.data_ptr(),
                             out.data_ptr(), B, n, int(iters),
                             float(tol) * float(tol), tile, stream)
    if rc != 0:
        raise RuntimeError(f"pallas_cg_solve: CUDA launch failed ({rc}: "
                           f"{err_str(rc).decode()})")
    pallas_cg_solve.launches += 1
    return out[0] if rhs.dim() == 1 else out


# Times the kernel was launched (one per call on CUDA tensors).
pallas_cg_solve.launches = 0
