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
k-block. On the H100 those 3.3 MB (flagship n=450, m=456) fit only in
the 50 MB L2, so every product re-reads its shared matrix from L2. Its
design: each product is one launch of a tiled FFMA GEMM whose
shared-memory tiles let every L2 byte of a shared matrix feed 32 lanes;
the elementwise stages (rhs assembly, refinement, over-relaxation,
prox, dual update) ride in the GEMMs' prologue and epilogues so no
intermediate makes an extra pass through memory. Measured on the H100
(PERF.md §5), that leaves it far from both the L2 bandwidth and the f32
FMA peak: what bounds it is latency, with few warps per SM (60 blocks
at batch 128).

`fused_iterate_shared_reference` is the same math in plain PyTorch (the
JAX kernel's `_iter_math`). The wrapper uses it for CPU tensors only;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..problem import ConeSpec
from .prox import project_cone
from . import _build

_c_entry = None


def _entry():
    """The C entry point, with its argument types declared."""
    global _c_entry
    if _c_entry is None:
        lib = _build.load_library("fused_iterate")
        fn = lib.admm_fused_iterate_f32
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ptr] * 15 + [i32] * 7 + [f32] * 3
                       + [i32, i32, ptr])
        fn.restype = ctypes.c_int
        lib.admm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.admm_cuda_error_string.restype = ctypes.c_char_p
        _c_entry = (fn, lib.admm_cuda_error_string)
    return _c_entry


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
    fn, err_str = _entry()
    lam_r = _lam_over_rho(lam, rho_vec, cone).contiguous()
    xo, zo, yo = (t.clone() for t in (x, z, y))
    rhs, xt, r = (torch.empty_like(xo) for _ in range(3))
    w = torch.empty_like(zo) if cone.m_soc else None
    soc_dim = cone.soc_dims[0] if cone.m_soc else 0

    def p(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(p(A), p(Minv), p(M), p(q), p(rho_vec),
                p(lam_r) if cone.m_l1 else None, p(l), p(u),
                p(xo), p(zo), p(yo), p(rhs), p(xt), p(r), p(w),
                B, n, m, cone.m_box, cone.m_l1, cone.n_soc, soc_dim,
                float(sigma), float(alpha), float(1.0 - alpha), int(k),
                int(refine_steps), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_iterate_shared: CUDA launch failed ({rc}: "
            f"{err_str(rc).decode()})")
    fused_iterate_shared.launches += 1
    return xo, zo, yo


# Times the kernel was launched (one per call on CUDA tensors).
fused_iterate_shared.launches = 0
