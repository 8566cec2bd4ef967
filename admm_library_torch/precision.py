"""Precision policy: exact f32 products, and the f32 -> f64 hand-off.

The JAX package pins every solver dot product to exact f32 because a
reduced-precision product gave a KKT factor with ||I - M^-1 M|| > 1 and
ADMM diverged. On an NVIDIA card the same trap is TF32, which keeps
about three decimal digits. `exact_f32()` turns it off for cuBLAS and
cuDNN; the solver calls it when it is imported.
"""
from __future__ import annotations

import torch


def exact_f32() -> None:
    """Make every f32 matmul and convolution run in full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def clean64(v):
    """f64 copy with non-finite entries reset to zero: a poisoned f32
    phase must not poison the f64 stage it warm-starts."""
    v = v.to(torch.float64)
    return torch.where(torch.isfinite(v), v, 0.0)
