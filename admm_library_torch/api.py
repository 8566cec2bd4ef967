"""Public solver API. So far only the backend choice; `solve` and
`solve_batch` are still to be ported (the shared-matrix batch entry
point is parallel.batch.solve_batch_shared)."""
from __future__ import annotations

import torch

from .settings import Settings


def resolve_backend(settings: Settings, device) -> str:
    """Map backend='auto' to a concrete backend for `device`.

    On a CUDA device 'inv' (each KKT solve is one product, and the fused
    kernel takes M⁻¹); elsewhere dense Cholesky — the JAX package's
    choice off the TPU.
    """
    if settings.backend != "auto":
        return settings.backend
    return "inv" if torch.device(device).type == "cuda" else "chol"
