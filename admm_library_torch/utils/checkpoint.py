"""Checkpoint and resume.

Solver state is small — (x, z, y, rho) and a few counters — so a
checkpoint is one `np.savez` file, and resuming is the ordinary warm
start: ADMM re-converges from any primal-dual point, so a run can resume
on another card or split over another number of ranks. The file format
is the JAX package's (utils/checkpoint.py there): a checkpoint either
package writes loads in the other.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..models import model_device
from ..solution import Solution


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_state(path: str, sol_or_state, extra: dict | None = None) -> None:
    """Snapshot a Solution (or any mapping holding x, z, y[, rho]) to
    `path`. Tensors are copied to the host once; the file is written
    atomically (a temporary file, then a rename), so a crash while
    writing never corrupts the last good checkpoint."""
    if isinstance(sol_or_state, Solution):
        state = {"x": sol_or_state.x, "z": sol_or_state.z,
                 "y": sol_or_state.y, "rho": sol_or_state.rho,
                 "iters": sol_or_state.iters}
    else:
        state = dict(sol_or_state)
    if extra:
        state.update(extra)
    host = {k: _host(v) for k, v in state.items()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **host)
    os.replace(tmp, path)


def load_state(path: str, dtype: torch.dtype | None = None,
               device=None) -> dict:
    """A checkpoint as a dict of tensors (warm-start inputs), on the card
    unless `device` says otherwise; `dtype` recasts the floating ones."""
    device = model_device(device)
    with np.load(path) as data:
        out = {k: torch.from_numpy(np.array(data[k])) for k in data.files}
    return {k: v.to(device=device,
                    dtype=dtype if dtype is not None and v.is_floating_point()
                    else v.dtype)
            for k, v in out.items()}


def resume_warm_start(path: str, device=None):
    """(x0, z0, y0) warm-start triple from a checkpoint file. To resume
    a batch over another number of ranks, slice the lanes as
    `parallel.batch.shard_batch` does: the warm start is per lane,
    wherever the lane runs."""
    st = load_state(path, device=device)
    return st["x"], st["z"], st["y"]
