"""The one traffic generator: reads a workload's `draw` and makes, from
the seed and on the device, the initial states that the calls hand to
the program.

A draw perturbs the configuration's initial state, which enters only the
constraint bounds, so every call shares (P, q, A) and differs in (l, u):

- {"kind": "gaussian", "center": [...], "scale": [...]}: center + scale
  * N(0, 1) per component (the dispersion of
  admm_library_torch/models/monte_carlo.disperse_s0);
- {"kind": "uniform", "center": [...], "half_width": [...]}: center +
  U(-half_width, half_width) per component.

`draws(workload, seed, device)` returns (warm, pool): `warm_calls`
calls' worth for the set-up and `pool_calls` for the window, which walks
through the pool in order and starts again at its end. Each is a tensor
(calls, lanes, components) in float32.
"""
from __future__ import annotations

import torch


def _draw(spec: dict, gen, shape, device):
    center = torch.tensor(spec["center"], dtype=torch.float32, device=device)
    if spec["kind"] == "gaussian":
        scale = torch.tensor(spec["scale"], dtype=torch.float32,
                             device=device)
        noise = torch.randn(shape + center.shape, generator=gen,
                            dtype=torch.float32, device=device)
        return center + noise * scale
    if spec["kind"] == "uniform":
        half = torch.tensor(spec["half_width"], dtype=torch.float32,
                            device=device)
        unit = torch.rand(shape + center.shape, generator=gen,
                          dtype=torch.float32, device=device)
        return center + (2.0 * unit - 1.0) * half
    raise ValueError(f"unknown draw kind {spec['kind']!r}")


def draws(workload: dict, seed: int, device):
    """(warm, pool) initial states from `seed`, made on `device` with a
    generator of that device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    lanes = workload["lanes"]
    pool = _draw(workload["draw"], gen, (workload["pool_calls"], lanes),
                 device)
    warm = _draw(workload["draw"], gen, (workload["warm_calls"], lanes),
                 device)
    return warm, pool
