#!/usr/bin/env python3
"""Where the device time goes in the port's solves, on one CUDA card.

    python3 scripts/profile_torch.py [--cases b128,config4]

For each case: the wall-clock of one unprofiled solve (after a warm-up
solve), then one solve under torch.profiler: device busy time (the sum
of kernel times; the solve runs on one stream), the idle share of the
profiled wall-clock, the number of kernels launched, and the share of
busy time of each hand-written kernel. Cases: `b128` and `b1024` (the
config-5 Monte-Carlo batch, the JAX reference's dispersions, eps 1e-6)
and `config4` (the low-thrust SOCP, N=200, through solve at its bench
settings). One JSON line per case, then the card's nvidia-smi name and
power limit. Needs a CUDA card; no JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import admm_library_torch as T  # noqa: E402
from admm_library_torch.models import monte_carlo as mc  # noqa: E402
from admm_library_torch.models.low_thrust import (  # noqa: E402
    build_low_thrust_socp)

# Kernel names of the hand-written kernels (csrc/).
HAND_WRITTEN = {"fused_iterate": "fused_iterate_shared",
                "pcg": "pallas_cg_solve"}


def _case(name, dev):
    """(solve function, problem, settings) of a case."""
    if name in ("b128", "b1024"):
        qp = mc.monte_carlo_mpc_from_s0(mc.reference_s0(int(name[1:])),
                                        device=dev)[0]
        return (T.solve_batch_shared, qp.astype(torch.float64),
                T.Settings(eps_abs=1e-6, eps_rel=1e-6))
    if name == "config4":
        qp, spec = build_low_thrust_socp(
            np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1]), N=200,
            device=dev)
        return (T.solve, qp.astype(torch.float64),
                T.Settings(eps_abs=1e-6, eps_rel=5e-8, band_block=spec.block,
                           max_iter=50000, rho_soc_scale=100.0,
                           stall_checks=16, backend="inv"))
    raise ValueError(f"unknown case {name}")


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


def profile(name, dev):
    from torch.profiler import ProfilerActivity, profile as prof
    solve, qp, s = _case(name, dev)
    solve(qp, s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve(qp, s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        solve(qp, s)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    kernels = [e for e in p.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_kernel = {}
    for evt in p.key_averages():
        us = _device_us(evt)
        for key, label in HAND_WRITTEN.items():
            if key in evt.key and us > 0:
                by_kernel[label] = by_kernel.get(label, 0.0) + us
    return dict(case=name, wall_s=wall, profiled_wall_s=wall_prof,
                iters=int(sol.iters.max()),
                status=sorted({int(v) for v in sol.status.flatten()}),
                device_busy_ms=busy_us / 1e3,
                idle_share=1.0 - busy_us / 1e6 / wall_prof,
                kernels_launched=len(kernels),
                hand_written_share_of_busy={
                    k: v / busy_us for k, v in by_kernel.items()},
                hand_written_ms={k: v / 1e3 for k, v in by_kernel.items()})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="b128,config4")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for name in args.cases.split(","):
        print(json.dumps(profile(name, dev)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
