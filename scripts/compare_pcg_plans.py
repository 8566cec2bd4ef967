#!/usr/bin/env python3
"""Time kernel 2 (the Jacobi-PCG solve) under every launch plan its
shapes admit, in turns on one card.

    python3 scripts/compare_pcg_plans.py [--cases flagship_b1,cw_b1]

Cases are chip_smoke's `cg_kernel` cases (200 steps, tol 1e-9), each in
f32 and f64. Plans: the stream design at its planned lane tile, and the
resident design at every cluster size C and lane tile LT whose blocks
fit the card's shared memory. Each plan is timed (median of 10 launches
by CUDA events) in two rounds, the second in reverse order, and held
against the f64 twin. One JSON line per case, with the card's own plan
marked, then the nvidia-smi name and power limit.
"""
import argparse
import json
import os
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from admm_library_torch.ops import pallas_cg as pcg  # noqa: E402


def plans(B, n, itemsize):
    out = [cs.stream_plan(B, n, itemsize)]
    for C in pcg.CLUSTERS:
        for t in pcg.RESIDENT_TILES:
            if pcg.resident_smem_bytes(C, t, n, itemsize) <= pcg.SMEM_LIMIT:
                out.append(("resident", C, t))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_pcg_plans: no CUDA device", file=sys.stderr)
        return 2
    import admm_library_torch  # noqa: F401  (turns TF32 off)
    dev = torch.device("cuda", 0)
    want = set(filter(None, args.cases.split(",")))
    for case, M32, rhs32, iters, tol in cs.pcg_cases(dev):
        if want and case not in want:
            continue
        for dtype in (torch.float32, torch.float64):
            Mt, rt = M32.to(dtype), rhs32.to(dtype)
            B, n = rt.shape
            isz = Mt.element_size()
            kw = dict(iters=iters, tol=tol)
            ref = pcg.pallas_cg_solve_reference(Mt.double(), rt.double(),
                                                **kw)
            chosen = pcg.device_plan(B, n, isz, 0)
            ps = plans(B, n, isz)
            rows = {p: dict(ms=[]) for p in ps}
            for p in ps:
                got = pcg.pallas_cg_solve_planned(Mt, rt, plan=p, **kw)
                torch.cuda.synchronize()
                rows[p]["max_abs_err"] = cs.max_abs_diff([got], [ref])
                rows[p]["clusters_per_wave"] = (
                    pcg._max_clusters(0, p[1], p[2], n, isz)
                    if p[0] == "resident" else None)
            for order in (ps, ps[::-1]):
                for p in order:
                    rows[p]["ms"].append(cs.cuda_ms(
                        lambda p=p: pcg.pallas_cg_solve_planned(
                            Mt, rt, plan=p, **kw)))
            print(json.dumps({
                "case": f"{case}_{str(dtype).split('.')[-1]}", "B": B,
                "n": n, "plan": list(chosen),
                "plans": [dict(design=p[0], cluster=p[1], lane_tile=p[2],
                               **rows[p]) for p in ps]}), flush=True)
    print(cs.phase_device())
    return 0


if __name__ == "__main__":
    sys.exit(main())
