#!/usr/bin/env python3
"""Where a step of kernel 2's resident design spends its time.

    python3 scripts/pcg_phase_breakdown.py [--cases flagship_b1,cw_b1]

Builds csrc/pallas_cg.cu with -DPCG_PROFILE into a temporary directory:
thread 0 of block 0 adds the clock64() cycles of each phase of each CG
step (the product, the first block reduction and its stores into the
slots, barrier 1, alpha and the update with the second reduction,
barrier 2, beta and the stores of p, barrier 3), the start and the end.
For each of chip_smoke's `cg_kernel` cases, f32 and f64, and each
cluster size whose blocks fit (at the card's plan's lane tile where
that fits, else 1): one launch's cycles per step by phase, the steps
run, and the profiled build's median time by CUDA events. One JSON line
per case and plan, then the nvidia-smi name and power limit.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from admm_library_torch.ops import _build, pallas_cg as pcg  # noqa: E402

PHASES = ("start", "product", "sum1", "barrier1", "update", "barrier2",
          "p", "barrier3", "end")


def load_profiled(build_dir):
    src = os.path.join(_build.CSRC_DIR, "pallas_cg.cu")
    out = os.path.join(build_dir, "libpallas_cg_profile.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DPCG_PROFILE",
                    "-o", out, src], check=True)
    lib = ctypes.CDLL(out)
    lib.admm_pcg_profile.argtypes = [ctypes.POINTER(ctypes.c_longlong),
                                     ctypes.c_int]
    lib.admm_pcg_profile.restype = ctypes.c_int
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pcg_phase_breakdown: no CUDA device", file=sys.stderr)
        return 2
    import admm_library_torch  # noqa: F401  (turns TF32 off)
    dev = torch.device("cuda", 0)
    want = set(filter(None, args.cases.split(",")))
    with tempfile.TemporaryDirectory() as tmp:
        lib = load_profiled(tmp)
        pcg._c_entry = pcg.bind(lib)
        counts = (ctypes.c_longlong * (len(PHASES) + 1))()

        def read(reset=True):
            rc = lib.admm_pcg_profile(counts, int(reset))
            if rc != 0:
                raise RuntimeError(f"profile read failed ({rc})")
            return list(counts)

        for case, M32, rhs32, iters, tol in cs.pcg_cases(dev):
            if want and case not in want:
                continue
            for dtype in (torch.float32, torch.float64):
                Mt, rt = M32.to(dtype), rhs32.to(dtype)
                B, n = rt.shape
                isz = Mt.element_size()
                kw = dict(iters=iters, tol=tol)
                chosen = pcg.device_plan(B, n, isz, 0)
                for C in pcg.CLUSTERS:
                    t = chosen[2] if pcg.resident_smem_bytes(
                        C, chosen[2], n, isz) <= pcg.SMEM_LIMIT else 1
                    if pcg.resident_smem_bytes(C, t, n, isz) > \
                            pcg.SMEM_LIMIT:
                        continue
                    plan = ("resident", C, t)
                    ms = cs.cuda_ms(lambda: pcg.pallas_cg_solve_planned(
                        Mt, rt, plan=plan, **kw))
                    torch.cuda.synchronize()
                    read()
                    pcg.pallas_cg_solve_planned(Mt, rt, plan=plan, **kw)
                    torch.cuda.synchronize()
                    c = read()
                    steps = max(c[-1], 1)
                    per_step = {ph: c[i] / steps for i, ph in
                                enumerate(PHASES) if ph not in
                                ("start", "end")}
                    total = sum(per_step.values())
                    print(json.dumps({
                        "case": f"{case}_{str(dtype).split('.')[-1]}",
                        "B": B, "n": n, "plan": list(plan),
                        "chosen": list(chosen), "steps": c[-1], "ms": ms,
                        "start_cycles": c[0], "end_cycles": c[PHASES.index(
                            "end")],
                        "cycles_per_step": per_step,
                        "share": {k: v / total for k, v in
                                  per_step.items()}}), flush=True)
    print(cs.phase_device())
    return 0


if __name__ == "__main__":
    sys.exit(main())
