#!/usr/bin/env python3
"""Where kernel 1's time goes, and what its accumulator type does, on one
CUDA card.

    python3 scripts/fused_phase_breakdown.py

Builds variants of csrc/fused_iterate.cu (text edits of the current
source, into a temporary directory) and times each at the main path's
shapes, k=25: `full` (the kernel as it is), `no_products` (barriers and
summing phases only) and `no_summing` (product phases and barriers
only); the last two compute garbage and are timed only. Then the full
kernel with its accumulator forced to f32 (`acc_f32`) or to f64
(`acc_f64`) at every batch size, with each one's largest error against
the f64 twin, and the config-5 batch at 128 and 1024 solved with each
accumulator choice (lockstep iterations and the largest f64 KKT
residuals). One JSON line per case, then the nvidia-smi name and power
limit.
"""
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from admm_library_torch import Settings, solve_batch_shared  # noqa: E402
from admm_library_torch.models import monte_carlo as mc  # noqa: E402
from admm_library_torch.ops import _build, fused  # noqa: E402
from admm_library_torch.utils.oracle import kkt_residuals  # noqa: E402


def _kernel_body(src):
    return src[src.index("fused_iterate(Args a) {"):]


def no_products(src):
    body = _kernel_body(src)
    return src.replace(body, re.sub(r"if \((TA|TN)\.valid\)\n(\s+)product",
                                    r"if (0)\n\2product", body))


def no_summing(src):
    body = _kernel_body(src)
    return src.replace(body, re.sub(r"\n(\s+)(finish_n<|finish_zt\()",
                                    r"\n\1if (0) \2", body))


def _bind(path):
    lib = ctypes.CDLL(path)
    fn = lib.admm_fused_iterate_f32
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr] * 17 + [i32] * 7 + [f32] * 3
                   + [i32, i32, ptr, i32, ptr])
    fn.restype = ctypes.c_int
    lib.admm_fused_device_limits.argtypes = [i32, ptr, ptr]
    lib.admm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.admm_cuda_error_string.restype = ctypes.c_char_p
    return (fn, lib.admm_fused_device_limits, lib.admm_cuda_error_string)


def main():
    if not torch.cuda.is_available():
        print("fused_phase_breakdown: no CUDA device", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    src = open(os.path.join(ROOT, "admm_library_torch", "csrc",
                            "fused_iterate.cu")).read()
    entry = fused._entry()
    f64_batch = fused.F64_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, edit in (("no_products", no_products),
                           ("no_summing", no_summing)):
            path = os.path.join(tmp, f"{name}.cu")
            open(path, "w").write(edit(src))
            out = os.path.join(tmp, f"lib{name}.so")
            jobs[name] = (out, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, path]))
        entries = {"full": entry}
        for name, (out, proc) in jobs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed on variant {name}")
            entries[name] = _bind(out)

        def use(name, acc_batch=f64_batch):
            fused._c_entry = entries[name]
            fused.F64_BATCH = acc_batch
            fused.plan.cache_clear()

        variants = (("full", f64_batch), ("no_products", f64_batch),
                    ("no_summing", f64_batch), ("acc_f32", 0),
                    ("acc_f64", 1 << 30))
        cases = (("flagship_box_b128", cs._args_of(cs._flagship_inputs)),
                 ("flagship_box_b1024", cs._args_of(
                     lambda d: cs._flagship_inputs(d, 1024))),
                 ("flagship_box_b1", cs._args_of(
                     lambda d: cs._flagship_inputs(d, 1))),
                 ("low_thrust_soc_b1", cs._low_thrust_inputs))
        for case, make in cases:
            use("full")
            args, kw = make(dev)
            kw = dict(kw, k=25)
            ref64 = fused.fused_iterate_shared_reference(
                *(a.double() for a in args), **kw)
            rec = dict(case=case, B=args[8].shape[0], n=args[8].shape[1],
                       k=25)
            for name, acc_batch in variants:
                use(name if name in entries else "full", acc_batch)
                got = fused.fused_iterate_shared(*args, **kw)
                rec[f"{name}_ms"] = [cs.cuda_ms(
                    lambda: fused.fused_iterate_shared(*args, **kw))
                    for _ in range(2)]
                if name in ("full", "acc_f32", "acc_f64"):
                    rec[f"{name}_max_abs_err"] = max(
                        cs._leaf_diffs(got, ref64))
            print(json.dumps(rec), flush=True)
        for batch in (128, 1024):
            qp = mc.monte_carlo_mpc_from_s0(mc.reference_s0(batch))[0]
            qp = qp.astype(torch.float64)
            for name, acc_batch in variants[3:]:
                use("full", acc_batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sol = solve_batch_shared(qp, Settings(eps_abs=1e-6,
                                                      eps_rel=1e-6))
                torch.cuda.synchronize()
                r_p, r_d, _ = kkt_residuals(qp, sol.x, sol.z, sol.y)
                print(json.dumps(dict(
                    solve=f"config5_b{batch}", accumulator=name,
                    wall_s=time.perf_counter() - t0,
                    lockstep_iters=int(sol.iters.max()),
                    solved=int((sol.status == 1).sum()),
                    kkt_r_prim_max=float(r_p.max()),
                    kkt_r_dual_max=float(r_d.max()))), flush=True)
        use("full")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
