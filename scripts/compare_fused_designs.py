#!/usr/bin/env python3
"""Time kernel 1 (the fused ADMM iteration) against an earlier design of
it, in turns on one card, at the main path's shapes.

    git show 898540c:admm_library_torch/csrc/fused_iterate.cu > old.cu
    python3 scripts/compare_fused_designs.py old.cu

`old.cu` is a source of kernel 1 with the C interface of its first
design (one GEMM launch per product): `admm_fused_iterate_f32` taking
15 pointers (A, Minv, M, q, rho, lam/rho, l, u, x, z, y and the rhs, xt,
r, w scratch), 7 ints, 3 floats, k, refine_steps and the stream. It is
built with the package's nvcc flags into a temporary directory. Cases,
k=25: config 5 at B=128, 1024 and 1 (config 2's shape through solve)
from chip_smoke's inputs, and config 4's replayed launch (B=1, n=2000).
Per case: median ms of each design over rounds of (current, earlier,
current, earlier), and each design's largest error against the f64
twin. One JSON line per case, then the nvidia-smi name and power limit.
"""
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
from admm_library_torch.ops import _build, fused  # noqa: E402


def load_earlier(src, build_dir):
    """The earlier design's entry point, as a function of the wrapper's
    arguments returning (x, z, y)."""
    out = os.path.join(build_dir, "libfused_earlier.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                   check=True)
    fn = ctypes.CDLL(out).admm_fused_iterate_f32
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [ptr] * 15 + [i32] * 7 + [f32] * 3 + [i32, i32, ptr]
    fn.restype = ctypes.c_int

    def run(A, Minv, M, q, rho_vec, lam, l, u, x, z, y, cone, sigma, alpha,
            k, refine_steps=1):
        B, n = x.shape
        m = z.shape[-1]
        mb, ml = cone.m_box, cone.m_l1
        lam_r = (lam / rho_vec[mb:mb + ml]).contiguous() if ml else lam
        xo, zo, yo = (t.clone() for t in (x, z, y))
        rhs, xt, r = (torch.empty_like(xo) for _ in range(3))
        w = torch.empty_like(zo) if cone.m_soc else None
        p = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        rc = fn(p(A), p(Minv), p(M), p(q), p(rho_vec),
                p(lam_r) if ml else None, p(l.expand(B, m).contiguous()),
                p(u.expand(B, m).contiguous()), p(xo), p(zo), p(yo),
                p(rhs), p(xt), p(r), p(w), B, n, m, mb, ml, cone.n_soc,
                cone.soc_dims[0] if cone.m_soc else 0, float(sigma),
                float(alpha), float(1.0 - alpha), int(k), int(refine_steps),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"earlier design: launch failed ({rc})")
        return xo, zo, yo
    return run


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        earlier = load_earlier(sys.argv[1], tmp)
        cases = (("flagship_box_b128", cs._args_of(cs._flagship_inputs)),
                 ("flagship_box_b1024", cs._args_of(
                     lambda d: cs._flagship_inputs(d, 1024))),
                 ("flagship_box_b1", cs._args_of(
                     lambda d: cs._flagship_inputs(d, 1))),
                 ("low_thrust_soc_b1", cs._low_thrust_inputs))
        for case, make in cases:
            args, kw = make(dev)
            kw = dict(kw, k=25)
            ref64 = fused.fused_iterate_shared_reference(
                *(a.double() for a in args), **kw)
            rec = dict(case=case, B=args[8].shape[0], n=args[8].shape[1],
                       m=args[9].shape[1], k=25, current_ms=[],
                       earlier_ms=[])
            for name, fn in (("current", fused.fused_iterate_shared),
                             ("earlier", earlier)):
                got = fn(*args, **kw)
                torch.cuda.synchronize()
                rec[f"{name}_max_abs_err"] = max(cs._leaf_diffs(got, ref64))
            for _ in range(2):
                for name, fn in (("current", fused.fused_iterate_shared),
                                 ("earlier", earlier)):
                    rec[f"{name}_ms"].append(
                        cs.cuda_ms(lambda: fn(*args, **kw)))
            print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
