#!/usr/bin/env python3
"""Where kernel 1's time goes on one CUDA card.

    python3 scripts/fused_phase_breakdown.py

Builds variants of csrc/fused_iterate.cu (text edits of the current
source, into a temporary directory) and times each at the main path's
shapes, k=25: `full` (the kernel as it is), then for the split design
(B up to F64_BATCH) `no_products` (barriers and summing phases only)
and `no_summing` (product phases and barriers only), and for the
cluster design (above it) `no_products` (the stages' FFMAs and copies
cut: epilogues and cluster barriers only), `no_epilogue` (the
elementwise steps cut), `no_fma` (the copies without the FFMAs) and
`no_copies` (the FFMAs on whatever the ring holds); the cut variants
compute garbage and are timed only, the full kernel's largest error
against the f64 twin is given beside its time. One JSON line per case,
then the nvidia-smi name and power limit.
"""
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from admm_library_torch.ops import _build, fused  # noqa: E402


def _kernel_body(src):
    return src[src.index("fused_iterate(Args a) {"):
               src.index("namespace big {")]


def _cluster_body(src):
    return src[src.index("namespace big {"):]


def _edit(src, body_of, pairs):
    body = body_of(src)
    new = body
    for old, repl in pairs:
        if new.count(old) != 1:
            raise RuntimeError(f"variant edit does not apply: {old!r}")
        new = new.replace(old, repl)
    return src.replace(body, new)


def no_products(src):
    """Both designs: the split design's product phases and the cluster
    design's stages (FFMAs and copies) cut."""
    body = _kernel_body(src)
    src = src.replace(body, re.sub(r"if \((TA|TN)\.valid\)\n(\s+)product",
                                   r"if (0)\n\2product", body))
    return _edit(src, _cluster_body, [(
        "const int chunks = (o.K + KC - 1) / KC;",
        "const int chunks = 0 * ((o.K + KC - 1) / KC);")])


def no_summing(src):
    body = _kernel_body(src)
    return src.replace(body, re.sub(r"\n(\s+)(finish_n<|finish_zt\()",
                                    r"\n\1if (0) \2", body))


def no_epilogue(src):
    return _edit(src, _cluster_body, [(
        "    epilogue<EPI>(a, b, c, s, ok, last);\n",
        "    if (s[0] == 12345.f) epilogue<EPI>(a, b, c, s, ok, last);\n")])


def no_fma(src):
    return _edit(src, _cluster_body, [(
        "      consume<NT>(Ls, Ls + LT * KC, acc, kg, ty, tx,\n"
        "                  (min(KC, o.K - c * KC) + 3) / 4);\n", "")])


def no_copies(src):
    return _edit(src, _cluster_body, [(
        "  bar_expect(full, 4 * STAGE);\n",
        "  bar_expect(full, 0);\n  if (k0 >= 0) return;\n")])


VARIANTS = {"no_products": no_products, "no_summing": no_summing,
            "no_epilogue": no_epilogue, "no_fma": no_fma,
            "no_copies": no_copies}


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
    lib.admm_fused_max_clusters.argtypes = [i32, ptr]
    lib.admm_fused_max_clusters.restype = ctypes.c_int
    return (fn, lib.admm_fused_device_limits, lib.admm_cuda_error_string,
            lib.admm_fused_max_clusters)


def main():
    if not torch.cuda.is_available():
        print("fused_phase_breakdown: no CUDA device", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    src = open(os.path.join(ROOT, "admm_library_torch", "csrc",
                            "fused_iterate.cu")).read()
    entry = fused._entry()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, edit in VARIANTS.items():
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

        def use(name):
            fused._c_entry = entries[name]

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
            for name in entries:
                use(name)
                got = fused.fused_iterate_shared(*args, **kw)
                rec[f"{name}_ms"] = [cs.cuda_ms(
                    lambda: fused.fused_iterate_shared(*args, **kw))
                    for _ in range(2)]
                if name == "full":
                    rec["full_max_abs_err"] = max(cs._leaf_diffs(got, ref64))
            print(json.dumps(rec), flush=True)
        use("full")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
