#!/usr/bin/env python3
"""What a pass of a CUDA-graph WHILE node costs on the card beyond the
kernels of its body (core/graph.while_blocks, csrc/graph_cond.cu).

    python3 scripts/node_overhead.py [--kernels 8,64,370] [--passes 25]

For each body size k: one captured check whose body is k small
elementwise kernels on a (128, 450) f32 tensor (config 5's CG vectors)
run as a WHILE node of `passes` passes (the flag always true, so the
budget ends it), against one captured check that runs the same
passes x k kernels unrolled with no node. Each graph is replayed
`reps` times, timed with CUDA events; prints one JSON line per k with
both medians and the overhead per pass, then the nvidia-smi line.
Needs a CUDA card and nvcc; no JAX.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _median_ms(fn, reps):
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="8,64,370")
    ap.add_argument("--passes", type=int, default=25)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("node_overhead: no CUDA device", file=sys.stderr)
        return 2
    from admm_library_torch.core import graph
    dev = torch.device("cuda", 0)
    for k in (int(v) for v in a.kernels.split(",")):
        def body(c, steps):
            x = c["x"]
            for _ in range(k):
                x = x * 1.0000001
            return dict(x=x)

        def node_step(state, variant):
            out = graph.while_blocks(
                dict(x=state["x"]), lambda c: state["go"], body,
                [1] * a.passes)
            return dict(x=out["x"])

        def flat_step(state, variant):
            c = dict(x=state["x"])
            for _ in range(a.passes):
                c = dict(c, **body(c, 1))
            return dict(x=c["x"])
        state = dict(x=torch.ones(128, 450, device=dev),
                     go=torch.ones((), dtype=torch.bool, device=dev))
        rec = dict(kernels_per_body=k, passes=a.passes)
        for name, step in (("node", node_step), ("flat", flat_step)):
            cache = graph.CheckCache()
            loop = graph.CheckLoop(f"overhead_{name}", step, state, None,
                                   "cg", cache=cache)
            loop((False, False))            # warm-up, then captured
            rec[f"{name}_ms"] = _median_ms(lambda: loop((False, False)),
                                           a.reps)
        rec["overhead_us_per_pass"] = (1e3 * (rec["node_ms"] - rec["flat_ms"])
                                       / a.passes)
        print(json.dumps(rec), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
