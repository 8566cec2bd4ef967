#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the CUDA card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Makes the cell's inputs from the seed on
the card, warms up (the set-up, `setup_s`), runs the closed-loop window
for `--seconds`, checks the answers against the plain reference and
prints the result as the last line of standard output, one JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key. `--trace 1` reports the
cell's per-layer metrics in place of its end-to-end ones. Exits with 2
and prints no result without the CUDA devices the cell asks for, and
with 3 if a JAX module was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout.
CACHE = ROOT / ".bench_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    try:
        result, _ = harness.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), t_start=T_START)
    except harness.NoCard as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return 2
    found = harness.loaded_forbidden(sys.modules)
    if found:
        print(f"no result: modules of JAX or the JAX package were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
