#!/usr/bin/env python3
"""The readings that the limits of the comparison are set from: one cell
over many seeds in one process (the set-up, its build and its capture
paid once), each a short window at the cell's own load, printing for
each seed the numbers compared and the end-to-end metrics as one JSON
line.

    python3 benchmark/readings.py --workload rdv.mc1024 \
        --seeds 101,102,103 --seconds 3 [--control]

`--control` runs the configuration's control in the program's place:
the program's own lower-precision path (`precision="single"`: the whole
solve in the problem's float32, no f64 test), which has to come out
not correct. Not part of a benchmark run.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CONTROL = {"precision": "single"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        notes = []
        result, rec = harness.run(
            args.workload, seed, args.seconds, False,
            settings_change=CONTROL if args.control else None,
            log=notes.append)
        print(json.dumps(dict(
            workload=args.workload, seed=seed, control=args.control,
            correct=result["correct"], attempted=result["attempted"],
            failed=result["failed"], calls=len(rec.calls_ms),
            iters=[min(rec.iters), max(rec.iters)],
            compared={k: v["value"] for k, v in result["compared"].items()},
            metrics={k: v["value"] for k, v in result["metrics"].items()},
            seconds=time.perf_counter() - t0,
            notes=[n for n in notes if not n.startswith("deterministic")])),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
