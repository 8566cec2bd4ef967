#!/usr/bin/env python3
"""What the host launches outside the CUDA graphs in a warm rerun of the
port's solves, on one CUDA card.

    python3 scripts/eager_launches.py [--paths config3,config4,b128]

For each path (the inputs of `scripts/compare_parent.py`): one solve to
fill the graph cache, then one rerun under torch.profiler. Each host
launch call (the names `compare_parent.py` counts) is matched to the
device operation it started by CUPTI's correlation id: a graph launch
counts as one, a kernel launch under its kernel's name. One JSON line
per path: the host launch calls, the graph launches, and the kernel
launches outside graphs by kernel name (most first), then the card's
nvidia-smi name and power limit. Needs a CUDA card; no JAX.
"""
import argparse
import collections
import json
import os
import subprocess
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import admm_library_torch  # noqa: E402,F401  (turns TF32 off)
from compare_parent import HOST_LAUNCH_CALLS, _path  # noqa: E402


def eager_launches(fn, *args):
    """(host launch calls, graph launches, Counter of the kernels
    launched outside graphs) of one run of fn(*args)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn(*args)
        torch.cuda.synchronize()
    events = p.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernel_of = {e.correlation_id(): e.name() for e in events
                 if e.device_type() == cuda}
    calls = [e for e in events if e.device_type() != cuda
             and e.name().startswith(HOST_LAUNCH_CALLS)]
    graphs = sum("Graph" in e.name() for e in calls)
    kernels = collections.Counter(
        kernel_of.get(e.correlation_id(), "<no device record>")[:90]
        for e in calls if "Graph" not in e.name())
    return len(calls), graphs, kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default="config3,config4,b128")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("eager_launches: no CUDA device", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    for name in a.paths.split(","):
        fn, *args = _path(name, dev)
        fn(*args)                       # captures every graph it meets
        calls, graphs, kernels = eager_launches(fn, *args)
        print(json.dumps(dict(path=name, host_launch_calls=calls,
                              graph_launches=graphs,
                              kernel_launches=calls - graphs,
                              kernels=kernels.most_common())), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
