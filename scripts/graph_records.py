#!/usr/bin/env python3
"""Whether torch.profiler records every replay of a captured check, on one
CUDA card.

    python3 scripts/graph_records.py

Solves the config-5 batch at 128 lanes (`solve_batch_shared`, eps 1e-6)
from an empty check cache six times. After each solve it counts each
graph's nodes from its kept template (`chip_smoke._graph_nodes`), then
three times replays every graph under torch.profiler and counts the
device operations of each replay by the correlation id of its
cudaGraphLaunch, with one profiled solve after each of those sessions.
Prints one JSON line with every session's counts, a summary line (the
sessions in which some graph's replay recorded no device operation) and
the nvidia-smi name and power limit.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from admm_library_torch import Settings, solve_batch_shared  # noqa: E402
from admm_library_torch.core import graph  # noqa: E402
from admm_library_torch.models import monte_carlo as mc  # noqa: E402


def profiled_ops():
    """Device operations of one replay of every graph in the cache, in
    cache order: (counts, graph launches recorded, graphs replayed)."""
    order = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for i, (key, entry) in enumerate(graph.CACHE.entries.items()):
            for variant, g in entry.graphs.items():
                g.replay()
                torch.cuda.synchronize()
                order.append(f"{i} {variant}")
    ev = p.profiler.kineto_results.events()
    launches = sorted((e.start_ns(), e.correlation_id()) for e in ev
                      if e.name().startswith(("cudaGraphLaunch",
                                              "cuGraphLaunch")))
    ops = {}
    for e in ev:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ops[e.correlation_id()] = ops.get(e.correlation_id(), 0) + 1
    counts = {n: ops.get(c, 0) for n, (_, c) in zip(order, launches)}
    return counts, len(launches), len(order)


def main():
    graph.CACHE.keep_graphs = True
    dev = torch.device("cuda", 0)
    torch.use_deterministic_algorithms(True)
    qp = mc.monte_carlo_mpc_from_s0(mc.reference_s0(128), device=dev)[0]
    qp = qp.astype(torch.float64)
    s = Settings(eps_abs=cs.EPS, eps_rel=cs.EPS)
    rows = []
    for trial in range(6):
        graph.CACHE.clear()
        solve_batch_shared(qp, s)
        nodes = cs._graph_nodes()
        for rep in range(3):
            counts, nl, no = profiled_ops()
            rows.append(dict(trial=trial, rep=rep, prof=list(counts.values()),
                             launches=nl, graphs=no,
                             nodes=list(nodes.values())))
            # A profiler session between two counts; its solve captures
            # the variants that the first solve met once.
            cs._profiled(solve_batch_shared, qp, s)
    print(json.dumps(dict(diag="graph_nodes_vs_profiled_ops", rows=rows)))
    zero = sum(min(r["prof"]) == 0 for r in rows)
    print(json.dumps(dict(diag="summary", sessions=len(rows),
                          sessions_with_a_zero_graph=zero,
                          nodes_min=min(min(r["nodes"]) for r in rows))))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
