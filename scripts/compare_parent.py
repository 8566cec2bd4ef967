#!/usr/bin/env python3
"""The port at two commits, in turns, on one CUDA card: configs 1 (at
hybrid, single and double precision) and 2 (on 'inv'), 3 and 4 through
`solve`, the config-5 batch at 128 and 1024 lanes
through `solve_batch_shared` (and at 128 with a 1e-9 target,
`b128_fallback`, where the f64 fallback runs), `solve_batch` on 128
config-1 draws,
configs 1-3 and the batch at 128 on 'pallas_cg' (`config1_pcg`, ...,
`b128_pcg`) and configs 1-2, the batch at 128, `solve_batch` and the
consensus drivers on 'cg' (`config1_cg`, ..., `solve_batch_cg`,
`consensus_cg`, `consensus_mc_cg`: the first 64 lanes of the 1024), and
the partitioned and block-backend paths of `chip_smoke.py`: `consensus`
and `consensus_mc_1024` on a 1x1 mesh, `horizon_sharded_1024` under its
f64 plain and f32 gate settings, `horizon_spike_1024`, config 2
through `solve` on 'banded', and `rowshard_qp4096` through
`solve_rowsharded_hybrid` on a 1-rank data mesh.

    mkdir -p _scratch/parent
    git archive <parent commit> | tar -x -C _scratch/parent
    python3 scripts/compare_parent.py [--parent _scratch/parent]
                                      [--rounds 2] [--reruns 3]
                                      [--paths consensus,banded,...]
                                      [--unprofiled config2_cg,...]

Each side runs in its own process and imports admm_library_torch from
its own root (the unpacked parent, or this checkout), in turns: parent,
tree, tree, parent, ... (`--rounds` pairs). A process solves each path
once cold (its first run: the kernels, built before it, loaded; on the
tree's side the checks captured) and `--reruns` times more; in each side's first turn one more
solve of each path runs under torch.profiler: device busy time, the
idle share against that turn's median rerun, kernels, the host's
launch calls (kernel and CUDA graph launches) and its reads of the
card (stream synchronisations); where the checks hold conditional
nodes (the tree's CG paths), whose bodies' kernels a profile loses,
one more rerun with each replay between CUDA events instead: the
replays' device time and the idle share beside it. Each record also holds
the captured checks of its first run and reruns (`graph.CACHE.stats`
deltas: captures, replays, warm-ups, capture ms) and the nodes of every
graph the path left in the cache (`graph_nodes`: each graph's own nodes,
read from its kept template with libcuda's cuGraphGetNodes, plus the
nodes of its conditional bodies). Each side saves its
first run's x and status of every path under `_scratch/compare_parent/`,
and the summary holds max |x_tree - x_parent| and whether the statuses
and iterations are equal. Prints one JSON line per (side, turn, path),
one summary line per path (medians over every turn, the tree's median
rerun over the parent's), then the card's nvidia-smi name and power
limit. Each record also holds the passes of the phases' WHILE nodes
where the side counts them with tracing off (`while_passes`: a side
with utils/trace counts them only in traced graphs and records None,
since both sides run untraced and no rerun is timed with stamps) and
the host's reads of each rerun counted in Python
(`host_reads`: item, tolist, bool, float and int on CUDA tensors),
which needs no profiler and so covers the paths whose kernels the
profiler cannot hold. Needs a CUDA card; no JAX. `_scratch/` is
git-ignored, and copied to the card with the rest of the checkout.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("config1", "config1_single", "config1_double", "config2_inv",
         "config3", "config4", "b128", "b1024", "b128_fallback",
         "solve_batch", "consensus", "consensus_mc_1024",
         "horizon_f64_plain", "horizon_f32_gate", "horizon_spike_1024",
         "config2_banded", "rowshard_qp4096", "config1_pcg", "config2_pcg",
         "config3_pcg", "b128_pcg", "config1_cg", "config2_cg", "b128_cg",
         "solve_batch_cg", "consensus_cg", "consensus_mc_cg")
# A path named <base>_pcg or <base>_cg is <base> on that KKT backend.
BACKEND_SUFFIXES = {"_pcg": "pallas_cg", "_cg": "cg"}
SAVED = os.path.join(ROOT, "_scratch", "compare_parent")
# The host's calls that put work on the card, as CUPTI names them.
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cuGraphLaunch")
# The host's wait for the card at each read of a device value: host_syncs
# counts the host's reads.
HOST_SYNC_CALLS = ("cudaStreamSynchronize", "cuStreamSynchronize")


def _path(name, dev):
    """(solve function, problem, settings) of a path, built from the
    package on sys.path; the same inputs as chip_smoke.py's phases."""
    import numpy as np
    import torch
    import admm_library_torch as T
    f64 = torch.float64
    for suffix, backend in BACKEND_SUFFIXES.items():
        if name.endswith(suffix):
            base = {"config2": "config2_inv",
                    "consensus_mc": "consensus_mc_64"}.get(
                        name[:-len(suffix)], name[:-len(suffix)])
            fn, *args, s = _path(base, dev)
            return (fn, *args, s.replace(backend=backend))
    if name == "config3":
        from admm_library_torch.models.clohessy_wiltshire import (
            build_cw_rendezvous)
        rng = np.random.default_rng(0)
        s0 = np.array([100.0, -1000.0, 20.0, 0.1, 0.5, -0.05])
        s0[:3] += rng.uniform(-20, 20, 3)
        qp, _ = build_cw_rendezvous(s0, N=20, dtype=torch.float32,
                                    device=dev)
        return (T.solve, qp.astype(f64),
                T.Settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=50000))
    if name.startswith("config1"):
        from admm_library_torch.models.random_qp import (
            reference_random_box_qp)
        precision = {"config1": "hybrid", "config1_single": "single",
                     "config1_double": "double"}[name]
        return (T.solve, reference_random_box_qp(dev).astype(f64),
                T.Settings(eps_abs=1e-6, eps_rel=1e-6, backend="inv",
                           precision=precision))
    if name == "config4":
        from admm_library_torch.models.low_thrust import (
            build_low_thrust_socp)
        qp, spec = build_low_thrust_socp(
            np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1]), N=200,
            device=dev)
        return (T.solve, qp.astype(f64),
                T.Settings(eps_abs=1e-6, eps_rel=5e-8, band_block=spec.block,
                           max_iter=50000, rho_soc_scale=100.0,
                           stall_checks=16, backend="inv"))
    if name in ("b128", "b1024", "b128_fallback"):
        from admm_library_torch.models import monte_carlo as mc
        eps = 1e-9 if name == "b128_fallback" else 1e-6
        qp = mc.monte_carlo_mpc_from_s0(
            mc.reference_s0(int(name[1:].split("_")[0])), device=dev)[0]
        return (T.solve_batch_shared, qp.astype(f64),
                T.Settings(eps_abs=eps, eps_rel=eps))
    if name in ("consensus", "consensus_mc_1024", "consensus_mc_64",
                "config2_banded", "config2_inv"):
        from admm_library_torch.models.double_integrator import build_mpc_qp
        from admm_library_torch.models.partitioned import (
            partition_mpc, partition_mpc_from_s0, reference_s0)
        from admm_library_torch.parallel import (consensus, consensus_mc,
                                                 runtime)
        rng = np.random.default_rng(0)              # bench_mpc, seed 0
        s0 = np.concatenate([rng.uniform(-2, 2, 3),
                             rng.uniform(-0.2, 0.2, 3)])
        s = T.Settings(eps_abs=1e-6, eps_rel=1e-6, rho_edge_scale=30.0)
        if name == "consensus":
            qp, spec, _ = partition_mpc(s0, np.zeros(6), N=50, n_blocks=10,
                                        dim=3, device=dev)
            return (consensus.consensus_solve, qp, spec,
                    runtime.make_mesh(), s)
        if name.startswith("consensus_mc"):
            lanes = int(name.rsplit("_", 1)[1])
            qp, spec, _, _ = partition_mpc_from_s0(
                reference_s0()[:lanes], s0, np.zeros(6), N=50, n_blocks=10,
                dim=3, device=dev)
            return (consensus_mc.consensus_solve_mc, qp, spec,
                    runtime.make_mesh(), s)
        qp, spec = build_mpc_qp(s0, np.zeros(6), N=50, dim=3, device=dev)
        return (T.solve, qp.astype(f64),
                T.Settings(eps_abs=1e-6, eps_rel=1e-6, band_block=spec.block,
                           backend=name.split("_")[1]))
    if name.startswith("horizon"):
        from admm_library_torch.models import monte_carlo as mc
        from admm_library_torch.parallel import runtime
        from admm_library_torch.parallel.horizon import (
            mpc_row_time, partition_qp, solve_horizon_sharded)
        qp, spec, _ = mc.monte_carlo_mpc_from_s0(mc.reference_s0(1024),
                                                 device=dev)
        if name == "horizon_spike_1024":
            return (T.solve_batch_shared, qp.astype(f64),
                    T.Settings(eps_abs=1e-6, eps_rel=1e-6,
                               band_block=spec.block, backend="spike",
                               spike_parts=10))
        hp, hspec = partition_qp(qp, spec.block, 10,
                                 mpc_row_time(spec.N, spec.ns, spec.nu))
        if name == "horizon_f64_plain":
            s = T.Settings(eps_abs=1e-6, eps_rel=1e-6, precision="double",
                           scaling_iters=0, restart_every=0, stall_checks=0,
                           polish=False, eps_pinf=0.0, eps_dinf=0.0)
        else:
            s = T.Settings(max_iter=2000, precision="single", eps_abs=1e-5,
                           eps_rel=1e-5, restart_every=0, stall_checks=0,
                           polish=False)
        return (solve_horizon_sharded, hp, hspec, runtime.make_mesh(), s)
    if name == "rowshard_qp4096":
        from admm_library_torch.models.random_qp import random_box_qp
        from admm_library_torch.parallel import make_data_mesh
        from admm_library_torch.parallel.rowshard import (
            solve_rowsharded_hybrid)
        gen = torch.Generator(device=dev).manual_seed(0)
        qp = random_box_qp(gen, n=4096, m=8192, device=dev)
        return (solve_rowsharded_hybrid, qp.astype(f64), make_data_mesh(1),
                T.Settings(eps_abs=1e-6, eps_rel=1e-6, backend="cg"))
    if name == "solve_batch":
        from admm_library_torch.models.random_qp import random_box_qp
        gen = torch.Generator().manual_seed(0)
        lanes = [random_box_qp(gen, device=dev).astype(f64)
                 for _ in range(128)]
        qp = T.QPData(**{f: torch.stack([getattr(q, f) for q in lanes])
                         for f in ("P", "q", "A", "l", "u", "lam")},
                      cone=lanes[0].cone)
        return (T.solve_batch, qp,
                T.Settings(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000))
    raise ValueError(f"unknown path {name}")


class _HostReads:
    """Counts the host's reads of device values inside the block: calls
    of item, tolist, bool, float and int on CUDA tensors."""

    NAMES = ("item", "tolist", "__bool__", "__float__", "__int__")

    def __enter__(self):
        import torch
        self.count = 0
        self.own = {n: torch.Tensor.__dict__.get(n) for n in self.NAMES}
        for name in self.NAMES:
            setattr(torch.Tensor, name,
                    self._counted(getattr(torch.Tensor, name)))
        return self

    def _counted(self, fn):
        def read(t, *a, **k):
            if t.is_cuda:
                self.count += 1
            return fn(t, *a, **k)
        return read

    def __exit__(self, *exc):
        import torch
        for name, fn in self.own.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)


def _timed(fn, *args):
    """(fn(*args), seconds, the check cache's counters it added (replays
    are graph launches), the host's reads and, where the side's cache
    counts them, the passes of its phases' WHILE nodes)."""
    import torch
    from admm_library_torch.core import graph
    try:
        from admm_library_torch.utils import trace  # noqa: F401
        passes = lambda: None  # noqa: E731  (counted only when traced)
    except ImportError:
        passes = getattr(graph.CACHE, "while_passes", lambda: 0)
    before = dict(graph.CACHE.stats)
    torch.cuda.synchronize()
    passes0 = passes()
    with _HostReads() as reads:
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    stats = {k: graph.CACHE.stats[k] - before[k] for k in before}
    return out, secs, dict(stats, host_reads=reads.count,
                           while_passes=(None if passes0 is None
                                         else passes() - passes0))


def _graph_nodes():
    """Nodes of each graph of the check cache, by entry (its place and
    kind) and variant: the graph's own nodes (its kept template) plus
    those of its conditional bodies, counted at their capture."""
    import ctypes
    from admm_library_torch.core import graph
    cuda = ctypes.CDLL("libcuda.so.1")
    out = {}
    for i, (key, entry) in enumerate(graph.CACHE.entries.items()):
        for variant, g in entry.graphs.items():
            n = ctypes.c_size_t(0)
            rc = cuda.cuGraphGetNodes(ctypes.c_void_p(g.raw_cuda_graph()),
                                      None, ctypes.byref(n))
            if rc != 0:
                raise RuntimeError(f"cuGraphGetNodes returned {rc}")
            out[f"{i}:{key[0]} {variant}"] = (
                n.value + getattr(entry, "body_nodes", {}).get(variant, 0))
    return out


def _profiled(fn, *args):
    """Device busy ms, kernels and host launch calls of one run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn(*args)
        torch.cuda.synchronize()
    events = p.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [e for e in events if e.device_type() == cuda]
    return dict(
        device_busy_ms=sum(e.duration_ns() for e in ops) / 1e6,
        kernels=sum(not e.name().startswith(("Memcpy", "Memset"))
                    for e in ops),
        host_launches=sum(e.device_type() != cuda
                          and e.name().startswith(HOST_LAUNCH_CALLS)
                          for e in events),
        host_syncs=sum(e.device_type() != cuda
                       and e.name().startswith(HOST_SYNC_CALLS)
                       for e in events))


def worker(root, side, turn, reruns, profiled, paths, unprofiled=()):
    """One side's turn: every path cold, then reruns, then (first turn,
    unless the path is in `unprofiled`) profiled. One JSON line per
    path."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, root)
    import torch
    import admm_library_torch  # noqa: F401  (turns TF32 off)
    from admm_library_torch.core import graph
    from admm_library_torch.ops import _build
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    # Each graph keeps its template, so that its nodes can be counted
    # (host memory only).
    graph.CACHE.keep_graphs = True
    _build.build()          # nvcc at most once a side, before any clock
    for name in paths:
        fn, *args = _path(name, dev)
        graph.CACHE.clear()         # each path's first run from no entry
        torch.cuda.reset_peak_memory_stats()
        sol, first, graph_first = _timed(fn, *args)
        reruns_ = [_timed(fn, *args) for _ in range(reruns)]
        walls = [r[1] for r in reruns_]
        rec = dict(side=side, turn=turn, path=name, first_s=first,
                   rerun_s=walls, iters=int(sol.iters.max()),
                   solved=int((sol.status == 1).sum()),
                   lanes=int(sol.status.numel()), graph_first=graph_first,
                   graph_reruns={k: sum(r[2][k] for r in reruns_)
                                 for k in graph_first},
                   host_reads=[r[2]["host_reads"] for r in reruns_],
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   graph_nodes=_graph_nodes())
        if hasattr(sol, "cg_steps"):
            rec["cg_steps"] = int(sol.cg_steps)
        bodies = sum(n for e in graph.CACHE.entries.values()
                     for n in getattr(e, "body_nodes", {}).values())
        if bodies:
            # Graphs with conditional nodes: a profile loses the kernels
            # in their bodies, so the device time of a rerun's replays
            # (CUDA events around each) stands in for busy.
            graph.CACHE.replay_events = []
            _, wall, _ = _timed(fn, *args)
            ms = graph.CACHE.replay_ms()
            graph.CACHE.replay_events = None
            rec.update(body_nodes=bodies, replay_device_ms=ms,
                       replay_idle_share=1.0 - ms / 1e3 / wall)
        if profiled:
            if name not in unprofiled and not bodies:
                prof = _profiled(fn, *args)
                rec.update(prof, idle_share=1.0 - prof["device_busy_ms"]
                           / 1e3 / statistics.median(walls),
                           host_launches_per_iteration=prof[
                               "host_launches"] / rec["iters"])
            os.makedirs(SAVED, exist_ok=True)
            torch.save({"x": sol.x.cpu(), "status": sol.status.cpu(),
                        "iters": sol.iters.cpu()},
                       os.path.join(SAVED, f"{side}_{name}.pt"))
        print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "_scratch",
                                                     "parent"))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reruns", type=int, default=3)
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--unprofiled", default="",
                    help="paths run without the profiled solve (the "
                    "profiler records every kernel: an eager 'cg' solve "
                    "of config 2 launches millions)")
    ap.add_argument("--worker", nargs=3, metavar=("ROOT", "SIDE", "TURN"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--profiled", action="store_true",
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    paths = a.paths.split(",")
    if a.worker:
        root, side, turn = a.worker
        worker(root, side, int(turn), a.reruns, a.profiled, paths,
               [p for p in a.unprofiled.split(",") if p])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_parent: no CUDA device", file=sys.stderr)
        return 2
    parent = os.path.abspath(a.parent)
    if not os.path.isdir(os.path.join(parent, "admm_library_torch")):
        print(f"compare_parent: no admm_library_torch under {parent}; "
              "unpack the parent there with git archive", file=sys.stderr)
        return 2
    roots = {"parent": parent, "tree": ROOT}
    order = []
    for r in range(a.rounds):
        pair = ("parent", "tree") if r % 2 == 0 else ("tree", "parent")
        order += [(side, r) for side in pair]
    records = []
    for side, turn in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker",
               roots[side], side, str(turn), "--reruns", str(a.reruns),
               "--paths", a.paths, "--unprofiled", a.unprofiled]
        if turn == 0:
            cmd.append("--profiled")
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1800, cwd=roots[side])
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                records.append(json.loads(line))
    for name in paths:
        summary = {"summary": name}
        for side in roots:
            recs = [r for r in records if r["side"] == side
                    and r["path"] == name]
            summary[side] = dict(
                first_s=statistics.median(r["first_s"] for r in recs),
                rerun_s=statistics.median(w for r in recs
                                          for w in r["rerun_s"]),
                iters=sorted({r["iters"] for r in recs}),
                cg_steps=sorted({r["cg_steps"] for r in recs
                                 if "cg_steps" in r}),
                device_busy_ms=[r["device_busy_ms"] for r in recs
                                if "device_busy_ms" in r],
                idle_share=[r["idle_share"] for r in recs
                            if "idle_share" in r],
                host_launches_per_iteration=[
                    r["host_launches_per_iteration"] for r in recs
                    if "host_launches_per_iteration" in r],
                host_launches=[r["host_launches"] for r in recs
                               if "host_launches" in r],
                host_syncs=[r["host_syncs"] for r in recs
                            if "host_syncs" in r],
                host_reads=sorted({n for r in recs
                                   for n in r["host_reads"]}),
                graph_launches_per_rerun=sorted({
                    r["graph_reruns"]["replays"] / len(r["rerun_s"])
                    for r in recs if r["rerun_s"]}),
                replay_device_ms=[r["replay_device_ms"] for r in recs
                                  if "replay_device_ms" in r],
                replay_idle_share=[r["replay_idle_share"] for r in recs
                                   if "replay_idle_share" in r],
                graph_first=recs[0]["graph_first"],
                graph_reruns=recs[0]["graph_reruns"],
                graph_nodes=recs[0]["graph_nodes"],
                peak_memory_bytes=max(r["peak_memory_bytes"]
                                      for r in recs))
        summary["rerun_tree_over_parent"] = (summary["tree"]["rerun_s"]
                                             / summary["parent"]["rerun_s"])
        saved = [torch.load(os.path.join(SAVED, f"{side}_{name}.pt"))
                 for side in roots]
        summary.update(
            x_max_abs_diff=float((saved[1]["x"].double()
                                  - saved[0]["x"].double()).abs().max()),
            status_equal=bool(torch.equal(saved[0]["status"],
                                          saved[1]["status"])),
            iters_equal=bool(torch.equal(saved[0]["iters"],
                                         saved[1]["iters"])))
        print(json.dumps(summary), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
