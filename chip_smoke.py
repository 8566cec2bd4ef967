#!/usr/bin/env python3
"""Smoke run of admm_library_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed). Phases, one JSON line each:

1. build     — builds each csrc/*.cu with nvcc for sm_90a, all at once
               (ptxas register report): the two kernels and the
               conditional-node library;
2. device    — the card's name and the nvidia-smi name/power-limit line,
               whether torch has its own CUDA-graph IF node and the
               allocator calls that route a stream's allocations to a
               graph pool; a tiny graph of an IF and a WHILE node
               (core/graph.while_blocks, csrc/graph_cond.cu) replayed
               against the plain loop; a toy phase three deep
               (CheckLoop.run_checks: its WHILE node, an IF node a check
               variant, the check's own WHILE node, the refactor an IF
               node) replayed for several stop points and bounds,
               bitwise the same loop run plain on the card; kernel 1, a
               cooperative launch, inside an IF node, bitwise the eager
               launch, its launches counted on the card;
3. kernel    — the fused ADMM iteration kernel against its plain PyTorch
               twin on the same inputs, at the flagship shape (batch 128,
               1024 and 1, the last config 2's shape through solve; k=25,
               box rows, from a real Ruiz + 'inv' factor of the config-5
               problem), on a small L1 + uniform-SOC case, and
               on config 4's f32-phase inputs (batch 1, n=2000, m=2206,
               200 SOC(4) blocks: the arguments of a launch in the
               shared pass of its solve at the bench settings, SOC
               blocks at the tip and on the boundary; k = 1, 2 and
               25); each leaf's max error against its stated tolerance,
               a bitwise rerun, median times of the kernel, its twin and
               the products alone in cuBLAS, and the card's bound;
4. slice    — solve_batch_shared on the config-5 Monte-Carlo batch
               (horizon 50, dim 3: n=450, m=456) at batch 128 and 1024,
               using the JAX reference's own dispersions; every lane
               SOLVED, f64 KKT residuals <= 1e-6 (each lane's ratio to
               its own mixed threshold reported beside), lockstep
               iterations 350 ± 25, the kernel launched, a rerun bitwise
               identical;
5. cg_kernel — the Jacobi-PCG kernel against its twin, f32 and f64, on
               the flagship M of a real Ruiz + 'pallas_cg' factor of
               config 5 at batch 128 and 1 (200 steps, tol 1e-9), on
               a small SPD case with a zero-rhs lane and on config 3's
               M: the card's plan (M resident in a cluster's shared
               memory where it fits) and the stream design, each held
               to the error bars and timed in turns;
6. solve     — solve(..., backend='pallas_cg') on config 1 (the JAX
               reference's random_box_qp draw, n=100, m=200) and config
               2 (the rendezvous MPC of its bench, seed 0, n=450,
               m=456): SOLVED, f64 KKT residuals within the 1e-6 mixed
               criterion, 100 ± 25 and 750 ± 25 iterations, the kernel
               launched inside the captured check graphs, a rerun
               bitwise identical that captures nothing and is one graph
               launch with no host read (the shared pass at B=1, one
               program), each bitwise the same solve with every segment
               eager;
7. slice_pcg — the config-5 batch at 128 with backend='pallas_cg': every
               lane SOLVED, f64 KKT <= 1e-6, 350 ± 25 lockstep
               iterations, the kernel launched inside the captured
               check graphs, x within 5e-4 of the 'inv' path, a rerun
               bitwise identical that captures nothing, one graph launch
               and no host read, bitwise the same solve with every
               segment eager;
8. solve_l1_soc — solve on config 3 (the CW min-fuel LP of the
               reference bench, seed 0, n=60, m=66; the staged path) with
               'auto' (= 'inv') and with 'pallas_cg', and on config 4
               (the low-thrust SOCP, N=200: n=2000, m=2206; the batch-1
               shared pass through the fused kernel, then the f64
               continuation) at its bench settings: SOLVED, f64 KKT
               within the mixed criterion, the physics checks of the
               reference's model tests, the objective against the JAX
               reference on the CPU, the kernels launched, a rerun
               bitwise identical; wall-clock, the iterations of each
               stage and the polish attempts. Config 3 built in f64 is
               held to the model test's 1e-4 m. Then the f64 continuation
               alone from the reference's own entry point: SOLVED, and
               iterations within one chunk of the reference's.
9. banded   — config 2 through solve(..., backend='banded'): SOLVED,
               f64 KKT within the mixed criterion, 750 ± 25 iterations
               (the JAX reference on the CPU), the rollout bar, x within
               X_AGREE of the 'inv' solve, a rerun bitwise identical;
               resolve_backend on the card: 'inv' for configs 2 and 4 at
               their n, 'banded' at n = 4096; and the time of one KKT
               solve of config 2's f64 matrix on 'banded' and 'inv';
10. horizon_spike — the reference's horizon_spike_1024 cell: the config-5
               batch at 1024 through solve_batch_shared with
               backend='spike', 10 parts: every lane SOLVED, f64 KKT
               <= 1e-6, 350 ± 25 lockstep iterations, x within X_AGREE
               of phase 4's 'inv' solution, a rerun bitwise identical;
11. solve_batch — 128 independent config-1 problems (n=100, m=200, each
               with its own P and A from one seeded generator) through
               solve_batch at the reference test's tolerance (1e-8):
               every lane SOLVED within its f64 mixed criterion, 8 lanes
               held to _solve_core on the lane alone (status, iterations
               ± 25, x within 1e-6) and to solve (x within 1e-6), a
               rerun bitwise identical.
12. cg_paths — the matrix-free 'cg' backend, every loop captured (each
               check one graph, its CGs conditional nodes: a WHILE node
               of 8-step blocks whose stop test runs on the card):
               configs 1-3 through solve, the config-5 batch at 128
               through solve_batch_shared and 128 config-1 draws through
               solve_batch; every lane SOLVED within its f64 mixed
               criterion, iterations within 25 of the JAX reference's
               with 'cg' on the CPU (configs 1, 2 and solve_batch;
               configs 3 and 5, whose unconverged f32 CG solves follow
               the card's rounding, reported), x within X_AGREE of the
               'inv' solve, a rerun bitwise identical that captures
               nothing, every path bitwise the same solve with every
               segment eager; the host's reads of a rerun at most
               PHASE_READS, none per check, and on every path but config
               3 (the staged path) one graph launch and no host read;
               wall-clock, graph nodes (the
               conditional bodies' too) and capture ms, the segments of
               a rerun and the device time of its replays (CUDA events;
               no profiled run: a profile loses the kernels inside
               conditional bodies).

13. consensus — consensus_solve (parallel/consensus.py) on config 2's
               problem (seed 0) split into 10 horizon blocks, on a 1x1
               mesh on the card with no process group, at the bench's
               settings (eps 1e-6, rho_edge_scale 30): SOLVED at 1475 ±
               25 iterations (the JAX reference on the CPU), controls
               within X_AGREE of the monolithic f64 solve at eps 1e-9,
               the f32 phase's boundary copies of z bitwise equal, a
               rerun bitwise identical, bitwise the same solve with
               every segment eager; wall-clock of both runs and the
               device time of the rerun's replays;
14. consensus_mc — the reference's consensus_mc_1024 cell at full width
               (1024 scenarios, the JAX draw of the dispersions in
               models/consensus_mc_s0_seed0.npz): every lane SOLVED at
               1525 ± 25 lockstep iterations, per-lane min / median /
               max beside the reference's 1375 and 1525, controls of 8
               lanes within X_AGREE of their monolithic f64 solves, the
               copies and the rerun as in phase 13. Both print, for
               scale, phase 4's b1024 and phase 10's wall-clock.
14b. consensus_cg — phases 13 and 14 on 'cg' (consensus_mc at
               CONSENSUS_CG_LANES of the draw's lanes), their checks
               captured with the CGs as conditional nodes: every lane
               SOLVED, the f64 block KKT residuals within the mixed
               criterion, bitwise the same solve with every segment
               eager, a rerun bitwise identical, its host reads at most
               PHASE_READS.

15. data_axis — config 5 at 1024 through the data axis at one rank:
               shard_batch on make_data_mesh(1), solve_batch_shared(...,
               mesh=): bitwise phase 4's solve, the kernel launched, a
               rerun one graph launch with no host read;
16. rowshard — the reference's rowshard_qp4096 cell (n=4096, m=8192, f32
               data, eps 1e-6) on the port's own seeded draw, through
               solve_rowsharded_hybrid on a 1-rank data mesh, its loop
               as captured graphs (a check one graph, its CGs
               conditional nodes): SOLVED at the eager loop's 250
               iterations and 11,554 CG steps, f64 KKT within the mixed
               criterion (r/eps reported), z within 1e-5 of A x, reruns
               bitwise identical, the captured solve bitwise the eager
               one; captures, replays, warm-ups and capture ms of the
               first run and two reruns (the second captures nothing),
               nodes per graph, peak memory, the host's reads (of the
               eager solve, and of a rerun: at most PHASE_READS), the
               device time of a rerun's replays
               and iterations beside the TPU's on JAX's draw (no
               profiled run: a profile loses the kernels inside
               conditional bodies);
17. horizon_sharded — config 5 at 1024 (the JAX dispersions) in 10 time
               parts through solve_horizon_sharded on a 1x1 mesh: in f64
               under the reference test's plain settings every lane
               SOLVED at solve_batch_shared's iterations (backend
               'chol'), x within 1e-8 relative; in f32 under the
               reference gate's settings every lane SOLVED at 125 ± 25
               lockstep iterations (JAX on the CPU); reruns bitwise, each
               bitwise the same solve with every segment eager;
18. checkpoint — phase 4's b128 solution saved (utils/checkpoint), loaded
               back onto the card and resumed: SOLVED within one check;
19. graph    — the captured phases (core/graph.py) on configs 3 and 4,
               the config-5 batch at 128 and 1024 and at 128 with a 1e-9
               target (FALLBACK_EPS: the f64 fallback's IF node taken,
               its phase's iterations read from its loop's state),
               solve_batch, config 1 at 'single' and 'double', config 3
               on 'pallas_cg' and config 1 on 'cg', each from an empty
               cache and on a rerun: captures, graph launches, host
               reads, WHILE passes, warm-ups, capture ms, device
               operations per graph (the conditional bodies' beside) and
               the device time of a rerun's replays (no profile: a
               profile of a graph with conditional nodes faulted with an
               illegal address); a rerun captures and warms nothing,
               each program call of it (PROGRAM_CALLS: solve_batch_shared
               and api._solve_core) one graph launch with no host read,
               and launches at most GRAPH_RERUN_LAUNCHES graphs (configs
               3 and 4); every path bitwise the same solve with every
               segment eager, each kernel launched as often; for the
               batches the graphs that hold kernel 1 (in the phases'
               bodies). A
               replayed check bitwise the eager check from the same
               state, every variant, for an f64 chunk of config 4, a
               b128 re-centred round, consensus_mc_1024's f32 phase and
               horizon_spike_1024's.

Every solve above runs each phase as one captured graph where the
capture rule admits its backend ('inv', 'chol', 'banded', 'spike',
'pallas_cg', 'cg', and the row-sharded CG) and mesh (none, or 1 rank):
a WHILE node over its checks, the host reading nothing between them.
A whole solve_batch_shared or api._solve_core (solve_batch, solve at
'single' and 'double', and the shared pass of a box-only or SOC solve)
is one program, one graph launch with no host read: its rounds a
WHILE node, its f64 fallback an IF node, each phase a WHILE node
inside; its first run is its eager warm-up, then its capture.
Every captured path is held bitwise to the same solve with every
segment eager, each kernel launched as often. A kernel's launches count
the times it ran: one per eager launch, one per replay of a graph that
holds it at top level, and one per pass of a conditional body that
launches it (counted on the card). The script runs with utils/trace
off, so every bitwise check holds the graphs a caller replays; the
passes of the phases' WHILE nodes, which the card counts only in graphs
captured with tracing on, come from a traced first run and rerun of
each path of the graph phase, held bitwise to its untraced rerun (and
from the nested probe, run traced).
Phases 9-18 run no kernel of their own: their backends are plain
PyTorch, the forms the JAX package's lax.scan, vmap and shard_map map
to (phase 15 runs the fused kernel on its lanes).

Any failed check raises, so the script exits non-zero and prints no
result. Its last line is {"ok": true, "device": {...}}.
"""
import os

# Deterministic cuBLAS needs this before the first cuBLAS call.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import dataclasses  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

# The JAX reference on the CPU, config 5 at batch 128 and 1024 (its TPU
# run gave 325), as for configs 1-3.
REFERENCE_ITERS = 350
# The JAX reference with backend='pallas_cg' on the CPU: config 1 and 2
# through solve, config 5 at batch 128 through solve_batch_shared.
PCG_REFERENCE_ITERS = {"config1": 100, "config2": 750, "config5": 350}
ITER_SLACK = 25                # one check interval
# The JAX reference with backend='cg' on the CPU, on the data each cg
# path builds: configs 1-3 through solve, config 5 at batch 128 through
# solve_batch_shared (lockstep), BATCH_LANES config-1 draws through
# solve_batch at BATCH_EPS (lockstep). The f32 phases' CG solves never
# reach cg_tol (1e-9) in f32, so each runs all cg_max_iter steps and the
# trajectory follows the rounding of the products: on the card config 3
# takes 550 and config 5 350. Those two counts are reported and held to
# the same solve with every segment eager, as config 3's on 'pallas_cg';
# the others to ITER_SLACK.
CG_REFERENCE_ITERS = {"config1": 100, "config2": 750, "config3": 600,
                      "config5": 400, "solve_batch": 200}
CG_ITERS_HELD = ("config1", "config2", "solve_batch")
# The host's reads of a rerun on a captured path: the reference's
# `# host sync` reads of a stage's or a round's verdict, a few on every
# path (config 1 on 'pallas_cg' reads 2 times; no check reads).
PHASE_READS = 16
# Lanes of consensus_mc's draw that phase consensus_cg solves on 'cg'.
CONSENSUS_CG_LANES = 64
# The JAX reference on the CPU, through solve at the bench settings:
# config 3 (bench_cw, seed 0) with 'inv'. With 'pallas_cg' the count is
# reported and not held: no 200-step f32 CG solve of the f32 phase
# reaches its 1e-9 tolerance, so the chattering LP phase follows the
# rounding of each implementation (the port's twin on the CPU ends it
# at 400, the kernel on the H100 at 600), and polish then lands on the
# same vertex.
CW_REFERENCE_ITERS = 600
CW_DV_MAX = 1.0                # bench_cw's impulse bound
# Terminal miss of the propagated impulses. The reference's model test
# holds an f64-built CW problem to 1e-4 m (CW_PROPAGATE_TOL), which
# config 3 built in f64 is held to. The bench builds config 3 in f32,
# whose data rounding (~6e-8 relative) alone moves the target by
# ~3e-4 m at ‖s0‖ ~ 1 km (measured on the CPU, both packages at the
# same vertex; the f64 build misses by 1.6e-11 m there): that run is
# held to CW_PROPAGATE_RTOL of ‖s0‖∞.
CW_PROPAGATE_TOL = 1e-4
CW_PROPAGATE_RTOL = 1e-6
# Config 4 (bench_low_thrust), the JAX reference on the CPU: its shared
# pass hands the problem to the f64 continuation at 4,525 iterations
# (models/low_thrust_entry_seed0.npz); that continuation quits at 10,525
# with MAX_ITER after two chunks without a new best residual, a fault
# the port does not copy; its own chunk and polish programs, run on,
# land SOLVED at 16,525 with this objective. From zero the iteration
# count is reported, not held: the f32 shared pass chatters and ends
# where each implementation's rounding takes it (the port hands over at
# 9,825 on the CPU with two threads, and between 6,075 and 7,225 in
# chip runs on the H100 with two designs of the fused kernel; from
# there the continuation took one to seven chunks). From the
# reference's entry point it is held to one chunk (LT_CHUNK).
LT_REFERENCE_ITERS = 16525
LT_REFERENCE_OBJ = 1.0248775668290662
LT_OBJ_RTOL = 1e-4
LT_CHUNK = 2000
LT_U_MAX = 0.01                # bench_low_thrust's thrust bound, m/s^2
EPS = 1e-6
# Kernel vs twin. Both are held against the twin evaluated in f64 on
# the same f32 inputs. M = P + sigma I + A'RA is ill-conditioned at the
# flagship (sigma = 1e-5, rho boosted 100x on equality rows), so f32
# rounding in the M^-1 products is amplified by cond(M) in any f32
# implementation: measured on the H100, the cuBLAS twin itself is
# 2.6e-3 from f64 after 25 iterations. The kernel passes when each
# leaf's error is at most twice the f32 twin's own error in that leaf,
# or below the floor.
ERR_FACTOR, ERR_FLOOR = 2.0, 1e-5
LEAVES = ("x", "z", "y")
# The kernel launch of config 4's shared pass whose inputs the kernel
# phase replays: by then SOC blocks of the iterate sit both at the tip
# and on the boundary of their cones (a min-fuel optimum has no block
# strictly inside; l1_soc_b3 covers that branch).
LT_CAPTURE_LAUNCH = 40
# The PCG kernel in f64 against its f64 twin: two summation orders over
# 200 CG steps (measured 1.0e-10 on the flagship M, solution scale 2.3).
F64_ERR_FLOOR = 1e-8
# The card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet, at
# 700 W): f32 and f64 outside the tensor cores, and HBM3.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# Graph launches of a rerun with every phase one graph (its checks and
# refactors inside a WHILE node) and every whole solve one program,
# counted by the cache (`replays`, a graph one launch): config 3 (the
# staged path: the f32 phase's prologue, phase and epilogue, a polish;
# measured 4) and config 4 (the B=1 shared pass one program, 7
# continuation chunks of three launches, their polishes; measured 29).
# The host's launch calls are not counted: a profile of a graph with
# conditional nodes faulted with an illegal address on the card.
GRAPH_RERUN_LAUNCHES = {"config3": 8, "config4": 32}
# The paths of phase graph whose solve is whole-solve programs
# (graph.program), by the number of program calls of a solve: each call
# one graph launch and no host read in a rerun (`_check_program`).
# Config 4's shared pass is one; its continuation runs around it.
PROGRAM_CALLS = {"b128": 1, "b1024": 1, "b128_fallback": 1,
                 "solve_batch": 1, "config1_single": 1, "config1_double": 1,
                 "config4": 1}
# Phase graph's config-5 batches (kernel 1 in their graphs).
BATCH_PATHS = ("b128", "b1024", "b128_fallback")
# A target below the f32 rounds' floor, so that the f64 fallback runs
# (the JAX package's test of its fallback uses 1e-9).
FALLBACK_EPS = 1e-9
PEAK_HBM_BYTES = 3.35e12
# Two solved points of the same problem: each meets the 1e-6 residual
# criterion; the MPC states carry only a 1e-8 regularisation.
X_AGREE = 5e-4
# The JAX reference on the CPU: config 2 through solve on 'banded' (its
# 'auto' there), and horizon_spike (spike, 10 parts) at batch 128 and 1024.
BANDED_REFERENCE_ITERS = 750
SPIKE_REFERENCE_ITERS = 350
# solve_batch on independent config-1 problems, at the tolerance of the
# reference's test against solve (tests/test_solver.py, TOL).
BATCH_LANES, BATCH_EPS, BATCH_CHECKED = 128, 1e-8, 8
BATCH_X_AGREE = 1e-6
# Consensus ADMM over horizon blocks (the JAX reference on the CPU, the
# bench's settings: seed 0, N=50 in 10 blocks, eps 1e-6,
# rho_edge_scale=30): consensus_solve of config 2's problem SOLVED at
# 1475; consensus_mc_1024 every lane SOLVED at 1525 lockstep, per lane
# 1375 to 1525. Controls are held to the port's monolithic f64 solve at
# eps 1e-9 within X_AGREE, on CONSENSUS_LANES_HELD lanes of the batch.
CONSENSUS_REFERENCE_ITERS = 1475
CONSENSUS_MC_REFERENCE_ITERS = 1525
CONSENSUS_MC_REFERENCE_LANE_MIN = 1375
CONSENSUS_N, CONSENSUS_BLOCKS, CONSENSUS_EDGE_SCALE = 50, 10, 30.0
CONSENSUS_LANES_HELD = 8
MONO_EPS = 1e-9
# The duplicated boundary copies of x in a solution: each copy's edge
# rows meet the primal residual criterion (1e-6).
COPY_X_AGREE = 1e-5
# rowshard_qp4096 (the reference bench's bench_rowshard: n=4096, m=8192,
# f32, eps 1e-6, through solve_rowsharded_hybrid on a 1-rank data mesh).
# The port draws its own problem from the same distribution (JAX's draw
# would be ~200 MB to store). The TPU's count on JAX's draw is shown
# beside the port's, not held: another draw.
ROWSHARD_N, ROWSHARD_M = 4096, 8192
ROWSHARD_TPU_ITERS = 225
ROWSHARD_Z_AGREE = 1e-5
# The count of the port's eager loop on this draw in every chip run
# before the loop was captured (H100): the captured loop computes the
# same iterates.
ROWSHARD_PARENT_ITERS, ROWSHARD_PARENT_CG_STEPS = 250, 11554
# The horizon-sharded SPIKE driver on config 5 at 1024 (the JAX draw of
# the dispersions), 10 parts. In f64 under the reference test's plain
# settings (no Ruiz scaling, restart or stall exit) it is held lane by
# lane to the port's solve_batch_shared with the same settings on
# 'chol'. In f32 under the settings the reference's dry-run gate gives
# it (eps 1e-5, at most 2000 iterations, no restart or stall exit), JAX
# on the CPU solves every lane at 125 lockstep iterations.
HORIZON_PARTS = 10
HORIZON_PLAIN = dict(eps_abs=EPS, eps_rel=EPS, precision="double",
                     scaling_iters=0, restart_every=0, stall_checks=0,
                     polish=False, eps_pinf=0.0, eps_dinf=0.0)
HORIZON_GATE = dict(max_iter=2000, precision="single", eps_abs=1e-5,
                    eps_rel=1e-5, restart_every=0, stall_checks=0,
                    polish=False)
HORIZON_F32_REFERENCE_ITERS = 125
HORIZON_X_RTOL = 1e-8
# Terminal-state error of the simulated controls: dynamics rows hold to
# r_prim <= 1e-6 each, and over N=50 unit steps a velocity error
# integrates into position, so errors of up to ~N^2/2 * 1e-6 are
# consistent with a solved QP.
ROLLOUT_TOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() by CUDA events, one event pair per
    call."""
    import torch
    for _ in range(warmup):
        fn()
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


def bound(flops, nbytes, dtype="float32"):
    """(bound_ms, bound_by): the least time the card could take for work
    of `flops` operations on `dtype` inputs moving `nbytes`, the larger
    of the operation time and the byte time."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), (
        "operations" if t_ops >= t_bytes else "bytes")


def max_abs_diff(a, b):
    return max(float((p.double() - q.double()).abs().max())
               for p, q in zip(a, b))


# torch's calls that route a stream's allocations into a graph pool
# (core/graph.py routes a conditional body's with the first).
POOL_CALLS = ("_cuda_beginAllocateCurrentStreamToPool",
              "_cuda_endAllocateToPool", "_cuda_releasePool",
              "_cuda_beginAllocateToPool")


def _node_probe(dev):
    """A loop of unit blocks, n += steps while n < k, as conditional
    nodes of one captured check (blocks [1] * 6 + [2]: a WHILE node of
    at most 6 passes, then an IF node), replayed for several k and held
    to the plain loop. Returns the record."""
    import torch
    from admm_library_torch.core import graph
    blocks = [1] * 6 + [2]

    def step(state, variant):
        out = graph.while_blocks(
            dict(n=state["n0"]), lambda c: c["n"] < state["k"],
            lambda c, steps: dict(n=c["n"] + steps), blocks)
        return dict(n=out["n"])

    def plain(k):
        n = 0
        for steps in blocks:
            if not n < k:
                break
            n += steps
        return n
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    cache = graph.CheckCache()
    loop = graph.CheckLoop("node_probe", step,
                           dict(n0=zero, k=zero.clone(), n=zero.clone()),
                           None, "cg", cache=cache)
    got = {}
    for k in (0, 3, 6, 7, 20, 1):
        loop.set(dict(k=torch.tensor(k, device=dev)))
        loop((False, False))
        got[k] = int(loop.state["n"])
        check(got[k] == plain(k), f"device: the nodes ran n to {got[k]} "
              f"for k = {k}, the plain loop to {plain(k)}")
    check(cache.stats["captures"] == 1 and cache.stats["replays"] == 5,
          "device: the node probe was not captured once and replayed")
    entry, = cache.entries.values()
    return dict(node_probe=got, node_probe_body_nodes=entry.body_nodes[
        (False, False)])


def _nested_probe(dev):
    """A phase of a toy loop whose checks run a WHILE node of their own:
    the phase's WHILE node holds an IF node for each check variant, which
    holds a WHILE node of at most 4 unit blocks (m < it % 3 + 1), and an
    IF node for the refactor, three deep. Replayed for several stop
    points and max_iter bounds and held bitwise to the same loop run
    plain on the card, then its WHILE passes counted. Returns the
    record."""
    import torch
    from admm_library_torch import Settings
    from admm_library_torch.core import graph

    def step(state, variant):
        if variant == graph.REFACTOR:
            return dict(r=state["r"] * 3 + state["it"])
        restart, rho_test = variant
        it = state["it"]
        inner = graph.while_blocks(
            dict(m=torch.zeros_like(it)), lambda c: c["m"] < it % 3 + 1,
            lambda c, steps: dict(m=c["m"] + steps), [1] * 4)
        acc = state["acc"] * 7 + 2 * int(restart) + int(rho_test) + inner["m"]
        it = it + 1
        return dict(acc=acc, it=it, flags=torch.stack(
            [it < state["stop"], rho_test & (it % 2 == 0)]))

    def run(capture, stop, max_iter, cache):
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        state = dict(it=zero, acc=zero.clone(), r=zero.clone(),
                     stop=torch.tensor(stop, device=dev),
                     flags=torch.ones(2, dtype=torch.bool, device=dev))
        loop = graph.CheckLoop("node_probe_nested", step, state, None, "cg",
                               capture=capture, cache=cache)
        loop.run_checks(Settings(check_every=1, max_iter=max_iter,
                                 adaptive_rho_interval=2), 3)
        return [int(loop.state[k]) for k in ("it", "acc", "r")]

    from admm_library_torch.utils import trace
    cache = graph.CheckCache()
    cache.prepare_nodes(dev)
    got = {}
    # Traced: the card counts the WHILE passes only in a traced capture.
    trace.enable()
    try:
        for stop, max_iter in ((5, 20), (9, 20), (30, 13), (1, 20),
                               (12, 20), (7, 7)):
            want = run(False, stop, max_iter, None)
            got[f"{stop}/{max_iter}"] = have = run(True, stop, max_iter,
                                                   cache)
            check(have == want, f"device: the nested nodes ran to {have} "
                  f"(stop {stop}, max_iter {max_iter}), the plain loop to "
                  f"{want}")
    finally:
        trace.disable()
        trace.reset()
    entry, = cache.entries.values()
    (phase, nodes), = entry.body_nodes.items()
    check(len(phase.reachable) == 4, "device: the nested probe's phase does "
          "not hold the four check variants")
    return dict(nested_probe=got, nested_probe_body_nodes=nodes,
                nested_probe_captures=cache.stats["captures"],
                nested_probe_while_passes=cache.while_passes())


def _kernel1_if_probe(dev):
    """Kernel 1, a cooperative launch, inside an IF node of a captured
    segment: replayed with the flag on and off, its output bitwise the
    eager launch's, and its launches counted at the body's passes on
    the card."""
    import torch
    from admm_library_torch.core import graph
    from admm_library_torch.ops import fused
    args, kw = _args_of(lambda d: _flagship_inputs(d, 8))(dev)
    A, Minv, M, q, rho, lam, l, u, x, z, y = args
    kw = dict(kw, k=5)
    want = fused.fused_iterate_shared(*args, **kw)

    def step(state, variant):
        return graph.while_blocks(
            dict(x=state["x"], z=state["z"], y=state["y"]),
            lambda c: state["go"], lambda c, steps: dict(zip(
                "xzy", fused.fused_iterate_shared(
                    A, Minv, M, q, rho, lam, l, u, c["x"], c["z"], c["y"],
                    **kw))), [1])

    cache = graph.CheckCache()
    cache.prepare_nodes(dev)
    go = torch.ones((), dtype=torch.bool, device=dev)
    loop = graph.CheckLoop("kernel1_if_probe", step,
                           dict(x=x, z=z, y=y, go=go), None, "inv",
                           cache=cache)
    loop((False, False))                 # the warm-up, eager
    torch.cuda.synchronize()
    fused.fused_iterate_shared.launches = 0
    out = {}
    for flag in (True, False, True):
        loop.set(dict(x=x, z=z, y=y, go=torch.tensor(flag, device=dev)))
        loop((False, False))
        same = all(torch.equal(loop.state[k], w if flag else v)
                   for k, w, v in zip("xzy", want, (x, z, y)))
        check(same, f"device: kernel 1 in an IF body (flag {flag}) is not "
              "the eager launch")
        out[str(flag)] = same
    launches = fused.fused_iterate_shared.launches
    check(launches == 2, f"device: kernel 1 in an IF body counted "
          f"{launches} launches over two passes")
    return dict(kernel1_if_probe=out, kernel1_if_probe_launches=launches)


def phase_device(dev):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    # torch's own CUDA-graph IF node (absent from 2.11); the port builds
    # its nodes with csrc/graph_cond.cu.
    if_node = all(hasattr(torch.cuda.CUDAGraph, name) for name in (
        "get_currently_capturing_graph", "begin_capture_to_if_node",
        "end_capture_to_conditional_node"))
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi,
         cuda_graph_if_node=if_node,
         allocator_calls={n: hasattr(torch._C, n) for n in POOL_CALLS},
         **_node_probe(dev), **_nested_probe(dev), **_kernel1_if_probe(dev))
    return smi


def phase_build():
    from admm_library_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build(verbose=True)
    secs = time.perf_counter() - t0
    emit("build", seconds=secs, libraries={
        stem: dict(library=path.name, ptxas=[
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln])
        for stem, (path, log) in libs.items()})


def _flagship_inputs(dev, batch=128):
    """Phase-1 inputs of the config-5 main path at the given batch (1 is
    config 2's shape through solve)."""
    import torch
    from admm_library_torch import Settings
    from admm_library_torch.core import admm
    from admm_library_torch.core.scaling import ruiz_equilibrate
    from admm_library_torch.models import monte_carlo as mc
    from admm_library_torch.ops import kkt
    from admm_library_torch.parallel.batch import _s32_of_shared

    s = _s32_of_shared(Settings())
    s0 = mc.reference_s0(1024 if batch > 128 else 128)[:batch]
    qp, _, _ = mc.monte_carlo_mpc_from_s0(s0, device=dev)
    qps, _ = ruiz_equilibrate(qp, s.scaling_iters)
    rho = admm.rho_vec_of(torch.tensor(s.rho, device=dev),
                          admm.is_equality_row_shared(qps), s)
    fac = kkt.factor_condensed(qps.P, qps.A, s.sigma, rho, "inv")
    B = qps.l.shape[0]
    zeros = lambda w: torch.zeros((B, w), device=dev)  # noqa: E731
    return qps, s, rho, fac, (zeros(qps.n), zeros(qps.m), zeros(qps.m))


def _l1_soc_inputs(dev):
    """Box + bounded L1 + uniform SOC case (tests/test_fused.py)."""
    import numpy as np
    import torch
    from admm_library_torch import ConeSpec, QPData, Settings
    from admm_library_torch.core import admm
    from admm_library_torch.core.scaling import ruiz_equilibrate
    from admm_library_torch.ops import kkt

    rng = np.random.default_rng(3)
    n, mb, ml, nsoc, d = 20, 8, 6, 3, 4
    m = mb + ml + nsoc * d
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    l = np.full(m, -np.inf)
    u = np.full(m, np.inf)
    l[:mb], u[:mb] = -1.0, 1.0
    l[mb:mb + ml], u[mb:mb + ml] = -0.7, 0.7
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    qp = QPData(P=f32(R @ R.T + 0.5 * np.eye(n)),
                q=f32(rng.standard_normal(n)), A=f32(A), l=f32(l),
                u=f32(u), lam=torch.full((ml,), 0.3, device=dev),
                cone=ConeSpec(m_box=mb, m_l1=ml, soc_dims=(d,) * nsoc))
    s = Settings(precision="single")
    qps, _ = ruiz_equilibrate(qp, s.scaling_iters)
    rho = admm.rho_vec_of(torch.tensor(s.rho, device=dev),
                          admm.is_equality_row_shared(qps), s)
    fac = kkt.factor_condensed(qps.P, qps.A, s.sigma, rho, "inv")
    B = 3
    x = f32(rng.standard_normal((B, n)))
    z = torch.zeros((B, m), device=dev)
    return qps, s, rho, fac, (x, z, torch.zeros_like(z))


def _config4(dev):
    """BASELINE config 4 as the JAX bench builds it (bench_low_thrust):
    (f32 QPData, LowThrustSpec, Settings, s0)."""
    import numpy as np
    import torch
    from admm_library_torch import Settings
    from admm_library_torch.models.low_thrust import build_low_thrust_socp
    s0 = np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1])
    qp, spec = build_low_thrust_socp(s0, N=200, device=dev)
    s = Settings(eps_abs=EPS, eps_rel=5e-8, band_block=spec.block,
                 max_iter=50000, rho_soc_scale=100.0, stall_checks=16,
                 backend="inv")
    return qp, spec, s, torch.as_tensor(s0, dtype=torch.float64, device=dev)


class _Captured(Exception):
    """Stops a solve once a kernel launch's arguments are recorded."""


def _low_thrust_inputs(dev):
    """Config 4's f32-phase kernel inputs at batch 1: the arguments of
    launch LT_CAPTURE_LAUNCH of the kernel in solve's shared pass at the
    bench settings (the Ruiz-scaled data and 'inv' factor under
    _s32_of_shared, rho, and the lane's iterate, with a nonzero x). By
    then the iterate's SOC blocks sit both at the tip and on the
    boundary of their cones. (args, keyword arguments without k)."""
    import types
    import torch
    from admm_library_torch import solve
    from admm_library_torch.core import graph
    from admm_library_torch.parallel import batch

    qp, _, settings, _ = _config4(dev)
    ops, seen = batch.fused_ops, []

    def record(*a, **kw):
        seen.append(1)
        if len(seen) == LT_CAPTURE_LAUNCH:
            raise _Captured(a, kw)
        return ops.fused_iterate_shared(*a, **kw)

    # The shared pass reaches the kernel through batch.fused_ops only;
    # its segments run eagerly here (a captured check's launch is a call
    # only at its capture), computing what the captured solve computes.
    batch.fused_ops = types.SimpleNamespace(fused_iterate_shared=record)
    capturable = graph.capturable
    graph.capturable = lambda *a, **k: False
    try:
        solve(qp.astype(torch.float64), settings)
    except _Captured as c:
        args, kw = c.args
    else:
        raise SmokeFailure(f"config 4's shared pass made fewer than "
                           f"{LT_CAPTURE_LAUNCH} kernel launches")
    finally:
        batch.fused_ops = ops
        graph.capturable = capturable
    kw = dict(kw)
    del kw["k"]
    return args, kw


def _soc_kinds(z, cone):
    """How many of one lane's uniform SOC blocks of z sit at the tip, on
    the boundary and inside the cone (z a cone projection)."""
    soc0 = cone.m_box + cone.m_l1
    b = z[0, soc0:].double().reshape(-1, cone.soc_dims[0])
    t, nu = b[:, 0], b[:, 1:].norm(dim=-1)
    tip = b.abs().amax(-1) == 0
    inside = ~tip & (nu < t * (1 - 1e-6))
    return dict(tip=int(tip.sum()), boundary=int((~tip & ~inside).sum()),
                interior=int(inside.sum()))


def _args_of(make):
    """A case's kernel arguments and keyword arguments (without k) from
    its (qps, settings, rho, factor, iterate)."""
    def build(dev):
        qps, s, rho, fac, (x, z, y) = make(dev)
        return ((qps.A, fac["Minv"], fac["M"], qps.q, rho, qps.lam, qps.l,
                 qps.u, x, z, y),
                dict(cone=qps.cone, sigma=s.sigma, alpha=s.alpha,
                     refine_steps=s.refine_steps))
    return build


def _leaf_diffs(a, b):
    return [float((p.double() - q.double()).abs().max())
            for p, q in zip(a, b)]


def _fused_work(B, n, m, ml, k, refine):
    """(operations, bytes) of k fused iterations: the products' FMAs and
    each input (A, M^-1, M where refined, q, rho, lam, l, u, x, z, y)
    read once and x, z, y written once, in f32."""
    flops = 2 * B * k * (2 * m * n + (1 + 2 * refine) * n * n)
    nbytes = 4 * (m * n + n * n * (2 if refine else 1) + n + m + ml
                  + 2 * B * m + 2 * B * (n + 2 * m))
    return flops, nbytes


def _fused_library(args, k, refine):
    """k iterations of the kernel's products alone, each one torch.matmul
    (cuBLAS) on the same operands: the product-only yardstick, which the
    port never calls. Returned as the replay of a CUDA graph, so that its
    time is the card's and not the rate at which the host launches its
    (3 + 2 refine) k small products."""
    import torch
    A, Minv, M, rho, z, y = args[0], args[1], args[2], args[4], args[9], \
        args[10]
    v = rho * z - y

    def products():
        for _ in range(k):
            rhs = v @ A
            xt = rhs @ Minv
            for _ in range(refine):
                xt = (xt @ M) @ Minv
            xt @ A.mT

    # Warm up on a side stream (cuBLAS picks its kernels), then capture.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        products()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        products()
    return graph.replay


def phase_kernel(dev):
    import torch
    from admm_library_torch.ops import fused

    out = {}
    # (case, inputs, the k to check). The last k is timed.
    for case, make, ks in (
            ("flagship_box_b128", _args_of(_flagship_inputs), (25,)),
            ("flagship_box_b1", _args_of(
                lambda d: _flagship_inputs(d, 1)), (25,)),
            ("flagship_box_b1024", _args_of(
                lambda d: _flagship_inputs(d, 1024)), (25,)),
            ("l1_soc_b3", _args_of(_l1_soc_inputs), (7,)),
            ("low_thrust_soc_b1", _low_thrust_inputs, (1, 2, 25))):
        args, kw0 = make(dev)
        x, z = args[8:10]
        cone = kw0["cone"]
        for k in ks:
            kw = dict(kw0, k=k)
            got = fused.fused_iterate_shared(*args, **kw)
            again = fused.fused_iterate_shared(*args, **kw)
            twin = fused.fused_iterate_shared_reference(*args, **kw)
            ref64 = fused.fused_iterate_shared_reference(
                *(a.double() for a in args), **kw)
            torch.cuda.synchronize()
            err = _leaf_diffs(got, ref64)
            twin_err = _leaf_diffs(twin, ref64)
            tol = [max(ERR_FACTOR * e, ERR_FLOOR) for e in twin_err]
            check(all(bool(torch.isfinite(t).all()) for t in got),
                  f"{case} k={k}: kernel output not finite")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{case} k={k}: rerun not bitwise identical")
            ms = cuda_ms(lambda: fused.fused_iterate_shared(*args, **kw))
            plain_ms = cuda_ms(
                lambda: fused.fused_iterate_shared_reference(*args, **kw))
            library_ms = cuda_ms(_fused_library(args, k,
                                                kw["refine_steps"]))
            B, n, m = x.shape[0], x.shape[1], z.shape[1]
            bound_ms, bound_by = bound(*_fused_work(
                B, n, m, cone.m_l1, k, kw["refine_steps"]))
            p = fused.device_plan(B, n, m, kw["refine_steps"],
                                  x.device.index)
            scale = max(float(t.abs().max()) for t in ref64)
            rec = dict(case=case, B=B, n=n, m=m, k=k,
                       max_abs_err=dict(zip(LEAVES, err)),
                       max_rel_err=max(err) / scale,
                       twin_max_abs_err=dict(zip(LEAVES, twin_err)),
                       tol=dict(zip(LEAVES, tol)),
                       kernel_vs_twin=dict(zip(LEAVES,
                                               _leaf_diffs(got, twin))),
                       ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       library="torch.matmul products only (cuBLAS, "
                               "one CUDA graph)",
                       bound_ms=bound_ms, bound_by=bound_by,
                       plan=p.describe())
            if case == "low_thrust_soc_b1":
                rec.update(soc_in=_soc_kinds(z, cone),
                           soc_out=_soc_kinds(ref64[1], cone))
            emit("kernel", **rec)
            for leaf, e, t in zip(LEAVES, err, tol):
                check(e <= t, f"{case} k={k}: kernel error {e:.3e} in "
                      f"{leaf} against the f64 twin exceeds {t:.3e}")
            if "soc_out" in rec:
                check(rec["soc_out"]["tip"] > 0
                      and rec["soc_out"]["boundary"] > 0,
                      f"{case} k={k}: the SOC blocks are not both at the "
                      "tip and on the boundary")
        out[case] = dict(max_abs_err=max(err), ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
    return out


def _kernels():
    """The kernels' wrappers, each carrying its launch count."""
    from admm_library_torch.ops import fused, pallas_cg
    return {"fused_iterate_shared": fused.fused_iterate_shared,
            "pallas_cg_solve": pallas_cg.pallas_cg_solve}


def _timed_run(fn, *args, reads=None):
    """fn(*args) from zeroed launch counts: (result, seconds, launches
    of each kernel). With `reads` (a `_HostReads`), the host's reads of
    the run itself are counted, not those of the counts."""
    import contextlib
    import torch
    kernels = _kernels()
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    with reads if reads is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return out, secs, {name: k.launches for name, k in kernels.items()}


def _timed_solve(qp, settings):
    """One batch solve from zeroed launch counts: (solution, seconds,
    fused-kernel launches)."""
    from admm_library_torch import solve_batch_shared
    sol, secs, launches = _timed_run(solve_batch_shared, qp, settings)
    return sol, secs, launches["fused_iterate_shared"]


class _HostReads:
    """Counts the host's reads of device values inside the block: calls
    of item, tolist, bool, float and int on CUDA tensors, each of which
    waits for the card."""

    NAMES = ("item", "tolist", "__bool__", "__float__", "__int__")

    def __enter__(self):
        import torch
        self.count = 0
        self.own = {n: torch.Tensor.__dict__.get(n) for n in self.NAMES}
        for name in self.NAMES:
            setattr(torch.Tensor, name, self._counted(getattr(torch.Tensor,
                                                              name)))
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


class _SegmentCount:
    """Counts the segments that every graph.CheckLoop runs inside the
    block, by name: 'check' for a residual check, else the variant's
    first element ('prologue', 'refactor', ...)."""

    def __enter__(self):
        from admm_library_torch.core import graph
        self.cls, self.real = graph.CheckLoop, graph.CheckLoop.__call__
        self.counts = {}
        counts, real = self.counts, self.real

        def call(loop, variant):
            name = "check" if graph.is_check(variant) else variant[0]
            counts[name] = counts.get(name, 0) + 1
            return real(loop, variant)
        self.cls.__call__ = call
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.real


def _captured_runs(fn, *args, reruns=1):
    """fn(*args) from an empty check cache, then `reruns` reruns: every
    result, and a record of the captured checks (core/graph.py) with
    each run's wall-clock, kernel launches, segments run by name
    (`_SegmentCount`), the host's reads (`_HostReads`) and
    graph.CACHE.stats deltas (captures, replays
    (graph launches), warm-ups, capture ms; `graph_rerun` the last
    rerun, `graph_reruns` each where there are more), the cache's
    entries, the nodes of each graph (counted after the last run, so
    that a variant captured in a rerun counts too) and the peak device
    memory allocated over every run."""
    import torch
    from admm_library_torch.core import graph
    graph.CACHE.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sols, runs = [], []
    for i in range(1 + reruns):
        before = dict(graph.CACHE.stats)
        if i == reruns:
            graph.CACHE.replay_events = []
        reads = _HostReads()
        with _SegmentCount() as segments, _ProgramCalls(reads) as progs:
            sol, wall, launches = _timed_run(fn, *args, reads=reads)
        sols.append(sol)
        runs.append(dict(wall_s=wall, launches=launches,
                         segments=segments.counts, host_reads=reads.count,
                         programs=progs.calls,
                         **{
                             k: graph.CACHE.stats[k] - before[k]
                             for k in before}))
    replay_ms = graph.CACHE.replay_ms()
    graph.CACHE.replay_events = None
    runs[-1].update(replay_device_ms=replay_ms,
                    replay_idle_share=1.0 - replay_ms / 1e3 / wall)
    rec = dict(graph_first=runs[0], graph_rerun=runs[-1],
               graph_entries=len(graph.CACHE.entries),
               nodes_per_graph=_graph_nodes(), body_nodes=_body_nodes(),
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    if reruns > 1:
        rec["graph_reruns"] = runs[1:]
    return sols, rec


def _capture_off(fn, *args):
    """fn(*args) with `graph.capturable` forced off, every segment eager:
    (result, seconds, launches of each kernel)."""
    from admm_library_torch.core import graph
    real = graph.capturable
    graph.capturable = lambda *a, **k: False
    try:
        return _timed_run(fn, *args)
    finally:
        graph.capturable = real


def _captured_fields(tag, sols, rec, fn, *args, twin=False):
    """The captured-path bars of a solve's `_captured_runs` (a first run
    from an empty cache and a rerun): it captured and replayed, the
    rerun is bitwise the first run and captured and warmed nothing; with
    `twin`, the same solve with every segment eager is bitwise the
    captured one and launched each kernel as often. Returns the record's
    fields."""
    out = dict(wall_s=rec["graph_first"]["wall_s"],
               wall_rerun_s=rec["graph_rerun"]["wall_s"],
               launches=rec["graph_first"]["launches"],
               rerun_bitwise_identical=_bitwise(sols[0], sols[1]),
               graph_first=rec["graph_first"],
               graph_rerun=rec["graph_rerun"])
    _check_captured(tag, rec)
    check(rec["graph_rerun"]["captures"] == 0,
          f"{tag}: the rerun captured a variant")
    check(out["rerun_bitwise_identical"], f"{tag}: rerun not bitwise "
          "identical")
    check(rec["graph_rerun"]["launches"] == out["launches"],
          f"{tag}: the rerun launched the kernels another number of times")
    if twin:
        out.update(_capture_off_fields(tag, sols[0], out["launches"], fn,
                                       *args))
    return out


def _capture_off_fields(tag, sol, launches, fn, *args):
    """The same solve with every segment eager (`_capture_off`): its
    wall-clock and kernel launches, held bitwise to the captured `sol`
    and to its `launches`. Returns the record's fields."""
    eager, wall, eager_launches = _capture_off(fn, *args)
    out = dict(eager_wall_s=wall, eager_launches=eager_launches,
               captured_is_eager_bitwise=_bitwise(sol, eager))
    check(out["captured_is_eager_bitwise"],
          f"{tag}: the captured solve differs from the capture-off one")
    check(eager_launches == launches,
          f"{tag}: kernel launches differ between the captured and the "
          "capture-off solve")
    return out


def _check_reads(tag, rec):
    """A rerun's host reads: at most PHASE_READS, none per check (every
    phase's checks run in its graph's WHILE node; no read inside a check,
    none before a CG block). Returns (reads, checks)."""
    rerun = rec["graph_rerun"]
    checks = rerun["segments"].get("check", 0)
    check(rerun["host_reads"] <= PHASE_READS and checks == 0,
          f"{tag}: {rerun['host_reads']} host reads and {checks} host-run "
          "checks in a rerun")
    return rerun["host_reads"], checks


def _variant_label(variant):
    """A graph's variant as a short label: a phase by its reachable check
    variants."""
    from admm_library_torch.core import graph
    if isinstance(variant, graph.Phase):
        return f"phase{list(variant.reachable)}"
    return str(variant)


def _body_nodes():
    """The nodes inside the conditional bodies of every graph of the
    default cache that holds them, by entry and variant (`_graph_nodes`'
    labels)."""
    from admm_library_torch.core import graph
    out = {}
    for i, (key, entry) in enumerate(graph.CACHE.entries.items()):
        for variant, n in entry.body_nodes.items():
            if n:
                out[f"{i}:{key[0]} {_variant_label(variant)}"] = n
    return out


def _check_program(tag, rec, calls=1, alone=True):
    """A path that calls `calls` whole-solve programs (graph.program:
    solve_batch_shared, api._solve_core): in a rerun each call is one
    graph launch and no host read; with `alone` (nothing else runs
    around them) the whole rerun is those launches, no host read and no
    segment run on the host."""
    rerun = rec["graph_rerun"]
    progs = rerun["programs"]
    check(len(progs) == calls
          and all(p["replays"] == 1 and p["host_reads"] == 0
                  for p in progs),
          f"{tag}: a rerun's program calls {progs}, not {calls} of one "
          "graph launch and no host read each")
    check(not alone or (rerun["replays"] == calls
                        and rerun["host_reads"] == 0
                        and not rerun["segments"]),
          f"{tag}: {rerun['replays']} graph launches, {rerun['host_reads']}"
          f" host reads and the segments {rerun['segments']} in a rerun")


class _ProgramCalls:
    """Records each graph.program call inside the block: its kind and
    the graph launches and host reads (of `reads`, the `_HostReads` open
    around the block) made inside it."""

    def __init__(self, reads):
        self.reads = reads
        self.calls = []

    def __enter__(self):
        from admm_library_torch.core import graph
        self.graph, self.real = graph, graph.program

        def program(kind, *a, **k):
            r0 = getattr(self.reads, "count", 0)
            l0 = graph.CACHE.stats["replays"]
            out = self.real(kind, *a, **k)
            self.calls.append(dict(
                kind=kind, replays=graph.CACHE.stats["replays"] - l0,
                host_reads=getattr(self.reads, "count", 0) - r0))
            return out
        graph.program = program
        return self

    def __exit__(self, *exc):
        self.graph.program = self.real


def _check_captured(tag, rec):
    """The captured-check bars of a path: its first run captured a
    graph (a program's first run is its eager warm-up, then its capture;
    a loop's segments are replayed there too), its rerun warmed no
    variant up (every key stayed in the cache), and no graph is
    empty."""
    first, rerun = rec["graph_first"], rec["graph_rerun"]
    check(first["captures"] > 0,
          f"{tag}: no check was captured")
    # A variant met once in the first run was only warmed there; its
    # capture comes at its second check, in the rerun.
    check(rerun["eager_checks"] == 0,
          f"{tag}: the rerun warmed a variant up again")
    check(rerun["replays"] > 0, f"{tag}: the rerun replayed no check")
    check(min(rec["nodes_per_graph"].values()) > 0,
          f"{tag}: an empty graph")
    _check_reads(tag, rec)


def phase_slice(batch, dev):
    import torch
    from admm_library_torch import Settings, Status
    from admm_library_torch.core import admm
    from admm_library_torch.models import monte_carlo as mc
    from admm_library_torch.models.double_integrator import rollout
    from admm_library_torch.utils.oracle import kkt_residuals

    qp32, spec, s0s = mc.monte_carlo_mpc_from_s0(mc.reference_s0(batch),
                                                 device=dev)
    # The reference's f32 data, solved with f64 outputs so that the
    # independent check sees no output rounding.
    qp = qp32.astype(torch.float64)
    settings = Settings(eps_abs=EPS, eps_rel=EPS)
    sol, wall, launches = _timed_solve(qp, settings)
    sol2, wall2, _ = _timed_solve(qp, settings)
    r_p, r_d, _ = kkt_residuals(qp, sol.x, sol.z, sol.y)
    # What SOLVED means: each lane's residuals against its own mixed
    # threshold (PERF.md section 2), beside the bare EPS bar held below.
    *_, eps_p, eps_d, _ = admm.unscaled_criterion(qp, sol.x, sol.z, sol.y,
                                                 EPS, EPS)
    ratio = torch.maximum(r_p / eps_p, r_d / eps_d)
    worst = ratio.argsort(descending=True)[:8].tolist()
    lockstep = int(sol.iters.max())
    solved = int((sol.status == int(Status.SOLVED)).sum())
    bitwise = all(torch.equal(getattr(sol, f), getattr(sol2, f))
                  for f in ("x", "z", "y", "status", "iters", "r_prim",
                            "r_dual"))
    lanes = min(batch, 16)
    term = max(float(rollout(spec, s0s[i].double(), sol.x[i])[-1].abs().max())
               for i in range(lanes))
    rec = dict(batch=batch, n=qp.n, m=qp.m, solved=solved,
               lockstep_iters=lockstep,
               iters_lane_mean=float(sol.iters.float().mean()),
               kkt_r_prim_max=float(r_p.max()),
               kkt_r_dual_max=float(r_d.max()),
               kkt_r_prim_over_eps_max=float((r_p / eps_p).max()),
               kkt_r_dual_over_eps_max=float((r_d / eps_d).max()),
               kkt_over_eps_median=float(ratio.median()),
               eps_prim_range=[float(eps_p.min()), float(eps_p.max())],
               eps_dual_range=[float(eps_d.min()), float(eps_d.max())],
               kkt_over_eps_worst_lanes=[
                   [i, float(r_p[i] / eps_p[i]), float(r_d[i] / eps_d[i])]
                   for i in worst],
               wall_s=wall, wall_rerun_s=wall2, kernel_launches=launches,
               rerun_bitwise_identical=bitwise,
               rollout_terminal_err_max=term)
    if batch == 128:
        # The same solve through the plain iteration body: the solution
        # must agree, and its wall-clock is the end-to-end comparison.
        plain, wall_p, launches_p = _timed_solve(
            qp, settings.replace(fused="off"))
        rec.update(plain_wall_s=wall_p, plain_kernel_launches=launches_p,
                   plain_lockstep_iters=int(plain.iters.max()),
                   plain_x_max_abs_diff=float((plain.x - sol.x).abs().max()))
        check(launches_p == 0, "fused='off' still launched the kernel")
        # Each solve meets the 1e-6 residual criterion; the states carry
        # only a 1e-8 regularisation, so two solved points agree to
        # ~1e-4 in x (7.0e-5 measured on the H100).
        check(rec["plain_x_max_abs_diff"] <= 5e-4,
              "kernel and plain paths disagree on x")
    emit("slice", **rec)
    check(solved == batch, f"batch {batch}: {batch - solved} lanes not SOLVED")
    check(rec["kkt_r_prim_max"] <= EPS and rec["kkt_r_dual_max"] <= EPS,
          f"batch {batch}: f64 KKT residuals above {EPS}")
    check(abs(lockstep - REFERENCE_ITERS) <= ITER_SLACK,
          f"batch {batch}: {lockstep} lockstep iterations, reference "
          f"{REFERENCE_ITERS}")
    check(launches > 0, f"batch {batch}: the fused kernel never launched")
    check(bitwise, f"batch {batch}: rerun not bitwise identical")
    check(term <= ROLLOUT_TOL, f"batch {batch}: rollout misses the target")
    return rec, sol


def _pcg_flagship(dev):
    """The config-5 f32 phase's PCG system at batch 128: M from a Ruiz +
    'pallas_cg' factor, rhs the x-update with z at the projection of
    zero onto each lane's bounds."""
    import torch
    from admm_library_torch import Settings
    from admm_library_torch.core import admm
    from admm_library_torch.core.scaling import ruiz_equilibrate
    from admm_library_torch.models import monte_carlo as mc
    from admm_library_torch.ops import kkt
    from admm_library_torch.parallel.batch import _s32_of_shared

    s = _s32_of_shared(Settings())
    qp, _, _ = mc.monte_carlo_mpc_from_s0(mc.reference_s0(128), device=dev)
    qps, _ = ruiz_equilibrate(qp, s.scaling_iters)
    rho = admm.rho_vec_of(torch.tensor(s.rho, device=dev),
                          admm.is_equality_row_shared(qps), s)
    M = kkt.factor_condensed(qps.P, qps.A, s.sigma, rho, "pallas_cg")["M"]
    z = torch.clamp(torch.zeros_like(qps.l), qps.l, qps.u)
    return M, (rho * z) @ qps.A - qps.q


def _spd_zero_lane(dev):
    """A small SPD system whose lane 2 has rhs = 0: it must stay frozen."""
    import numpy as np
    import torch
    rng = np.random.default_rng(11)
    n = 24
    R = rng.standard_normal((n, n))
    rhs = rng.standard_normal((4, n))
    rhs[2] = 0.0
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return f32(R @ R.T + n * np.eye(n)), f32(rhs)


def _config3(dev, dtype=None):
    """BASELINE config 3 as the JAX bench builds it (bench_cw, seed 0):
    (QPData, CWSpec, s0). The bench builds it in f32 (the default)."""
    import numpy as np
    import torch
    from admm_library_torch.models.clohessy_wiltshire import (
        build_cw_rendezvous)
    rng = np.random.default_rng(0)
    s0 = np.array([100.0, -1000.0, 20.0, 0.1, 0.5, -0.05])
    s0[:3] += rng.uniform(-20, 20, 3)
    qp, spec = build_cw_rendezvous(s0, N=20, dtype=dtype or torch.float32,
                                   device=dev)
    return qp, spec, torch.as_tensor(s0, dtype=torch.float64, device=dev)


def _pcg_cw(dev):
    """Config 3's f32-phase PCG system through solve(backend=
    'pallas_cg'): M from a Ruiz + 'pallas_cg' factor under _s32_of of
    the bench settings, rhs the x-update with z at the projection of
    zero onto the bounds (one lane)."""
    import torch
    from admm_library_torch import Settings
    from admm_library_torch.api import _s32_of
    from admm_library_torch.core import admm
    from admm_library_torch.core.scaling import ruiz_equilibrate
    from admm_library_torch.ops import kkt
    from admm_library_torch.problem import is_equality_row

    s = _s32_of(Settings(eps_abs=EPS, eps_rel=EPS, max_iter=50000,
                         backend="pallas_cg"))
    qps, _ = ruiz_equilibrate(_config3(dev)[0], s.scaling_iters)
    rho = admm.rho_vec_of(torch.tensor(s.rho, device=dev),
                          is_equality_row(qps), s, qps.cone)
    M = kkt.factor_condensed(qps.P, qps.A, s.sigma, rho, "pallas_cg")["M"]
    z = torch.clamp(torch.zeros_like(qps.l), qps.l, qps.u)
    return M, ((rho * z) @ qps.A - qps.q)[None]


def _cg_steps(M, rhs, iters, tol):
    """Steps each lane of the lockstep PCG solve is active before it
    freezes: the twin's loop (ops/pallas_cg._cg_math) in the working
    type, counting its `active` mask."""
    import torch
    tiny = torch.finfo(rhs.dtype).tiny
    dinv = (1.0 / torch.diagonal(M)).to(rhs.dtype)
    x = torch.zeros_like(rhs)
    r = rhs.clone()
    z = r * dinv
    p = z
    rz = (r * z).sum(-1, keepdim=True)
    rr = (r * r).sum(-1, keepdim=True)
    tol2 = (tol * tol) * torch.clamp((rhs * rhs).sum(-1, keepdim=True),
                                     min=1.0)
    zero = torch.zeros_like(rz)
    steps = torch.zeros_like(rz, dtype=torch.int64)
    for _ in range(iters):
        Mp = p @ M
        pMp = (p * Mp).sum(-1, keepdim=True)
        active = rr > tol2
        steps += active
        alpha = torch.where(active, rz / torch.clamp(pMp, min=tiny), zero)
        x = x + alpha * p
        r = r - alpha * Mp
        z = r * dinv
        rz_new = (r * z).sum(-1, keepdim=True)
        rr_new = (r * r).sum(-1, keepdim=True)
        beta = torch.where(active, rz_new / torch.clamp(rz, min=tiny), zero)
        p = z + beta * p
        rz = torch.where(active, rz_new, rz)
        rr = torch.where(active, rr_new, rr)
    return int(steps.sum())


def _cg_work(M, rhs, iters, tol):
    """(operations, bytes) of a PCG solve on this data: per active lane
    step the product with M (2 n^2) and ~12 n vector operations; M, rhs
    and x each moved once."""
    n = M.shape[0]
    steps = _cg_steps(M, rhs, iters, tol)
    return (steps * (2 * n * n + 12 * n),
            M.element_size() * (n * n + 2 * rhs.numel()))


def pcg_cases(dev):
    """Kernel 2's cases: (name, M, rhs, iters, tol), f32 inputs."""
    M, rhs = _pcg_flagship(dev)
    Ms, rhs_s = _spd_zero_lane(dev)
    Mc, rhs_c = _pcg_cw(dev)
    return (("flagship_b128", M, rhs, 200, 1e-9),
            ("flagship_b1", M, rhs[:1].contiguous(), 200, 1e-9),
            ("spd_zero_lane_b4", Ms, rhs_s, 200, 1e-9),
            ("cw_b1", Mc, rhs_c, 200, 1e-9))


def stream_plan(B, n, itemsize):
    """The plan with no cluster placeable: the stream design at the lane
    tile the planner gives it."""
    from admm_library_torch.ops import fused, pallas_cg as pcg
    sms, smem = fused.device_limits(0)
    return pcg.plan(B, n, itemsize, sms, min(smem, pcg.SMEM_LIMIT),
                    lambda C, t: 0)


def _pcg_check(name, dtype, Mt, rt, plan, ref64, twin_err, iters, tol):
    """Kernel 2 under `plan` against the f64 twin and, after 1-3 steps,
    the twin in the working type: (output, record); raises past the
    error bars."""
    import torch
    from admm_library_torch.ops import pallas_cg as pcg
    got = pcg.pallas_cg_solve_planned(Mt, rt, iters=iters, tol=tol,
                                      plan=plan)
    torch.cuda.synchronize()
    err = max_abs_diff([got], [ref64])
    tol_err = (max(ERR_FACTOR * twin_err, ERR_FLOOR)
               if dtype == torch.float32 else F64_ERR_FLOOR)
    # A few steps: the same arithmetic within a few ulps.
    short = []
    for k in (1, 2, 3):
        a = pcg.pallas_cg_solve_planned(Mt, rt, iters=k, tol=tol, plan=plan)
        b = pcg.pallas_cg_solve_reference(Mt, rt, iters=k, tol=tol)
        short.append(max_abs_diff([a], [b])
                     / max(float(b.abs().max()), 1e-30))
    short_tol = 64 * torch.finfo(dtype).eps
    check(bool(torch.isfinite(got).all()),
          f"{name} {plan}: kernel output not finite")
    check(err <= tol_err, f"{name} {plan}: kernel error {err:.3e} against "
          f"the f64 twin exceeds {tol_err:.3e}")
    check(max(short) <= short_tol,
          f"{name} {plan}: kernel and twin differ after 1-3 steps")
    if name.startswith("spd_zero_lane"):
        check(torch.equal(got[2], torch.zeros_like(got[2])),
              f"{name} {plan}: the zero-rhs lane moved")
    return got, dict(max_abs_err=err, err_tol=tol_err, short_rel_err=short,
                     short_tol=short_tol)


def phase_cg_kernel(dev):
    """Kernel 2 under the card's plan and under the stream design, each
    held to the error bars, timed in turns (plan, stream, stream,
    plan)."""
    import torch
    from admm_library_torch.ops import pallas_cg as pcg

    out = {}
    for case, M32, rhs32, iters, tol in pcg_cases(dev):
        for dtype in (torch.float32, torch.float64):
            Mt, rt = M32.to(dtype), rhs32.to(dtype)
            B, n = rt.shape
            kw = dict(iters=iters, tol=tol)
            dname = str(dtype).split('.')[-1]
            name = f"{case}_{dname}"
            twin = pcg.pallas_cg_solve_reference(Mt, rt, **kw)
            ref64 = pcg.pallas_cg_solve_reference(Mt.double(), rt.double(),
                                                  **kw)
            twin_err = max_abs_diff([twin], [ref64])
            plan = pcg.device_plan(B, n, Mt.element_size(), dev.index)
            splan = stream_plan(B, n, Mt.element_size())
            got, rec = _pcg_check(name, dtype, Mt, rt, plan, ref64,
                                  twin_err, iters, tol)
            _, srec = _pcg_check(name, dtype, Mt, rt, splan, ref64,
                                 twin_err, iters, tol)
            plans, turns = (plan, splan), ([], [])
            for i in (0, 1, 1, 0):
                turns[i].append(cuda_ms(
                    lambda p=plans[i]: pcg.pallas_cg_solve_planned(
                        Mt, rt, plan=p, **kw)))
            ms, stream_ms = (statistics.mean(t) for t in turns)
            plain_ms = cuda_ms(
                lambda: pcg.pallas_cg_solve_reference(Mt, rt, **kw))
            # The library yardstick: a direct solve against a Cholesky
            # factor computed beforehand, on the same right-hand sides.
            chol = torch.linalg.cholesky(Mt)
            library_ms = cuda_ms(lambda: torch.cholesky_solve(rt.mT, chol))
            bound_ms, bound_by = bound(*_cg_work(Mt, rt, iters, tol), dname)
            emit("cg_kernel", case=name, B=B, n=n, iters=iters, tol=tol,
                 design=plan[0], cluster=plan[1], lane_tile=plan[2],
                 **rec, twin_max_abs_err=twin_err,
                 kernel_vs_twin=max_abs_diff([got], [twin]), ms=ms,
                 ms_turns=turns[0], stream_lane_tile=splan[2],
                 stream_max_abs_err=srec["max_abs_err"],
                 stream_short_rel_err=srec["short_rel_err"],
                 stream_ms=stream_ms, stream_ms_turns=turns[1],
                 plain_ms=plain_ms, library_ms=library_ms,
                 library="torch.cholesky_solve on a precomputed factor",
                 bound_ms=bound_ms, bound_by=bound_by)
            out[name] = dict(design=plan[0], cluster=plan[1],
                             lane_tile=plan[2], max_abs_err=rec["max_abs_err"],
                             ms=ms, stream_ms=stream_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
    return out


def _mixed_kkt(qp, sol, eps_abs=EPS, eps_rel=EPS):
    """Independent f64 KKT residuals (utils/oracle) and their
    mixed-criterion thresholds: (r_prim, r_dual, eps_prim, eps_dual).
    eps_dual's scale includes the L1 objective's gradient bound
    max λᵢ|A_l1[i, j]|, as the solver's criterion does: on a min-fuel LP
    (P ≈ 0, q = 0) the objective lives entirely in λ."""
    from admm_library_torch.utils.oracle import kkt_residuals
    x, z, y = sol.x, sol.z, sol.y
    r_p, r_d, _ = kkt_residuals(qp, x, z, y)
    linf = lambda v: float(v.abs().max()) if v.numel() else 0.0  # noqa: E731
    mb, ml = qp.cone.m_box, qp.cone.m_l1
    l1_grad = linf(qp.lam[:, None] * qp.A[mb:mb + ml])
    eps_p = eps_abs + eps_rel * max(linf(x @ qp.A.mT), linf(z))
    eps_d = eps_abs + eps_rel * max(linf(x @ qp.P.mT), linf(y @ qp.A),
                                    linf(qp.q), l1_grad)
    return float(r_p), float(r_d), eps_p, eps_d


def _bitwise(a, b):
    import torch
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("x", "z", "y", "status", "iters", "r_prim",
                         "r_dual"))


def _config2(dev):
    """BASELINE config 2 as the JAX bench builds it (bench_mpc, seed 0)."""
    import numpy as np
    import torch
    from admm_library_torch.models.double_integrator import build_mpc_qp
    rng = np.random.default_rng(0)
    s0 = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(-0.2, 0.2, 3)])
    qp, spec = build_mpc_qp(s0, np.zeros(6), N=50, dim=3, device=dev)
    return qp, spec, torch.as_tensor(s0, dtype=torch.float64, device=dev)


def phase_solve(dev):
    import torch
    from admm_library_torch import Settings, Status, solve
    from admm_library_torch.models.double_integrator import rollout
    from admm_library_torch.models.random_qp import reference_random_box_qp

    qp2, spec2, s02 = _config2(dev)
    out = {}
    for name, qp32, band in (
            ("config1", reference_random_box_qp(dev), 0),
            ("config2", qp2, spec2.block)):
        # The reference's f32 data with f64 outputs (see phase_slice).
        qp = qp32.astype(torch.float64)
        s = Settings(eps_abs=EPS, eps_rel=EPS, band_block=band,
                     backend="pallas_cg")
        sols, graph_rec = _captured_runs(solve, qp, s)
        sol = sols[0]
        fields = _captured_fields(f"solve {name}", sols, graph_rec, solve,
                                  qp, s, twin=True)
        # A box-only hybrid solve is the shared pass at B=1: one program.
        _check_program(f"solve {name}", graph_rec)
        launches = fields["launches"]
        inv = solve(qp, s.replace(backend="inv"))
        r_p, r_d, eps_p, eps_d = _mixed_kkt(qp, sol)
        iters = int(sol.iters)
        ref_iters = PCG_REFERENCE_ITERS[name]
        rec = dict(config=name, n=qp.n, m=qp.m, status=sol.status_name(),
                   iters=iters, reference_iters=ref_iters,
                   kkt_r_prim=r_p, kkt_r_dual=r_d, eps_prim=eps_p,
                   eps_dual=eps_d, **fields,
                   nodes_per_graph=graph_rec["nodes_per_graph"],
                   inv_status=inv.status_name(), inv_iters=int(inv.iters),
                   inv_x_max_abs_diff=float((sol.x - inv.x).abs().max()))
        if name == "config2":
            rec["rollout_terminal_err"] = float(
                rollout(spec2, s02, sol.x)[-1].abs().max())
        emit("solve", **rec)
        check(int(sol.status) == int(Status.SOLVED), f"{name}: not SOLVED")
        check(r_p <= eps_p and r_d <= eps_d,
              f"{name}: f64 KKT residuals above the mixed criterion")
        check(abs(iters - ref_iters) <= ITER_SLACK,
              f"{name}: {iters} iterations, reference {ref_iters}")
        check(launches["pallas_cg_solve"] > 0,
              f"{name}: the PCG kernel never launched")
        check(rec["inv_x_max_abs_diff"] <= X_AGREE,
              f"{name}: 'pallas_cg' and 'inv' solutions disagree")
        check(rec.get("rollout_terminal_err", 0.0) <= ROLLOUT_TOL,
              f"{name}: rollout misses the target")
        out[name] = rec
    return out


def phase_slice_pcg(dev):
    import torch
    from admm_library_torch import Settings, Status, solve_batch_shared
    from admm_library_torch.models import monte_carlo as mc
    from admm_library_torch.utils.oracle import kkt_residuals

    batch = 128
    qp = mc.monte_carlo_mpc_from_s0(mc.reference_s0(batch),
                                    device=dev)[0].astype(torch.float64)
    s = Settings(eps_abs=EPS, eps_rel=EPS, backend="pallas_cg")
    sols, graph_rec = _captured_runs(solve_batch_shared, qp, s)
    sol = sols[0]
    fields = _captured_fields("pcg batch", sols, graph_rec,
                              solve_batch_shared, qp, s, twin=True)
    _check_program("pcg batch", graph_rec)
    launches = fields["launches"]
    inv = solve_batch_shared(qp, s.replace(backend="inv"))
    r_p, r_d, _ = kkt_residuals(qp, sol.x, sol.z, sol.y)
    lockstep = int(sol.iters.max())
    ref_iters = PCG_REFERENCE_ITERS["config5"]
    solved = int((sol.status == int(Status.SOLVED)).sum())
    rec = dict(batch=batch, n=qp.n, m=qp.m, solved=solved,
               lockstep_iters=lockstep, reference_iters=ref_iters,
               iters_lane_mean=float(sol.iters.float().mean()),
               kkt_r_prim_max=float(r_p.max()),
               kkt_r_dual_max=float(r_d.max()), **fields,
               nodes_per_graph=graph_rec["nodes_per_graph"],
               inv_lockstep_iters=int(inv.iters.max()),
               inv_x_max_abs_diff=float((sol.x - inv.x).abs().max()))
    emit("slice_pcg", **rec)
    check(solved == batch, f"pcg batch: {batch - solved} lanes not SOLVED")
    check(rec["kkt_r_prim_max"] <= EPS and rec["kkt_r_dual_max"] <= EPS,
          f"pcg batch: f64 KKT residuals above {EPS}")
    check(abs(lockstep - ref_iters) <= ITER_SLACK,
          f"pcg batch: {lockstep} lockstep iterations, reference {ref_iters}")
    check(launches["pallas_cg_solve"] > 0,
          "pcg batch: the PCG kernel never launched")
    check(rec["inv_x_max_abs_diff"] <= X_AGREE,
          "pcg batch: 'pallas_cg' and 'inv' solutions disagree")
    return rec


def _lane(qp, i):
    """Lane i of a batch: the leaves with a lane axis sliced, the shared
    ones (a shared-matrix batch's P, A, q, lam) as they are."""
    from admm_library_torch import QPData
    ndim = dict(P=2, q=1, A=2, l=1, u=1, lam=1)
    return QPData(**{f: getattr(qp, f)[i] if getattr(qp, f).dim() > d
                     else getattr(qp, f) for f, d in ndim.items()},
                  cone=qp.cone)


def _kkt_within(qp, sol, eps):
    """Whether every lane's (or the one problem's) f64 KKT residuals lie
    within its mixed criterion at eps, and the largest ratio of a
    residual to its threshold."""
    import types
    if sol.x.dim() == 1:
        pairs = [(qp, sol)]
    else:
        pairs = [(_lane(qp, i), types.SimpleNamespace(
            x=sol.x[i], z=sol.z[i], y=sol.y[i]))
                 for i in range(sol.x.shape[0])]
    worst = 0.0
    for q, one in pairs:
        r_p, r_d, eps_p, eps_d = _mixed_kkt(q, one, eps, eps)
        worst = max(worst, r_p / eps_p, r_d / eps_d)
    return worst <= 1.0, worst


def phase_cg_paths(dev):
    """The matrix-free 'cg' backend at full width, every loop captured
    (each check one graph, its CGs conditional nodes: a WHILE node of
    8-step blocks whose stop test runs on the card): configs 1-3 through
    solve, the config-5 batch at 128 through solve_batch_shared and
    BATCH_LANES config-1 draws through solve_batch. Each SOLVED in every
    lane with f64 KKT within the mixed criterion, iterations within
    ITER_SLACK of the JAX reference's with 'cg' (CG_ITERS_HELD), x within
    X_AGREE of the 'inv' solve, a rerun bitwise and capturing nothing,
    bitwise the same solve with every segment eager, and the rerun's
    host reads at most its checks and PHASE_READS more. Reports
    wall-clock, the graphs' nodes (the conditional bodies' beside) and
    capture ms, the segments of a rerun by name, its host reads and the
    device time of its replays (CUDA events around each replay: a
    profile loses the kernels inside conditional bodies, so none runs
    here)."""
    import torch
    from admm_library_torch import (QPData, Settings, Status, solve,
                                    solve_batch, solve_batch_shared)
    from admm_library_torch.models import monte_carlo as mc
    from admm_library_torch.models.random_qp import (
        random_box_qp, reference_random_box_qp)

    f64 = torch.float64
    qp2, spec2, _ = _config2(dev)
    gen = torch.Generator().manual_seed(0)
    lanes = [random_box_qp(gen, device=dev).astype(f64)
             for _ in range(BATCH_LANES)]
    qp1b = QPData(**{f: torch.stack([getattr(q, f) for q in lanes])
                     for f in ("P", "q", "A", "l", "u", "lam")},
                  cone=lanes[0].cone)
    s = Settings(eps_abs=EPS, eps_rel=EPS, backend="cg")
    paths = {
        "config1": (solve, reference_random_box_qp(dev).astype(f64), s,
                    EPS),
        "config2": (solve, qp2.astype(f64),
                    s.replace(band_block=spec2.block), EPS),
        "config3": (solve, _config3(dev)[0].astype(f64),
                    s.replace(max_iter=50000), EPS),
        "config5": (solve_batch_shared, mc.monte_carlo_mpc_from_s0(
            mc.reference_s0(128), device=dev)[0].astype(f64), s, EPS),
        "solve_batch": (solve_batch, qp1b, s.replace(
            eps_abs=BATCH_EPS, eps_rel=BATCH_EPS, max_iter=20000),
            BATCH_EPS)}
    out = {}
    for name, (fn, qp, st, eps) in paths.items():
        tag = f"cg_paths {name}"
        sols, graph_rec = _captured_runs(fn, qp, st)
        sol = sols[0]
        iters = int(sol.iters.max())
        fields = _captured_fields(tag, sols, graph_rec, fn, qp, st,
                                  twin=True)
        reads, checks = _check_reads(tag, graph_rec)
        if name != "config3":       # config 3 takes the staged path
            _check_program(tag, graph_rec)
        inv = fn(qp, st.replace(backend="inv"))
        kkt_ok, kkt_worst = _kkt_within(qp, sol, eps)
        solved = int((sol.status == int(Status.SOLVED)).sum())
        nodes = graph_rec["nodes_per_graph"]
        rec = dict(path=name, n=qp.n, m=qp.m, lanes=sol.status.numel(),
                   solved=solved, iters=iters,
                   reference_iters=CG_REFERENCE_ITERS[name],
                   kkt_within_criterion=kkt_ok, kkt_worst_ratio=kkt_worst,
                   inv_iters=int(inv.iters.max()),
                   inv_x_max_abs_diff=float((sol.x - inv.x).abs().max()),
                   **fields, graph_entries=graph_rec["graph_entries"],
                   cg_body_nodes=graph_rec["body_nodes"],
                   nodes_max=max(nodes.values()),
                   segments=graph_rec["graph_rerun"]["segments"],
                   host_reads=reads, host_reads_first=graph_rec[
                       "graph_first"]["host_reads"], checks=checks,
                   peak_memory_bytes=graph_rec["peak_memory_bytes"])
        emit("cg_paths", **rec)
        check(solved == sol.status.numel(),
              f"{tag}: {sol.status.numel() - solved} lanes not SOLVED")
        check(kkt_ok, f"{tag}: f64 KKT residuals above the mixed criterion")
        check(name not in CG_ITERS_HELD
              or abs(iters - CG_REFERENCE_ITERS[name]) <= ITER_SLACK,
              f"{tag}: {iters} iterations, reference "
              f"{CG_REFERENCE_ITERS[name]}")
        check(rec["inv_x_max_abs_diff"] <= X_AGREE,
              f"{tag}: 'cg' and 'inv' solutions disagree")
        check(rec["cg_body_nodes"]
              and min(rec["cg_body_nodes"].values()) > 0,
              f"{tag}: a check graph holds no conditional body")
        out[name] = rec
    return out


class _Stages:
    """Records the stages of one solve by wrapping the module functions
    that run them: the shared pass's phases (parallel.batch._phase: the
    f32 phase, the re-centred rounds, the f64 fallback), the f64
    continuation, its chunks (api._solve_one_phase) and the polish
    attempts (api.polish). Restores them on exit."""

    def __init__(self):
        from admm_library_torch import api
        from admm_library_torch.parallel import batch
        self.targets = [(batch, "_phase"), (api, "_f64_continuation"),
                        (api, "_solve_one_phase"), (api, "polish")]
        self.log = []

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.targets]
        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, fn)

    def _wrap(self, name, fn):
        import torch

        def wrapped(*a, **k):
            out = fn(*a, **k)
            if torch.cuda.is_current_stream_capturing():
                # A program's capture: its stages run on the card at
                # replay, not here (its warm-up ran them eagerly).
                return out
            if name == "_phase":
                name_ = ("f64_fallback" if a[0].dtype.itemsize == 8 else
                         "round" if k.get("z_off") is not None else "f32")
            else:
                name_ = {"_solve_one_phase": "phase",
                         "_f64_continuation": "continuation"}.get(name, name)
            self.log.append((name_, int(out.iters.max()), int(out.status.max())))
            return out
        return wrapped

    def iters(self, stage):
        return [it for n, it, _ in self.log if n == stage]

    def count(self, stage):
        return len(self.iters(stage))


def phase_solve_l1_soc(dev):
    import torch
    from admm_library_torch import Settings, Status, solve
    from admm_library_torch.models import clohessy_wiltshire as cw
    from admm_library_torch.models import low_thrust as lt

    out = {}
    # Config 3: the reference's f32 data with f64 outputs (phase_solve).
    qp32, spec, s0 = _config3(dev)
    qp = qp32.astype(torch.float64)
    for backend in ("inv", "pallas_cg"):
        s = Settings(eps_abs=EPS, eps_rel=EPS, max_iter=50000,
                     backend="auto" if backend == "inv" else backend)
        if backend == "inv":
            with _Stages() as st:
                sol, wall, launches = _timed_run(solve, qp, s)
            sol2, wall2, _ = _timed_run(solve, qp, s)
            fields = dict(wall_s=wall, wall_rerun_s=wall2, launches=launches,
                          rerun_bitwise_identical=_bitwise(sol, sol2))
        else:
            # Kernel 2 inside the check graphs, counted at each replay:
            # as often as the capture-off solve launches it.
            sols, graph_rec = _captured_runs(solve, qp, s)
            sol = sols[0]
            fields = _captured_fields("config3 pallas_cg", sols, graph_rec,
                                      solve, qp, s, twin=True)
            launches = fields["launches"]
            with _Stages() as st:
                staged, _, _ = _timed_run(solve, qp, s)
            check(_bitwise(sol, staged), "config3 pallas_cg: a warm rerun "
                  "differs from the first run")
        r_p, r_d, eps_p, eps_d = _mixed_kkt(qp, sol)
        iters = int(sol.iters)
        term = float(cw.propagate(spec, s0, sol.x)[-1].abs().max())
        dv = float(cw.dv_impulses(spec, sol.x).abs().max())
        rec = dict(config="config3", backend=s.backend, n=qp.n, m=qp.m,
                   status=sol.status_name(), iters=iters,
                   kkt_r_prim=r_p, kkt_r_dual=r_d,
                   eps_prim=eps_p, eps_dual=eps_d, objective=float(sol.obj),
                   **fields, phase_iters=st.iters("phase"),
                   polish_attempts=st.count("polish"),
                   propagate_terminal_err=term, max_abs_dv=dv)
        if backend == "inv":
            rec["reference_iters"] = CW_REFERENCE_ITERS
        emit("solve_l1_soc", **rec)
        name = f"config3 {backend}"
        check(int(sol.status) == int(Status.SOLVED), f"{name}: not SOLVED")
        check(r_p <= eps_p and r_d <= eps_d,
              f"{name}: f64 KKT residuals above the mixed criterion")
        check(backend != "inv" or abs(iters - CW_REFERENCE_ITERS)
              <= ITER_SLACK, f"{name}: {iters} iterations, reference "
              f"{CW_REFERENCE_ITERS}")
        check(rec["rerun_bitwise_identical"], f"{name}: rerun not bitwise "
              "identical")
        check(term <= CW_PROPAGATE_RTOL * float(s0.abs().max()),
              f"{name}: propagated impulses miss the target")
        check(dv <= CW_DV_MAX + 1e-6, f"{name}: an impulse exceeds dv_max")
        if backend == "pallas_cg":
            check(launches["pallas_cg_solve"] > 0,
                  f"{name}: the PCG kernel never launched")
        out[name] = rec

    # Config 3 built in f64: the reference model test's physics bar.
    qp, spec, s0 = _config3(dev, torch.float64)
    sol = solve(qp, Settings(eps_abs=EPS, eps_rel=EPS, max_iter=50000))
    r_p, r_d, eps_p, eps_d = _mixed_kkt(qp, sol)
    term = float(cw.propagate(spec, s0, sol.x)[-1].abs().max())
    dv = float(cw.dv_impulses(spec, sol.x).abs().max())
    rec = dict(config="config3", built="float64", backend="auto",
               status=sol.status_name(), iters=int(sol.iters),
               kkt_r_prim=r_p, kkt_r_dual=r_d, eps_prim=eps_p,
               eps_dual=eps_d, propagate_terminal_err=term, max_abs_dv=dv)
    emit("solve_l1_soc", **rec)
    name = "config3 built in f64"
    check(int(sol.status) == int(Status.SOLVED), f"{name}: not SOLVED")
    check(r_p <= eps_p and r_d <= eps_d,
          f"{name}: f64 KKT residuals above the mixed criterion")
    check(term <= CW_PROPAGATE_TOL,
          f"{name}: propagated impulses miss the target by {term:.3e} m")
    check(dv <= CW_DV_MAX + 1e-6, f"{name}: an impulse exceeds dv_max")
    out[name] = rec

    # Config 4 at full width.
    qp32, spec, s, s0 = _config4(dev)
    qp = qp32.astype(torch.float64)
    with _Stages() as st:
        sol, wall, launches = _timed_run(solve, qp, s)
    sol2, wall2, _ = _timed_run(solve, qp, s)
    r_p, r_d, eps_p, eps_d = _mixed_kkt(qp, sol, s.eps_abs, s.eps_rel)
    states = lt.rollout(spec, s0, sol.x)
    us, gam = lt.thrust_profile(spec, sol.x)
    rel_obj = abs(float(sol.obj) - LT_REFERENCE_OBJ) / LT_REFERENCE_OBJ
    rec = dict(config="config4", backend=s.backend, n=qp.n, m=qp.m,
               status=sol.status_name(), iters=int(sol.iters),
               reference_iters=LT_REFERENCE_ITERS, kkt_r_prim=r_p,
               kkt_r_dual=r_d, eps_prim=eps_p, eps_dual=eps_d,
               objective=float(sol.obj), reference_objective=LT_REFERENCE_OBJ,
               objective_rel_diff=rel_obj, wall_s=wall, wall_rerun_s=wall2,
               launches=launches, stages=st.log,
               f32_iters=sum(st.iters("f32")),
               round_iters=st.iters("round"),
               f64_fallback_iters=sum(st.iters("f64_fallback")),
               f64_chunk_iters=st.iters("phase"),
               continuation_entered=st.count("continuation"),
               polish_attempts=st.count("polish"),
               rerun_bitwise_identical=_bitwise(sol, sol2),
               rollout_terminal_err=float(states[-1].abs().max()),
               rollout_scale=float(states.abs().max()),
               max_thrust_minus_gamma=float(
                   (torch.linalg.vector_norm(us, dim=-1) - gam).max()),
               max_gamma_si=float(spec.accel_from_nd(gam).max()))
    emit("solve_l1_soc", **rec)
    check(int(sol.status) == int(Status.SOLVED), "config4: not SOLVED")
    check(r_p <= eps_p and r_d <= eps_d,
          "config4: f64 KKT residuals above the mixed criterion")
    check(launches["fused_iterate_shared"] > 0,
          "config4: the fused kernel never launched")
    check(rec["continuation_entered"] > 0,
          "config4: the f64 continuation was not entered")
    check(rel_obj <= LT_OBJ_RTOL, f"config4: objective {float(sol.obj)} vs "
          f"the reference's {LT_REFERENCE_OBJ}")
    check(rec["rerun_bitwise_identical"], "config4: rerun not bitwise "
          "identical")
    # The reference's model-test bars (tests/test_models.py).
    check(rec["rollout_terminal_err"] < 1e-5 * rec["rollout_scale"],
          "config4: rollout misses the target")
    check(rec["max_thrust_minus_gamma"] < 1e-5,
          "config4: a thrust leaves its cone")
    check(rec["max_gamma_si"] <= LT_U_MAX + 1e-6,
          "config4: thrust above u_max")
    out["config4"] = rec

    # The f64 continuation alone, from the point where the reference
    # entered it: the same start, so the chunks are comparable (the port
    # on the CPU tracks the reference's chunk-end residuals to 8 digits).
    from admm_library_torch import api
    entry = lt.reference_continuation_entry(dev)
    with _Stages() as st:
        cont, wall, _ = _timed_run(api._f64_continuation, qp, entry, s,
                                   s.backend)
    r_p, r_d, eps_p, eps_d = _mixed_kkt(qp, cont, s.eps_abs, s.eps_rel)
    rel_obj = abs(float(cont.obj) - LT_REFERENCE_OBJ) / LT_REFERENCE_OBJ
    rec = dict(config="config4", start="reference_entry",
               entry_iters=int(entry.iters), status=cont.status_name(),
               iters=int(cont.iters), reference_iters=LT_REFERENCE_ITERS,
               kkt_r_prim=r_p, kkt_r_dual=r_d, eps_prim=eps_p,
               eps_dual=eps_d, objective=float(cont.obj),
               objective_rel_diff=rel_obj, wall_s=wall,
               f64_chunk_iters=st.iters("phase"),
               polish_attempts=st.count("polish"))
    emit("solve_l1_soc", **rec)
    name = "config4 from the reference's entry"
    check(int(cont.status) == int(Status.SOLVED), f"{name}: not SOLVED")
    check(r_p <= eps_p and r_d <= eps_d,
          f"{name}: f64 KKT residuals above the mixed criterion")
    check(abs(rec["iters"] - LT_REFERENCE_ITERS) <= LT_CHUNK,
          f"{name}: {rec['iters']} iterations, reference "
          f"{LT_REFERENCE_ITERS}")
    check(rel_obj <= LT_OBJ_RTOL, f"{name}: objective {float(cont.obj)} "
          f"vs the reference's {LT_REFERENCE_OBJ}")
    out["config4_reference_entry"] = rec
    return out


def _kkt_solve_ms(qp, settings, reps=10):
    """Host milliseconds of one KKT solve (no refinement) of the f64
    condensed matrix of `qp` at rho-bar 0.1, one rhs, on 'banded' and on
    'inv'; each call ends in a synchronise."""
    import torch
    from admm_library_torch.core import admm
    from admm_library_torch.ops import kkt
    from admm_library_torch.problem import is_equality_row
    rho = admm.rho_vec_of(torch.tensor(0.1, dtype=qp.dtype, device=qp.device),
                          is_equality_row(qp), settings)
    rhs = torch.ones((1, qp.n), dtype=qp.dtype, device=qp.device)
    out = {}
    for backend in ("banded", "inv"):
        fac = kkt.factor_condensed(qp.P, qp.A, settings.sigma, rho, backend,
                                   settings.band_block)
        kkt.solve_condensed(fac, rhs, backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            kkt.solve_condensed(fac, rhs, backend)
        torch.cuda.synchronize()
        out[backend] = 1e3 * (time.perf_counter() - t0) / reps
    return out


def phase_banded(dev):
    """Config 2 through solve on 'banded', and resolve_backend on the
    card."""
    import torch
    from admm_library_torch import Settings, Status, resolve_backend, solve
    from admm_library_torch.models.double_integrator import rollout

    qp32, spec, s0 = _config2(dev)
    qp = qp32.astype(torch.float64)      # f32 data, f64 outputs
    s = Settings(eps_abs=EPS, eps_rel=EPS, band_block=spec.block,
                 backend="banded")
    (sol, sol2), graph_rec = _captured_runs(solve, qp, s)
    wall, launches = (graph_rec["graph_first"]["wall_s"],
                      graph_rec["graph_first"]["launches"])
    wall2 = graph_rec["graph_rerun"]["wall_s"]
    iters = int(sol.iters)
    inv = solve(qp, s.replace(backend="inv"))
    r_p, r_d, eps_p, eps_d = _mixed_kkt(qp, sol)
    kkt_ms = _kkt_solve_ms(qp, s)
    s4 = _config4(dev)[2].replace(backend="auto")
    picked = {"config2": resolve_backend(s.replace(backend="auto"), dev,
                                         qp.n),
              "config4": resolve_backend(s4, dev, 2000),
              "n4096": resolve_backend(s.replace(backend="auto"), dev,
                                       4096)}
    rec = dict(config="config2", backend="banded", n=qp.n, m=qp.m,
               status=sol.status_name(), iters=iters,
               reference_iters=BANDED_REFERENCE_ITERS, kkt_r_prim=r_p,
               kkt_r_dual=r_d, eps_prim=eps_p, eps_dual=eps_d, wall_s=wall,
               wall_rerun_s=wall2, launches=launches,
               rerun_bitwise_identical=_bitwise(sol, sol2),
               inv_iters=int(inv.iters),
               inv_x_max_abs_diff=float((sol.x - inv.x).abs().max()),
               rollout_terminal_err=float(
                   rollout(spec, s0, sol.x)[-1].abs().max()),
               resolve_backend_auto=picked, kkt_solve_ms=kkt_ms, **graph_rec,
               **_capture_off_fields("banded", sol, launches, solve, qp, s))
    emit("banded", **rec)
    check(int(sol.status) == int(Status.SOLVED), "banded: not SOLVED")
    check(r_p <= eps_p and r_d <= eps_d,
          "banded: f64 KKT residuals above the mixed criterion")
    check(abs(iters - BANDED_REFERENCE_ITERS) <= ITER_SLACK,
          f"banded: {iters} iterations, reference {BANDED_REFERENCE_ITERS}")
    check(rec["rollout_terminal_err"] <= ROLLOUT_TOL,
          "banded: rollout misses the target")
    check(rec["inv_x_max_abs_diff"] <= X_AGREE,
          "banded: 'banded' and 'inv' solutions disagree")
    check(rec["rerun_bitwise_identical"], "banded: rerun not bitwise "
          "identical")
    check(picked == {"config2": "inv", "config4": "inv", "n4096": "banded"},
          f"banded: resolve_backend on the card picked {picked}")
    _check_captured("banded", rec)
    _check_program("banded", rec)
    return rec


def phase_horizon_spike(dev, x_inv):
    """The reference's horizon_spike_1024 cell; x_inv is phase 4's 'inv'
    solution of the same batch."""
    import torch
    from admm_library_torch import Settings, Status, solve_batch_shared
    from admm_library_torch.models import monte_carlo as mc
    from admm_library_torch.utils.oracle import kkt_residuals

    batch = 1024
    qp32, spec, _ = mc.monte_carlo_mpc_from_s0(mc.reference_s0(batch),
                                               device=dev)
    qp = qp32.astype(torch.float64)
    s = Settings(eps_abs=EPS, eps_rel=EPS, band_block=spec.block,
                 backend="spike", spike_parts=10)
    (sol, sol2), graph_rec = _captured_runs(solve_batch_shared, qp, s)
    wall, launches = (graph_rec["graph_first"]["wall_s"],
                      graph_rec["graph_first"]["launches"])
    wall2 = graph_rec["graph_rerun"]["wall_s"]
    r_p, r_d, _ = kkt_residuals(qp, sol.x, sol.z, sol.y)
    lockstep = int(sol.iters.max())
    solved = int((sol.status == int(Status.SOLVED)).sum())
    rec = dict(cell="horizon_spike_1024", batch=batch, n=qp.n, m=qp.m,
               spike_parts=10, solved=solved, lockstep_iters=lockstep,
               reference_iters=SPIKE_REFERENCE_ITERS,
               iters_lane_mean=float(sol.iters.float().mean()),
               kkt_r_prim_max=float(r_p.max()),
               kkt_r_dual_max=float(r_d.max()), wall_s=wall,
               wall_rerun_s=wall2, launches=launches,
               rerun_bitwise_identical=_bitwise(sol, sol2),
               inv_x_max_abs_diff=float((sol.x - x_inv).abs().max()),
               **graph_rec,
               **_capture_off_fields("horizon_spike", sol, launches,
                                     solve_batch_shared, qp, s))
    emit("horizon_spike", **rec)
    check(solved == batch, f"horizon_spike: {batch - solved} lanes not "
          "SOLVED")
    check(rec["kkt_r_prim_max"] <= EPS and rec["kkt_r_dual_max"] <= EPS,
          f"horizon_spike: f64 KKT residuals above {EPS}")
    check(abs(lockstep - SPIKE_REFERENCE_ITERS) <= ITER_SLACK,
          f"horizon_spike: {lockstep} lockstep iterations, reference "
          f"{SPIKE_REFERENCE_ITERS}")
    check(rec["inv_x_max_abs_diff"] <= X_AGREE,
          "horizon_spike: 'spike' and 'inv' solutions disagree")
    check(rec["rerun_bitwise_identical"], "horizon_spike: rerun not "
          "bitwise identical")
    _check_captured("horizon_spike", rec)
    _check_program("horizon_spike", rec)
    return rec


def phase_solve_batch(dev):
    """BATCH_LANES independent config-1 problems through solve_batch."""
    import torch
    from admm_library_torch import (QPData, Settings, Status, resolve_backend,
                                    solve, solve_batch)
    from admm_library_torch import api
    from admm_library_torch.models.random_qp import random_box_qp

    gen = torch.Generator().manual_seed(0)
    lanes = [random_box_qp(gen, device=dev).astype(torch.float64)
             for _ in range(BATCH_LANES)]
    qp = QPData(**{f: torch.stack([getattr(q, f) for q in lanes])
                   for f in ("P", "q", "A", "l", "u", "lam")},
                cone=lanes[0].cone)
    s = Settings(eps_abs=BATCH_EPS, eps_rel=BATCH_EPS, max_iter=20000)
    backend = resolve_backend(s, dev, qp.n)
    sol, wall, launches = _timed_run(solve_batch, qp, s)
    sol2, wall2, _ = _timed_run(solve_batch, qp, s)
    kkt_ok = []
    for i, lane in enumerate(lanes):
        one = dataclasses.replace(
            sol, **{f: getattr(sol, f)[i] for f in ("x", "z", "y")})
        r_p, r_d, eps_p, eps_d = _mixed_kkt(lane, one, BATCH_EPS, BATCH_EPS)
        kkt_ok.append(r_p <= eps_p and r_d <= eps_d)
    held = []
    for i in range(BATCH_CHECKED):
        lane = lanes[i]
        zeros = [torch.zeros(w, dtype=lane.dtype, device=dev)
                 for w in (lane.n, lane.m, lane.m)]
        core = api._solve_core(lane, *zeros, s, backend)
        one = solve(lane, s)
        held.append(dict(
            lane=i, iters=int(sol.iters[i]), core_iters=int(core.iters),
            status_equal=int(core.status) == int(sol.status[i]),
            core_x_max_abs_diff=float((core.x - sol.x[i]).abs().max()),
            solve_status=one.status_name(), solve_iters=int(one.iters),
            solve_x_max_abs_diff=float((one.x - sol.x[i]).abs().max())))
    it = sol.iters.double()
    solved = int((sol.status == int(Status.SOLVED)).sum())
    rec = dict(config="config1", lanes=BATCH_LANES, n=qp.n, m=qp.m,
               backend=backend, eps=BATCH_EPS, solved=solved,
               kkt_within_criterion=sum(kkt_ok),
               iters_min=int(it.min()), iters_median=float(it.median()),
               iters_max=int(it.max()), lockstep_iters=int(it.max()),
               wall_s=wall, wall_rerun_s=wall2, launches=launches,
               rerun_bitwise_identical=_bitwise(sol, sol2),
               lanes_held=held)
    emit("solve_batch", **rec)
    check(solved == BATCH_LANES,
          f"solve_batch: {BATCH_LANES - solved} lanes not SOLVED")
    check(all(kkt_ok), "solve_batch: f64 KKT residuals of "
          f"{BATCH_LANES - sum(kkt_ok)} lanes above the mixed criterion")
    for h in held:
        name = f"solve_batch lane {h['lane']}"
        check(h["status_equal"], f"{name}: status differs from _solve_core")
        check(abs(h["iters"] - h["core_iters"]) <= ITER_SLACK,
              f"{name}: {h['iters']} iterations, _solve_core "
              f"{h['core_iters']}")
        check(h["core_x_max_abs_diff"] <= BATCH_X_AGREE,
              f"{name}: x differs from _solve_core's")
        check(h["solve_status"] == "SOLVED", f"{name}: solve not SOLVED")
        check(h["solve_x_max_abs_diff"] <= BATCH_X_AGREE,
              f"{name}: x differs from solve's")
    check(rec["rerun_bitwise_identical"], "solve_batch: rerun not bitwise "
          "identical")
    return rec


class _PhaseOutputs:
    """Records what each call of `module.name` returns (a consensus
    phase function's, with whether it ran with a re-centring offset;
    the host's agreed reads)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        fn = getattr(self.module, self.name)
        self.orig = fn

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            self.calls.append((kw.get("z_off") is not None, out))
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def first_plain(self):
        """The first phase without an offset: the f32 phase."""
        return next(out for has_off, out in self.calls if not has_off)


def _copies_bitwise(z, ml, ns):
    """Left-edge rows of block b against the right-edge rows of block
    b-1 in z (..., blocks, mb)."""
    import torch
    return torch.equal(z[..., 1:, ml:ml + ns], z[..., :-1, ml + ns:])


def _copies_x_gap(x, ns):
    return float((x[..., 1:, :ns] - x[..., :-1, -ns:]).abs().max())


def _mono_controls(s0s, dev):
    """Controls (K, N, nu) of the monolithic config-2 MPC (N=50, dim 3)
    from each initial state of s0s (K, 6), built in f64 and solved at
    MONO_EPS by solve (K=1) or solve_batch_shared."""
    import numpy as np
    import torch
    from admm_library_torch import (QPData, Settings, Status, solve,
                                    solve_batch_shared)
    from admm_library_torch.models.double_integrator import (
        build_mpc_qp, mpc_bounds_for_s0)
    f64 = torch.float64
    qp, spec = build_mpc_qp(s0s[0], np.zeros(6), N=CONSENSUS_N, dim=3,
                            dtype=f64, device=dev)
    s = Settings(eps_abs=MONO_EPS, eps_rel=MONO_EPS)
    if s0s.shape[0] == 1:
        sol = solve(qp, s)
        x, status = sol.x[None], sol.status[None]
    else:
        l, u = mpc_bounds_for_s0(qp, spec, s0s.to(device=dev, dtype=f64))
        sol = solve_batch_shared(QPData(P=qp.P, q=qp.q, A=qp.A, l=l, u=u,
                                        lam=qp.lam, cone=qp.cone), s)
        x, status = sol.x, sol.status
    check(bool((status == int(Status.SOLVED)).all()),
          "consensus: a monolithic reference solve is not SOLVED")
    b, nu = spec.block, spec.nu
    return torch.stack([x[:, k * b:k * b + nu]
                        for k in range(CONSENSUS_N)], dim=1)


def _controls(spec, mpc, x_blocks):
    import torch
    from admm_library_torch.models.partitioned import assemble_trajectory
    us, _ = assemble_trajectory(spec, mpc, x_blocks)
    return torch.from_numpy(us)


def phase_consensus(dev, scale):
    """consensus_solve of config 2's problem split into 10 blocks, on a
    1x1 mesh on the card (no process group)."""
    import numpy as np
    import torch
    from admm_library_torch import Settings, Status
    from admm_library_torch.models.partitioned import partition_mpc
    from admm_library_torch.parallel import consensus, runtime

    _, _, s0 = _config2(dev)
    qp, spec, mpc = partition_mpc(s0, np.zeros(6), N=CONSENSUS_N,
                                  n_blocks=CONSENSUS_BLOCKS, dim=3,
                                  device=dev)
    mesh = runtime.make_mesh()
    check(mesh.device == dev and mesh.groups == {"data": None,
                                                 "horizon": None},
          "consensus: the 1x1 mesh is not on the card or has a group")
    s = Settings(eps_abs=EPS, eps_rel=EPS,
                 rho_edge_scale=CONSENSUS_EDGE_SCALE)
    with _PhaseOutputs(consensus, "_consensus_phase") as cap:
        (sol, sol2), graph_rec = _captured_runs(consensus.consensus_solve,
                                                qp, spec, mesh, s)
    wall, launches = (graph_rec["graph_first"]["wall_s"],
                      graph_rec["graph_first"]["launches"])
    wall2 = graph_rec["graph_rerun"]["wall_s"]
    iters = int(sol.iters)
    ml, ns = spec.m_local, spec.ns
    f32_phase = cap.first_plain()
    t0 = time.perf_counter()
    mono = _mono_controls(s0[None].cpu(), dev)
    mono_s = time.perf_counter() - t0
    ctrl_diff = float((_controls(spec, mpc, sol.x) - mono[0].cpu()).abs()
                      .max())
    rec = dict(n_blocks=spec.n_blocks, nb=spec.nb, mb=spec.mb,
               status=Status(int(sol.status)).name, iters=iters,
               reference_iters=CONSENSUS_REFERENCE_ITERS,
               f32_phase_iters=int(f32_phase.iters),
               r_prim=float(sol.r_prim), r_dual=float(sol.r_dual),
               wall_s=wall, wall_rerun_s=wall2,
               mono_reference_s=mono_s, hand_written_launches=launches,
               controls_max_abs_diff_mono=ctrl_diff,
               f32_phase_z_copies_bitwise=_copies_bitwise(f32_phase.z, ml,
                                                          ns),
               x_copies_max_gap=_copies_x_gap(sol.x, ns),
               rerun_bitwise_identical=_bitwise(sol, sol2), **graph_rec,
               **_capture_off_fields("consensus", sol, launches,
                                     consensus.consensus_solve, qp, spec,
                                     mesh, s), **scale)
    emit("consensus", **rec)
    check(int(sol.status) == int(Status.SOLVED), "consensus: not SOLVED")
    check(abs(iters - CONSENSUS_REFERENCE_ITERS) <= ITER_SLACK,
          f"consensus: {iters} iterations, reference "
          f"{CONSENSUS_REFERENCE_ITERS}")
    check(ctrl_diff <= X_AGREE,
          "consensus: controls differ from the monolithic solve")
    check(rec["f32_phase_z_copies_bitwise"],
          "consensus: boundary copies of z not bitwise equal")
    check(rec["x_copies_max_gap"] <= COPY_X_AGREE,
          "consensus: boundary copies of x disagree")
    check(rec["rerun_bitwise_identical"], "consensus: rerun not bitwise "
          "identical")
    _check_captured("consensus", rec)
    return rec


def phase_consensus_mc(dev, scale):
    """The reference's consensus_mc_1024 cell at full width: 1024
    dispersed scenarios (the JAX draw) of config 2's problem in 10
    blocks, consensus_solve_mc on a 1x1 mesh on the card."""
    import numpy as np
    import torch
    from admm_library_torch import Settings, Status
    from admm_library_torch.models.partitioned import (
        partition_mpc_from_s0, reference_s0)
    from admm_library_torch.parallel import consensus_mc, runtime

    _, _, s0 = _config2(dev)
    qp, spec, mpc, s0s = partition_mpc_from_s0(
        reference_s0(), s0, np.zeros(6), N=CONSENSUS_N,
        n_blocks=CONSENSUS_BLOCKS, dim=3, device=dev)
    batch = s0s.shape[0]
    mesh = runtime.make_mesh()
    s = Settings(eps_abs=EPS, eps_rel=EPS,
                 rho_edge_scale=CONSENSUS_EDGE_SCALE)
    with _PhaseOutputs(consensus_mc, "_mc_phase") as cap:
        (sol, sol2), graph_rec = _captured_runs(
            consensus_mc.consensus_solve_mc, qp, spec, mesh, s)
    wall, launches = (graph_rec["graph_first"]["wall_s"],
                      graph_rec["graph_first"]["launches"])
    wall2 = graph_rec["graph_rerun"]["wall_s"]
    it = sol.iters.double()
    lockstep = int(it.max())
    solved = int((sol.status == int(Status.SOLVED)).sum())
    ml, ns = spec.m_local, spec.ns
    f32_phase = cap.first_plain()
    held = CONSENSUS_LANES_HELD
    t0 = time.perf_counter()
    mono = _mono_controls(s0s[:held].cpu().double(), dev).cpu()
    mono_s = time.perf_counter() - t0
    ctrl_diff = max(float((_controls(spec, mpc, sol.x[i]) - mono[i]).abs()
                          .max()) for i in range(held))
    rec = dict(cell="consensus_mc_1024", batch=batch,
               n_blocks=spec.n_blocks, nb=spec.nb, mb=spec.mb,
               solved=solved, lockstep_iters=lockstep,
               reference_iters=CONSENSUS_MC_REFERENCE_ITERS,
               iters_lane_min=int(it.min()),
               iters_lane_median=float(it.median()),
               iters_lane_max=lockstep,
               reference_lane_min=CONSENSUS_MC_REFERENCE_LANE_MIN,
               reference_lane_max=CONSENSUS_MC_REFERENCE_ITERS,
               f32_phase_lockstep_iters=int(f32_phase.iters.max()),
               r_prim_max=float(sol.r_prim.max()),
               r_dual_max=float(sol.r_dual.max()),
               wall_s=wall, wall_rerun_s=wall2,
               mono_reference_s=mono_s, hand_written_launches=launches,
               lanes_held=held,
               controls_max_abs_diff_mono=ctrl_diff,
               f32_phase_z_copies_bitwise=_copies_bitwise(f32_phase.z, ml,
                                                          ns),
               x_copies_max_gap=_copies_x_gap(sol.x, ns),
               rerun_bitwise_identical=_bitwise(sol, sol2), **graph_rec,
               **_capture_off_fields("consensus_mc", sol, launches,
                                     consensus_mc.consensus_solve_mc, qp,
                                     spec, mesh, s), **scale)
    emit("consensus_mc", **rec)
    check(solved == batch, f"consensus_mc: {batch - solved} lanes not "
          "SOLVED")
    check(abs(lockstep - CONSENSUS_MC_REFERENCE_ITERS) <= ITER_SLACK,
          f"consensus_mc: {lockstep} lockstep iterations, reference "
          f"{CONSENSUS_MC_REFERENCE_ITERS}")
    check(ctrl_diff <= X_AGREE,
          "consensus_mc: controls differ from the monolithic solves")
    check(rec["f32_phase_z_copies_bitwise"],
          "consensus_mc: boundary copies of z not bitwise equal")
    check(rec["x_copies_max_gap"] <= COPY_X_AGREE,
          "consensus_mc: boundary copies of x disagree")
    check(rec["rerun_bitwise_identical"], "consensus_mc: rerun not bitwise "
          "identical")
    _check_captured("consensus_mc", rec)
    return rec


def _block_kkt(qp, sol, eps=EPS):
    """The f64 KKT residuals of a consensus solution on its block data,
    each lane's against the mixed criterion as the drivers' own f64
    check forms it (the blocks' rows A x - z and P x + q + Aᵀ y, every
    norm a max over the lane's blocks): (all within, worst ratio)."""
    import torch
    from admm_library_torch.problem import mv, vm
    f64 = torch.float64
    P, q, A = (t.to(f64) for t in (qp.P, qp.q, qp.A))
    x, z, y = (t.to(f64) for t in (sol.x, sol.z, sol.y))
    Ax, Px, Aty = mv(A, x), mv(P, x), vm(y, A)

    def norm(v):
        return v.abs().amax(dim=(-2, -1))
    r_p, r_d = norm(Ax - z), norm(Px + q + Aty)
    eps_p = eps + eps * torch.maximum(norm(Ax), norm(z))
    eps_d = eps + eps * torch.maximum(torch.maximum(norm(Px), norm(Aty)),
                                      q.abs().max())
    ratio = torch.maximum(r_p / eps_p, r_d / eps_d)
    return bool((ratio <= 1.0).all()), float(ratio.max())


def phase_consensus_cg(dev):
    """Phases consensus and consensus_mc on 'cg': config 2's problem in
    10 blocks through consensus_solve, and CONSENSUS_CG_LANES lanes of
    the consensus_mc_1024 draw through consensus_solve_mc, on a 1x1
    mesh, each check one graph whose CGs are conditional nodes. Each
    lane SOLVED within the f64 block KKT criterion, bitwise the same
    solve with every segment eager, a rerun bitwise and capturing
    nothing, its host reads at most its checks and PHASE_READS more."""
    import numpy as np
    from admm_library_torch import Settings, Status
    from admm_library_torch.models.partitioned import (
        partition_mpc, partition_mpc_from_s0, reference_s0)
    from admm_library_torch.parallel import consensus, consensus_mc, runtime

    _, _, s0 = _config2(dev)
    mesh = runtime.make_mesh()
    s = Settings(eps_abs=EPS, eps_rel=EPS,
                 rho_edge_scale=CONSENSUS_EDGE_SCALE, backend="cg")
    qp1, spec1, _ = partition_mpc(s0, np.zeros(6), N=CONSENSUS_N,
                                  n_blocks=CONSENSUS_BLOCKS, dim=3,
                                  device=dev)
    qpb, specb, _, _ = partition_mpc_from_s0(
        reference_s0()[:CONSENSUS_CG_LANES], s0, np.zeros(6), N=CONSENSUS_N,
        n_blocks=CONSENSUS_BLOCKS, dim=3, device=dev)
    out = {}
    for name, fn, qp, spec in (
            ("consensus", consensus.consensus_solve, qp1, spec1),
            ("consensus_mc", consensus_mc.consensus_solve_mc, qpb, specb)):
        tag = f"consensus_cg {name}"
        sols, graph_rec = _captured_runs(fn, qp, spec, mesh, s)
        sol = sols[0]
        fields = _captured_fields(tag, sols, graph_rec, fn, qp, spec, mesh,
                                  s, twin=True)
        reads, checks = _check_reads(tag, graph_rec)
        kkt_ok, kkt_worst = _block_kkt(qp, sol)
        solved = int((sol.status == int(Status.SOLVED)).sum())
        nodes = graph_rec["nodes_per_graph"]
        rec = dict(path=name, n_blocks=spec.n_blocks, nb=spec.nb,
                   mb=spec.mb, lanes=sol.status.numel(), solved=solved,
                   iters=int(sol.iters.max()),
                   iters_lane_min=int(sol.iters.min()),
                   kkt_within_criterion=kkt_ok, kkt_worst_ratio=kkt_worst,
                   **fields, host_reads=reads,
                   host_reads_first=graph_rec["graph_first"]["host_reads"],
                   checks=checks, graph_entries=graph_rec["graph_entries"],
                   cg_body_nodes=graph_rec["body_nodes"],
                   nodes_max=max(nodes.values()),
                   segments=graph_rec["graph_rerun"]["segments"],
                   peak_memory_bytes=graph_rec["peak_memory_bytes"])
        emit("consensus_cg", **rec)
        check(solved == sol.status.numel(),
              f"{tag}: {sol.status.numel() - solved} lanes not SOLVED")
        check(kkt_ok, f"{tag}: f64 block KKT residuals above the mixed "
              "criterion")
        check(rec["cg_body_nodes"]
              and min(rec["cg_body_nodes"].values()) > 0,
              f"{tag}: a check graph holds no conditional body")
        out[name] = rec
    return out


def phase_data_axis(dev, sol1024):
    """Config 5 at 1024 through the data axis at one rank: shard_batch
    on make_data_mesh(1) and solve_batch_shared(..., mesh=), bitwise the
    phase-4 solve without a mesh, through kernel 1."""
    import torch
    from admm_library_torch import (Settings, make_data_mesh, shard_batch,
                                    solve_batch_shared)
    from admm_library_torch.core import graph
    from admm_library_torch.models import monte_carlo as mc

    qp32, _, _ = mc.monte_carlo_mpc_from_s0(mc.reference_s0(1024),
                                            device=dev)
    mesh = make_data_mesh(1)
    check(mesh.device == dev and mesh.groups == {"data": None,
                                                 "horizon": None},
          "data_axis: the 1-rank mesh is not on the card or has a group")
    qs, *_ = shard_batch(qp32.astype(torch.float64), mesh)
    s = Settings(eps_abs=EPS, eps_rel=EPS)
    sol, wall, launches = _timed_run(
        lambda: solve_batch_shared(qs, s, mesh=mesh))
    # A rerun: the 1-rank mesh keys as none, one program launch.
    before = dict(graph.CACHE.stats)
    reads = _HostReads()
    sol2, wall2, launches2 = _timed_run(
        lambda: solve_batch_shared(qs, s, mesh=mesh), reads=reads)
    rerun = {k: graph.CACHE.stats[k] - before[k] for k in before}
    rec = dict(batch=1024, mesh=dict(mesh.shape), wall_s=wall,
               wall_rerun_s=wall2, rerun=rerun, rerun_host_reads=reads.count,
               lockstep_iters=int(sol.iters.max()),
               kernel_launches=launches["fused_iterate_shared"],
               bitwise_equal_to_slice=_bitwise(sol, sol1024),
               rerun_bitwise_identical=_bitwise(sol, sol2))
    emit("data_axis", **rec)
    check(rec["kernel_launches"] > 0, "data_axis: kernel 1 never launched")
    check(rec["bitwise_equal_to_slice"],
          "data_axis: not bitwise the solve without a mesh")
    check(rec["rerun_bitwise_identical"] and launches2 == launches,
          "data_axis: the rerun differs from the first run")
    check(rerun["replays"] == 1 and rerun["captures"] == 0
          and reads.count == 0,
          f"data_axis: the rerun took {rerun['replays']} graph launches, "
          f"{rerun['captures']} captures and {reads.count} host reads")
    return rec


def phase_rowshard(dev, scale):
    """rowshard_qp4096: one n=4096, m=8192 box QP through
    solve_rowsharded_hybrid on a 1-rank data mesh on the card, its loop
    replayed as captured graphs (a check one graph, its CGs conditional
    nodes): from an empty cache and two reruns (the host's reads of the
    last at most its checks and PHASE_READS more, its replays' device
    time), then once with every segment eager (bitwise the captured
    solve; its agreed reads counted). No profiled run: a profile loses
    the kernels inside conditional bodies."""
    import torch
    from admm_library_torch import Settings, Status
    from admm_library_torch.core import graph
    from admm_library_torch.models.random_qp import random_box_qp
    from admm_library_torch.parallel import make_data_mesh, runtime
    from admm_library_torch.parallel.rowshard import solve_rowsharded_hybrid

    gen = torch.Generator(device=dev).manual_seed(0)
    qp32 = random_box_qp(gen, n=ROWSHARD_N, m=ROWSHARD_M, device=dev)
    qp = qp32.astype(torch.float64)      # f32 data, f64 outputs
    mesh = make_data_mesh(1)
    s = Settings(eps_abs=EPS, eps_rel=EPS, backend="cg")
    sols, graph_rec = _captured_runs(solve_rowsharded_hybrid, qp, mesh, s,
                                     reruns=2)
    sol, sol2 = sols[0], sols[-1]
    wall = graph_rec["graph_first"]["wall_s"]
    launches = graph_rec["graph_first"]["launches"]
    wall2 = graph_rec["graph_rerun"]["wall_s"]
    capturable = graph.capturable
    graph.capturable = lambda *a, **kw: False
    try:
        with _PhaseOutputs(runtime, "agree") as reads:
            eager, eager_wall, _ = _timed_run(solve_rowsharded_hybrid, qp,
                                              mesh, s)
    finally:
        graph.capturable = capturable
    r_p, r_d, eps_p, eps_d = _mixed_kkt(qp, sol)
    iters = int(sol.iters)
    rec = dict(cell="rowshard_qp4096", n=qp.n, m=qp.m,
               status=Status(int(sol.status)).name, iters=iters,
               parent_iters=ROWSHARD_PARENT_ITERS,
               tpu_iters_on_the_jax_draw=ROWSHARD_TPU_ITERS,
               kkt_r_prim=r_p, kkt_r_dual=r_d, eps_prim=eps_p,
               eps_dual=eps_d, r_prim_over_eps=r_p / eps_p,
               r_dual_over_eps=r_d / eps_d,
               cg_steps=int(sol.cg_steps),
               parent_cg_steps=ROWSHARD_PARENT_CG_STEPS,
               cg_steps_per_iteration=int(sol.cg_steps) / iters,
               z_minus_Ax_max=float((qp.A @ sol.x - sol.z).abs().max()),
               wall_s=wall, wall_rerun_s=wall2,
               wall_reruns_s=[r["wall_s"] for r in graph_rec["graph_reruns"]],
               eager_wall_s=eager_wall,
               host_reads_eager=len(reads.calls),
               host_reads_eager_per_iteration=len(reads.calls) / iters,
               host_reads=graph_rec["graph_rerun"]["host_reads"],
               checks=graph_rec["graph_rerun"]["segments"].get("check", 0),
               cg_body_nodes=graph_rec["body_nodes"],
               hand_written_launches=launches,
               captured_bitwise_eager=all(
                   torch.equal(getattr(sol, f), getattr(eager, f))
                   for f in ("x", "z", "y", "status", "iters", "cg_steps")),
               rerun_bitwise_identical=all(
                   torch.equal(getattr(sol, f), getattr(sol2, f))
                   for f in sol._fields), **graph_rec, **scale)
    emit("rowshard", **rec)
    check(int(sol.status) == int(Status.SOLVED), "rowshard: not SOLVED")
    check(iters == ROWSHARD_PARENT_ITERS
          and rec["cg_steps"] == ROWSHARD_PARENT_CG_STEPS,
          f"rowshard: {iters} iterations and {rec['cg_steps']} CG steps, "
          f"the eager loop took {ROWSHARD_PARENT_ITERS} and "
          f"{ROWSHARD_PARENT_CG_STEPS}")
    check(r_p <= eps_p and r_d <= eps_d,
          "rowshard: f64 KKT residuals above the mixed criterion")
    check(rec["z_minus_Ax_max"] <= ROWSHARD_Z_AGREE,
          "rowshard: z disagrees with A x")
    check(rec["captured_bitwise_eager"],
          "rowshard: the captured solve differs from the eager one")
    check(rec["rerun_bitwise_identical"], "rowshard: rerun not bitwise "
          "identical")
    _check_captured("rowshard", rec)
    _check_reads("rowshard", graph_rec)
    check(graph_rec["graph_rerun"]["captures"] == 0,
          "rowshard: the second rerun captured a segment")
    return rec


def phase_horizon_sharded(dev, scale):
    """Config 5 at 1024 (the JAX draw) in 10 time parts through
    solve_horizon_sharded on a 1x1 mesh on the card: f64 under the plain
    settings against solve_batch_shared lane by lane, f32 under the
    reference gate's settings against JAX's count."""
    import torch
    from admm_library_torch import Settings, Status, solve_batch_shared
    from admm_library_torch.models import monte_carlo as mc
    from admm_library_torch.parallel import runtime
    from admm_library_torch.parallel.horizon import (
        mpc_row_time, partition_qp, solve_horizon_sharded)

    batch = 1024
    qp32, spec, _ = mc.monte_carlo_mpc_from_s0(mc.reference_s0(batch),
                                               device=dev)
    hp, hspec = partition_qp(qp32, spec.block, HORIZON_PARTS,
                             mpc_row_time(spec.N, spec.ns, spec.nu))
    mesh = runtime.make_mesh()
    recs = {}
    for name, kw in (("double", HORIZON_PLAIN), ("single", HORIZON_GATE)):
        s = Settings(**kw)
        (sol, sol2), graph_rec = _captured_runs(solve_horizon_sharded, hp,
                                                hspec, mesh, s)
        wall, launches = (graph_rec["graph_first"]["wall_s"],
                          graph_rec["graph_first"]["launches"])
        wall2 = graph_rec["graph_rerun"]["wall_s"]
        lockstep = int(sol.iters.max())
        rec = dict(precision=name, batch=batch, parts=hspec.parts,
                   npb=hspec.npb, mp=hspec.mp,
                   solved=int((sol.status == int(Status.SOLVED)).sum()),
                   lockstep_iters=lockstep,
                   iters_lane_min=int(sol.iters.min()),
                   r_prim_max=float(sol.r_prim.max()),
                   r_dual_max=float(sol.r_dual.max()), wall_s=wall,
                   wall_rerun_s=wall2, hand_written_launches=launches,
                   rerun_bitwise_identical=all(
                       torch.equal(getattr(sol, f), getattr(sol2, f))
                       for f in sol._fields), **graph_rec,
                   **_capture_off_fields(f"horizon_sharded {name}", sol,
                                         launches, solve_horizon_sharded,
                                         hp, hspec, mesh, s), **scale)
        if name == "double":
            ref, ref_wall, _ = _timed_run(
                solve_batch_shared, qp32.astype(torch.float64),
                s.replace(backend="chol"))
            x_ref = ref.x
            rec.update(
                batch_shared_chol_wall_s=ref_wall,
                iters_equal_batch_shared=bool(torch.equal(sol.iters,
                                                          ref.iters)),
                status_equal_batch_shared=bool(torch.equal(sol.status,
                                                           ref.status)),
                x_gap_rel=float((sol.x.reshape(batch, -1) - x_ref).abs()
                                .max()) / (1.0 + float(x_ref.abs().max())))
        else:
            rec["jax_cpu_lockstep_iters"] = HORIZON_F32_REFERENCE_ITERS
        emit("horizon_sharded", **rec)
        tag = f"horizon_sharded {name}"
        check(rec["solved"] == batch,
              f"{tag}: {batch - rec['solved']} lanes not SOLVED")
        check(rec["rerun_bitwise_identical"],
              f"{tag}: rerun not bitwise identical")
        _check_captured(tag, rec)
        if name == "double":
            check(rec["status_equal_batch_shared"]
                  and rec["iters_equal_batch_shared"],
                  f"{tag}: iterations differ from solve_batch_shared's")
            check(rec["x_gap_rel"] <= HORIZON_X_RTOL,
                  f"{tag}: x differs from solve_batch_shared's")
        else:
            check(abs(lockstep - HORIZON_F32_REFERENCE_ITERS) <= ITER_SLACK,
                  f"{tag}: {lockstep} lockstep iterations, JAX "
                  f"{HORIZON_F32_REFERENCE_ITERS}")
        recs[name] = rec
    return recs


def phase_checkpoint(dev, sol128):
    """Save phase 4's b128 solution, load it back onto the card and
    resume from it: SOLVED within one check."""
    import tempfile
    from pathlib import Path

    import torch
    from admm_library_torch import Settings, Status, solve_batch_shared
    from admm_library_torch.models import monte_carlo as mc
    from admm_library_torch.utils import checkpoint

    qp32, _, _ = mc.monte_carlo_mpc_from_s0(mc.reference_s0(128),
                                            device=dev)
    s = Settings(eps_abs=EPS, eps_rel=EPS, precision="double")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "b128.npz")
        checkpoint.save_state(path, sol128)
        st = checkpoint.load_state(path)
        x0, z0, y0 = checkpoint.resume_warm_start(path)
    loaded = all(torch.equal(st[f], getattr(sol128, f))
                 for f in ("x", "z", "y", "rho", "iters"))
    warm, wall, _ = _timed_run(solve_batch_shared,
                               qp32.astype(torch.float64), s, x0, z0, y0)
    rec = dict(batch=128, loaded_on=str(st["x"].device),
               loaded_bitwise=loaded,
               warm_status=sorted({Status(int(v)).name
                                   for v in warm.status.unique()}),
               warm_lockstep_iters=int(warm.iters.max()),
               check_every=s.check_every, wall_s=wall,
               x_max_abs_diff=float((warm.x - sol128.x).abs().max()))
    emit("checkpoint", **rec)
    check(st["x"].device == dev and x0.device == dev,
          "checkpoint: not loaded onto the card")
    check(loaded, "checkpoint: loaded state differs from the saved one")
    check(bool((warm.status == int(Status.SOLVED)).all()),
          "checkpoint: the resumed batch is not SOLVED")
    check(rec["warm_lockstep_iters"] <= s.check_every,
          "checkpoint: the resumed batch took more than one check")
    return rec


def _first_check_state(kind, step, state):
    """A clone of a loop's initial state, for the loops that start from
    raw data (the batch loop and the phases) the state after their
    prologue: the state its first check meets."""
    import torch
    from admm_library_torch.core import admm, graph
    first = graph._map(torch.clone, state)
    if kind in ("run_admm", "run_admm_lanes", "run_admm_batch_shared"):
        first = dict(first, **step(first, admm.PROLOGUE))
    return first


class _Loops:
    """Records (kind, step, state at the first check) of every
    graph.CheckLoop built inside the block (the loop's own step, which
    runs its pre inside its checks), and in `raw` its initial state; the
    loops run as before, every one plain (`graph.capturable` off), so
    that a program's loops are met once and nothing of the recording
    enters a graph."""

    def __enter__(self):
        from admm_library_torch.core import graph
        self.graph, self.real, self.loops = graph, graph.CheckLoop, []
        self.capturable = graph.capturable
        self.raw = []       # (kind, step, initial state) of each loop

        def spy(kind, step, state, *a, **kw):
            loop = self.real(kind, step, state, *a, **kw)
            self.loops.append((kind, loop.step,
                               _first_check_state(kind, loop.step, state)))
            self.raw.append((kind, loop.step, state))
            return loop
        graph.CheckLoop = spy
        graph.capturable = lambda *a, **k: False
        return self

    def __exit__(self, *exc):
        self.graph.CheckLoop = self.real
        self.graph.capturable = self.capturable


def _replay_is_eager(step, state):
    """Every variant of a check from one state: the eager step on the
    default stream against three runs of it from a cache entry, each
    from the same state (the entry's first run is its eager warm-up;
    every variant is captured at its first run after that, then
    replayed). Returns {variant: whether all agree bitwise on every
    updated entry}."""
    import torch
    from admm_library_torch.core import graph
    cache = graph.CheckCache()
    entry = cache.entry("case", step, state)
    out = {}
    for variant in ((False, False), (False, True), (True, False),
                    (True, True)):
        want = step(graph._map(torch.clone, state), variant)
        ok = True
        for _ in range(3):
            entry.load(state)
            entry.run(variant)
            ok &= all(torch.equal(entry.buffers[k], v)
                      for k, v in want.items())
        out[str(variant)] = ok
    cache.clear()
    return out


def _segment_replay_is_eager(step, state, variant):
    """One named segment from `state`: the eager step on the default
    stream against three runs of it from a cache entry, each from the
    same state (the entry's first run its eager warm-up, then captured
    and replayed twice). Whether all agree bitwise on every leaf the
    step writes."""
    import torch
    from admm_library_torch.core import graph
    cache = graph.CheckCache()
    entry = cache.entry("case", step, state)
    want = list(graph._leaves(step(graph._map(torch.clone, state),
                                   variant)))
    ok = True
    for _ in range(3):
        entry.load(state)
        entry.run(variant)
        got = dict(graph._leaves(entry.buffers))
        ok &= all(torch.equal(got[path], v) for path, v in want)
    ok &= cache.stats["replays"] == 2
    cache.clear()
    return ok


def _graph_nodes():
    """Nodes of every graph in the default cache (its captured template,
    kept by `graph.CACHE.keep_graphs`, read with libcuda's
    cuGraphGetNodes, and the nodes of its conditional bodies, counted at
    their capture), by entry (its place in the cache, kind, dtype of
    x, lanes) and variant. Counted from the graph itself rather than
    from a profiled replay, whose device records CUPTI may drop."""
    import ctypes
    from admm_library_torch.core import graph
    cuda = ctypes.CDLL("libcuda.so.1")
    out = {}
    for i, (key, entry) in enumerate(graph.CACHE.entries.items()):
        x = entry.buffers.get("x", entry.buffers.get("raw", {}).get("q"))
        if x is None:       # polish, the staged rounds: their first leaf
            x = next(t for _, t in graph._leaves(entry.buffers))
        label = f"{i}:{key[0]} {str(x.dtype)[6:]} {tuple(x.shape)}"
        for variant, g in entry.graphs.items():
            n = ctypes.c_size_t(0)
            rc = cuda.cuGraphGetNodes(ctypes.c_void_p(g.raw_cuda_graph()),
                                      None, ctypes.byref(n))
            check(rc == 0, f"graph nodes: cuGraphGetNodes returned {rc}")
            out[f"{label} {_variant_label(variant)}"] = (
                n.value + entry.body_nodes.get(variant, 0))
    return out


def _batch_graph_fields(fn, qp, s, sol, runs):
    """For a config-5 batch: the graphs that hold kernel 1 (at top level
    or in a conditional body), and the same solve with every segment
    eager (its wall-clock, kernel launches and whether the captured
    solve is bitwise the same)."""
    import torch
    from admm_library_torch.core import graph
    from admm_library_torch.ops import fused
    kernel_graphs = sum(
        fused.fused_iterate_shared in (e.kernels.get(v, [])
                                       + e.body_kernels.get(v, []))
        for e in graph.CACHE.entries.values() for v in e.graphs)
    eager, wall, launches = _capture_off(fn, qp, s)
    return dict(
        graphs_holding_kernel_1=kernel_graphs,
        eager_wall_s=wall,
        eager_launches=launches["fused_iterate_shared"],
        captured_is_eager_bitwise=_bitwise(sol, eager) and torch.equal(
            sol.history, eager.history),
        launches_equal=runs[0]["fused_iterate_shared"]
        == runs[1]["fused_iterate_shared"]
        == launches["fused_iterate_shared"])


def _fallback_iters():
    """The iterations the f64 fallback's phase ran in the last replay of
    the default cache's shared-batch program: the state of its loop, the
    first loop inside the program's second branch (graph.cond; the
    rounds' graph.repeat is the first), read on the host."""
    from admm_library_torch.core import graph
    entry = next(e for k, e in graph.CACHE.entries.items()
                 if k[0] == "solve_batch_shared")
    state = entry.loops["node1/loop0:run_admm_batch_shared"]
    return int(state["it"])


def _traced_fields(tag, want, fn, *args):
    """fn(*args) with utils/trace on (its graphs entries of their own): a
    first run (warm-up and capture) and a rerun, held bitwise to the
    untraced rerun `want`, and the passes of the phases' WHILE nodes in
    the traced rerun, which the card counts only in graphs captured with
    tracing on. Returns the record's fields."""
    from admm_library_torch.core import graph
    from admm_library_torch.utils import trace
    trace.enable()
    try:
        fn(*args)
        graph.zero_counts()
        sol, wall, _ = _timed_run(fn, *args)
        passes = graph.CACHE.while_passes()
    finally:
        trace.disable()
        trace.reset()
    out = dict(traced_rerun_wall_s=wall, traced_rerun_while_passes=passes,
               traced_rerun_is_untraced_bitwise=_bitwise(sol, want))
    check(out["traced_rerun_is_untraced_bitwise"],
          f"{tag}: the traced rerun differs from the untraced one")
    return out


def _check_batch_graph(name, rec):
    check(rec["graphs_holding_kernel_1"] > 0,
          f"graph {name}: no graph holds kernel 1")
    check(rec["captured_is_eager_bitwise"],
          f"graph {name}: the captured solve differs from the eager one")
    check(rec["launches_equal"] and rec["eager_launches"] > 0,
          f"graph {name}: kernel 1's count differs between the eager "
          "solve, the captured first run and the rerun")


def phase_graph(dev):
    """The captured segments (core/graph.py) on configs 3 and 4, the
    config-5 batch at 128 and 1024, solve_batch on 128 config-1 draws,
    config 1 through solve at 'single' and 'double', config 3 on
    'pallas_cg' (kernel 2 inside the check graphs) and config 1 on 'cg'
    (its head, CG block and tail segments): captures,
    replays, warm-ups and capture ms per solve from an empty cache and
    on a rerun (which must capture and warm nothing), nodes per graph,
    host launches and idle share from one profiled run, and a bar on
    config 3's and config 4's host launch calls; a replayed check
    bitwise the eager check from the same state for an f64 chunk of
    config 4, a b128 re-centred round, the consensus-MC f32 phase at
    1024 scenarios and the 'spike' batch at 1024 lanes, and a replayed
    segment bitwise the eager one for config 3's f32 phase prologue and
    a config-4 polish."""
    import dataclasses
    import functools
    import torch
    from admm_library_torch import (QPData, Settings, Status, solve,
                                    solve_batch, solve_batch_shared)
    from admm_library_torch import api
    from admm_library_torch.core import admm, graph
    from admm_library_torch.core.polish import POLISH, polish_step
    import numpy as np
    from admm_library_torch.models import low_thrust as lt
    from admm_library_torch.models import monte_carlo as mc
    from admm_library_torch.models.partitioned import (
        partition_mpc_from_s0, reference_s0)
    from admm_library_torch.models.random_qp import (
        random_box_qp, reference_random_box_qp)
    from admm_library_torch.parallel import consensus_mc, runtime

    qp3, _, _ = _config3(dev)
    qp4, _, s4, _ = _config4(dev)
    qp4 = qp4.astype(torch.float64)
    b = {B: mc.monte_carlo_mpc_from_s0(mc.reference_s0(B), device=dev)[0]
         .astype(torch.float64) for B in (128, 1024)}
    s5 = Settings(eps_abs=EPS, eps_rel=EPS)
    gen = torch.Generator().manual_seed(0)
    lanes = [random_box_qp(gen, device=dev).astype(torch.float64)
             for _ in range(BATCH_LANES)]
    qp1b = QPData(**{f: torch.stack([getattr(q, f) for q in lanes])
                     for f in ("P", "q", "A", "l", "u", "lam")},
                  cone=lanes[0].cone)
    qp1 = reference_random_box_qp(dev).astype(torch.float64)
    s1 = Settings(eps_abs=EPS, eps_rel=EPS, backend="inv")
    paths = {
        "config3": (solve, qp3.astype(torch.float64),
                    Settings(eps_abs=EPS, eps_rel=EPS, max_iter=50000)),
        "config4": (solve, qp4, s4),
        "b128": (solve_batch_shared, b[128], s5),
        "b1024": (solve_batch_shared, b[1024], s5),
        # A target below the f32 rounds' floor: the f64 fallback's IF
        # node is taken on the card.
        "b128_fallback": (solve_batch_shared, b[128],
                          Settings(eps_abs=FALLBACK_EPS,
                                   eps_rel=FALLBACK_EPS)),
        "solve_batch": (solve_batch, qp1b, Settings(
            eps_abs=BATCH_EPS, eps_rel=BATCH_EPS, max_iter=20000)),
        "config1_single": (solve, qp1, s1.replace(precision="single")),
        "config1_double": (solve, qp1, s1.replace(precision="double")),
        # Kernel 2 inside the check graphs; the 'cg' checks' conditional
        # nodes.
        "config3_pcg": (solve, qp3.astype(torch.float64),
                        Settings(eps_abs=EPS, eps_rel=EPS, max_iter=50000,
                                 backend="pallas_cg")),
        "config1_cg": (solve, qp1, s1.replace(backend="cg"))}
    out = {}
    for name, (fn, qp, s) in paths.items():
        graph.CACHE.clear()
        runs = []
        for _ in range(2):
            before = dict(graph.CACHE.stats)
            reads = _HostReads()
            with _SegmentCount() as segments, _ProgramCalls(reads) as progs:
                sol, wall, launches = _timed_run(fn, qp, s, reads=reads)
            runs.append(dict(wall_s=wall, **launches, **{
                k: graph.CACHE.stats[k] - before[k] for k in before},
                host_reads=reads.count, segments=segments.counts,
                programs=progs.calls))
            if len(runs) == 1:
                first_launches = launches
                nodes = _graph_nodes()
        iters = int(sol.iters.max())
        bodies = _body_nodes()
        # No profile: it loses the kernels inside conditional bodies, the
        # phases' checks, and a profile of a graph with conditional nodes
        # faulted with an illegal address. The device time of a rerun's
        # replays instead.
        graph.CACHE.replay_events = []
        _, wall3, _ = _timed_run(fn, qp, s)
        ms = graph.CACHE.replay_ms()
        graph.CACHE.replay_events = None
        device = dict(replay_device_ms=ms,
                      replay_idle_share=1.0 - ms / 1e3 / wall3)
        rec = dict(path=name, iters=iters,
                   solved=int((sol.status == int(Status.SOLVED)).sum()),
                   entries=len(graph.CACHE.entries),
                   first=runs[0], rerun=runs[1],
                   nodes_per_graph=nodes, cg_body_nodes=bodies, **device)
        if name in BATCH_PATHS:
            rec.update(_batch_graph_fields(fn, qp, s, sol, runs))
        else:
            rec.update(_capture_off_fields(f"graph {name}", sol,
                                           first_launches, fn, qp, s))
        if name == "b128_fallback":
            rec["fallback_iters"] = _fallback_iters()
        rec.update(_traced_fields(f"graph {name}", sol, fn, qp, s))
        emit("graph", **rec)
        check(runs[0]["captures"] > 0, f"graph {name}: nothing was captured")
        # Every variant met in the first run was captured there (each
        # entry ran one segment eagerly): a rerun captures and warms
        # nothing.
        check(runs[1]["eager_checks"] == 0 and runs[1]["captures"] == 0,
              f"graph {name}: the rerun warmed or captured a variant")
        check(min(nodes.values()) > 0, f"graph {name}: an empty graph")
        if name in BATCH_PATHS:
            _check_batch_graph(name, rec)
        if name in PROGRAM_CALLS:
            _check_program(f"graph {name}", dict(graph_rerun=runs[1]),
                           PROGRAM_CALLS[name], alone=name != "config4")
        out[name] = rec
    check(out["b128_fallback"]["fallback_iters"] > 0,
          "graph b128_fallback: the f64 fallback's phase ran no check")
    for name, bar in GRAPH_RERUN_LAUNCHES.items():
        check(out[name]["rerun"]["replays"] <= bar,
              f"graph {name}: {out[name]['rerun']['replays']} graph "
              f"launches a rerun, above {bar}")

    # A replayed check is the eager check, from the same state.
    entry = lt.reference_continuation_entry(dev)
    s_chunk = s4.replace(precision="single", warm_start=True, polish=False,
                         recenter_rounds=0, max_iter=0, stall_checks=0)
    with _Loops() as rec4:
        api._solve_one_phase(qp4, entry.x, entry.z, entry.y, s_chunk,
                             s4.backend, rho0=float(entry.rho.max()))
    with _Loops() as rec5:
        solve_batch_shared(b[128], s5)
    (_, step4, state4), = rec4.loops
    step5, state5 = next((step, st) for kind, step, st in rec5.loops
                         if kind == "run_admm_batch_shared"
                         and st["qp"]["q"].dim() == 2)
    # The first check of consensus_mc_1024's f32 phase and of
    # horizon_spike_1024's (one loop each: 'single', no iteration run).
    _, _, s0 = _config2(dev)
    qp_mc, spec_mc, _, _ = partition_mpc_from_s0(
        reference_s0(), s0, np.zeros(6), N=CONSENSUS_N,
        n_blocks=CONSENSUS_BLOCKS, dim=3, device=dev)
    with _Loops() as rec_mc:
        consensus_mc.consensus_solve_mc(
            qp_mc, spec_mc, runtime.make_mesh(), Settings(
                eps_abs=EPS, eps_rel=EPS, precision="single", max_iter=0,
                rho_edge_scale=CONSENSUS_EDGE_SCALE))
    qp_sp, spec_sp, _ = mc.monte_carlo_mpc_from_s0(mc.reference_s0(1024),
                                                   device=dev)
    with _Loops() as rec_sp:
        solve_batch_shared(qp_sp, Settings(
            eps_abs=EPS, eps_rel=EPS, band_block=spec_sp.block,
            backend="spike", spike_parts=10, precision="single",
            max_iter=0))
    (kind_mc, step_mc, state_mc), = rec_mc.loops
    (kind_sp, step_sp, state_sp), = rec_sp.loops
    check(kind_mc == "run_consensus_mc"
          and kind_sp == "run_admm_batch_shared"
          and state_sp["fac"].keys() >= {"Ainv", "Tld"},
          "graph: the consensus-MC or the spike loop was not recorded")
    same = {"config4_f64_chunk": _replay_is_eager(step4, state4),
            "b128_round": _replay_is_eager(step5, state5),
            "consensus_mc_1024_f32": _replay_is_eager(step_mc, state_mc),
            "horizon_spike_1024_f32": _replay_is_eager(step_sp, state_sp)}
    # A named segment replayed is the eager segment: config 3's f32
    # phase prologue (cast, Ruiz, factor, carry from the raw f64 data)
    # and a config-4 polish at the continuation's entry.
    with _Loops() as rec3:
        solve(qp3.astype(torch.float64), Settings(
            eps_abs=EPS, eps_rel=EPS, max_iter=0, polish=False,
            recenter_rounds=0))
    step3, raw3 = next((step, graph._map(torch.clone, st)) for kind, step, st
                       in rec3.raw if kind == "run_admm"
                       and step.keywords["dtype"] == torch.float32)
    pol4 = functools.partial(polish_step, cone=qp4.cone, eps_abs=s4.eps_abs,
                             eps_rel=s4.eps_rel, act_tol=1e-4)
    state_pol4 = dict(qp64=admm.qp_leaves(qp4), sol={
        f.name: getattr(entry, f.name) for f in dataclasses.fields(entry)})
    segments = {
        "config3_f32_prologue": _segment_replay_is_eager(
            step3, raw3, admm.PROLOGUE),
        "config4_polish": _segment_replay_is_eager(pol4, state_pol4,
                                                   POLISH)}
    emit("graph", replay_is_eager_bitwise=same,
         segment_replay_is_eager_bitwise=segments)
    for case, variants in same.items():
        check(all(variants.values()),
              f"graph {case}: a replayed check differs from the eager one")
    for case, ok in segments.items():
        check(ok, f"graph {case}: a replayed segment differs from the "
              "eager one")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import admm_library_torch  # noqa: F401  (turns TF32 off)
    from admm_library_torch.core import graph
    torch.use_deterministic_algorithms(True)
    graph.CACHE.keep_graphs = True  # for _graph_nodes
    dev = torch.device("cuda", 0)
    phase_build()
    smi = phase_device(dev)
    kern = phase_kernel(dev)
    slice128, sol128 = phase_slice(128, dev)
    slice1024, sol1024 = phase_slice(1024, dev)
    cg = phase_cg_kernel(dev)
    phase_solve(dev)
    phase_slice_pcg(dev)
    l1_soc = phase_solve_l1_soc(dev)
    phase_banded(dev)
    spike = phase_horizon_spike(dev, sol1024.x)
    data_axis = phase_data_axis(dev, sol1024)
    del sol1024
    phase_solve_batch(dev)
    phase_cg_paths(dev)
    # For scale, times from this call: the config-5 batch at 1024 on
    # 'inv' (kernel 1) and on 'spike'.
    scale = {"slice_b1024_inv_wall_s": slice1024["wall_s"],
             "horizon_spike_wall_s": spike["wall_s"]}
    phase_consensus(dev, scale)
    phase_consensus_mc(dev, scale)
    phase_consensus_cg(dev)
    phase_rowshard(dev, scale)
    phase_horizon_sharded(dev, scale)
    phase_checkpoint(dev, sol128)
    phase_graph(dev)
    # Each kernel with its launches on this slice's paths and its check
    # and times at the shape of the path that launches it most.
    lt_case = kern["low_thrust_soc_b1"]
    cw_case = cg["cw_b1_float32"]
    fused_launches = {
        "config5_b128": slice128["kernel_launches"],
        "config5_b1024": slice1024["kernel_launches"],
        "config5_b1024_data_axis": data_axis["kernel_launches"],
        "config4": l1_soc["config4"]["launches"]["fused_iterate_shared"]}
    print(json.dumps({"kernels": [{
        "name": "fused_iterate_shared", "route": "cuda",
        "source": "admm_library_torch/csrc/fused_iterate.cu",
        "replaces": "admm_library_tpu/ops/fused.py:201",
        "launches": fused_launches["config4"],
        "launches_by_path": fused_launches,
        "max_abs_err": lt_case["max_abs_err"], "ms": lt_case["ms"],
        "plain_ms": lt_case["plain_ms"], "bound_ms": lt_case["bound_ms"],
        "bound_by": lt_case["bound_by"],
        "library_ms": lt_case["library_ms"],
        "at": "config 4, B=1, n=2000, m=2206, k=25; library: torch.matmul "
              "products only (cuBLAS, one CUDA graph); launches: eager "
              "launches and passes of the phases' bodies that launch it "
              "(counted on the card)"}, {
        "name": "pallas_cg_solve", "route": "cuda",
        "source": "admm_library_torch/csrc/pallas_cg.cu",
        "replaces": "admm_library_tpu/ops/pallas_cg.py:82",
        "launches": l1_soc["config3 pallas_cg"]["launches"][
            "pallas_cg_solve"],
        "eager_launches": l1_soc["config3 pallas_cg"]["eager_launches"][
            "pallas_cg_solve"],
        "design": cw_case["design"], "cluster": cw_case["cluster"],
        "lane_tile": cw_case["lane_tile"], "stream_ms": cw_case["stream_ms"],
        "max_abs_err": cw_case["max_abs_err"], "ms": cw_case["ms"],
        "plain_ms": cw_case["plain_ms"], "bound_ms": cw_case["bound_ms"],
        "bound_by": cw_case["bound_by"],
        "library_ms": cw_case["library_ms"],
        "at": "config 3, B=1, n=60, 200 steps, f32; library: "
              "torch.cholesky_solve on a precomputed factor; launches: "
              "passes of the phases' bodies that launch it, counted on "
              "the card (eager_launches: the same solve with every "
              "segment eager)"}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
