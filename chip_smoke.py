#!/usr/bin/env python3
"""Smoke run of admm_library_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed). Phases, one JSON line each:

1. device  — the card's name and the nvidia-smi name/power-limit line;
2. build   — builds csrc/ with nvcc for sm_90a (ptxas register report);
3. kernel  — the fused ADMM iteration kernel against its plain PyTorch
             twin on the same inputs, at the flagship shape (batch 128,
             k=25, box rows, from a real Ruiz + 'inv' factor of the
             config-5 problem) and on a small L1 + uniform-SOC case;
             max errors against the stated tolerance, median times;
4. slice   — solve_batch_shared on the config-5 Monte-Carlo batch
             (horizon 50, dim 3: n=450, m=456) at batch 128 and 1024,
             using the JAX reference's own dispersions; every lane
             SOLVED, f64 KKT residuals <= 1e-6, lockstep iterations
             325 ± 25, the kernel launched, a rerun bitwise identical.

Any failed check raises, so the script exits non-zero and prints no
result. Its last line is {"ok": true, "device": {...}}.
"""
import os

# Deterministic cuBLAS needs this before the first cuBLAS call.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

REFERENCE_ITERS = 325          # the JAX reference, config 5, batch 128/1024
ITER_SLACK = 25                # one check interval
EPS = 1e-6
# Kernel vs twin. Both are held against the twin evaluated in f64 on
# the same f32 inputs. M = P + sigma I + A'RA is ill-conditioned at the
# flagship (sigma = 1e-5, rho boosted 100x on equality rows), so f32
# rounding in the M^-1 products is amplified by cond(M) in any f32
# implementation: measured on the H100, the cuBLAS twin itself is
# 2.6e-3 from f64 after 25 iterations. The kernel passes when its error
# is at most twice the f32 twin's own error, or below the floor.
ERR_FACTOR, ERR_FLOOR = 2.0, 1e-5
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


def max_abs_diff(a, b):
    return max(float((p.double() - q.double()).abs().max())
               for p, q in zip(a, b))


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi)
    return smi


def phase_build():
    from admm_library_torch.ops import _build
    t0 = time.perf_counter()
    path, log = _build.build(verbose=True)
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=secs, library=path.name, ptxas=ptxas)


def _flagship_inputs(dev):
    """Phase-1 inputs of the config-5 main path at batch 128."""
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


def phase_kernel(dev):
    import torch
    from admm_library_torch.ops import fused

    out = {}
    for case, make, k in (("flagship_box_b128", _flagship_inputs, 25),
                          ("l1_soc_b3", _l1_soc_inputs, 7)):
        qps, s, rho, fac, (x, z, y) = make(dev)
        args = (qps.A, fac["Minv"], fac["M"], qps.q, rho, qps.lam,
                qps.l, qps.u, x, z, y)
        kw = dict(cone=qps.cone, sigma=s.sigma, alpha=s.alpha, k=k,
                  refine_steps=s.refine_steps)
        got = fused.fused_iterate_shared(*args, **kw)
        twin = fused.fused_iterate_shared_reference(*args, **kw)
        ref64 = fused.fused_iterate_shared_reference(
            *(a.double() for a in args), **kw)
        torch.cuda.synchronize()
        err = max_abs_diff(got, ref64)
        scale = max(float(t.abs().max()) for t in ref64)
        twin_err = max_abs_diff(twin, ref64)
        tol = max(ERR_FACTOR * twin_err, ERR_FLOOR)
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"{case}: kernel output not finite")
        ms = cuda_ms(lambda: fused.fused_iterate_shared(*args, **kw))
        plain_ms = cuda_ms(
            lambda: fused.fused_iterate_shared_reference(*args, **kw))
        emit("kernel", case=case, B=x.shape[0], n=qps.n, m=qps.m, k=k,
             max_abs_err=err, max_rel_err=err / scale,
             twin_max_abs_err=twin_err, tol=tol,
             kernel_vs_twin=max_abs_diff(got, twin), ms=ms,
             plain_ms=plain_ms)
        check(err <= tol, f"{case}: kernel error {err:.3e} against the f64 "
              f"twin exceeds {tol:.3e}")
        out[case] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return out


def _timed_solve(qp, settings):
    """One solve from zeroed launch counts: (solution, seconds, launches)."""
    import torch
    from admm_library_torch import solve_batch_shared
    from admm_library_torch.ops import fused
    torch.cuda.synchronize()
    fused.fused_iterate_shared.launches = 0
    t0 = time.perf_counter()
    sol = solve_batch_shared(qp, settings)
    torch.cuda.synchronize()
    return sol, time.perf_counter() - t0, fused.fused_iterate_shared.launches


def phase_slice(batch, dev):
    import torch
    from admm_library_torch import Settings, Status
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
    return rec


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import admm_library_torch  # noqa: F401  (turns TF32 off)
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    kern = phase_kernel(dev)
    main_run = phase_slice(128, dev)
    phase_slice(1024, dev)
    flag = kern["flagship_box_b128"]
    print(json.dumps({"kernels": [{
        "name": "fused_iterate_shared", "route": "cuda",
        "source": "admm_library_torch/csrc/fused_iterate.cu",
        "replaces": "admm_library_tpu/ops/fused.py:201",
        "launches": main_run["kernel_launches"],
        "max_abs_err": flag["max_abs_err"], "ms": flag["ms"],
        "plain_ms": flag["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
