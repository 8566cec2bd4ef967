#!/usr/bin/env python3
"""Smoke run of admm_library_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed). Phases, one JSON line each:

1. device    — the card's name and the nvidia-smi name/power-limit line;
2. build     — builds each csrc/*.cu with nvcc for sm_90a, all at once
               (ptxas register report);
3. kernel    — the fused ADMM iteration kernel against its plain PyTorch
               twin on the same inputs, at the flagship shape (batch 128,
               k=25, box rows, from a real Ruiz + 'inv' factor of the
               config-5 problem) and on a small L1 + uniform-SOC case;
               max errors against the stated tolerance, median times;
4. slice     — solve_batch_shared on the config-5 Monte-Carlo batch
               (horizon 50, dim 3: n=450, m=456) at batch 128 and 1024,
               using the JAX reference's own dispersions; every lane
               SOLVED, f64 KKT residuals <= 1e-6, lockstep iterations
               325 ± 25, the kernel launched, a rerun bitwise identical;
5. cg_kernel — the Jacobi-PCG kernel against its twin, f32 and f64, on
               the flagship M of a real Ruiz + 'pallas_cg' factor of
               config 5 at batch 128 and 1 (200 steps, tol 1e-9), and on
               a small SPD case with a zero-rhs lane;
6. solve     — solve(..., backend='pallas_cg') on config 1 (the JAX
               reference's random_box_qp draw, n=100, m=200) and config
               2 (the rendezvous MPC of its bench, seed 0, n=450,
               m=456): SOLVED, f64 KKT residuals within the 1e-6 mixed
               criterion, 100 ± 25 and 750 ± 25 iterations, the kernel
               launched, a rerun bitwise identical;
7. slice_pcg — the config-5 batch at 128 with backend='pallas_cg': every
               lane SOLVED, f64 KKT <= 1e-6, 350 ± 25 lockstep
               iterations, the kernel launched, x within 5e-4 of the
               'inv' path, a rerun bitwise identical.

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
# The JAX reference with backend='pallas_cg' on the CPU: config 1 and 2
# through solve, config 5 at batch 128 through solve_batch_shared.
PCG_REFERENCE_ITERS = {"config1": 100, "config2": 750, "config5": 350}
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
# The PCG kernel in f64 against its f64 twin: two summation orders over
# 200 CG steps (measured 1.0e-10 on the flagship M, solution scale 2.3).
F64_ERR_FLOOR = 1e-8
# Two solved points of the same problem: each meets the 1e-6 residual
# criterion; the MPC states carry only a 1e-8 regularisation.
X_AGREE = 5e-4
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
    libs = _build.build(verbose=True)
    secs = time.perf_counter() - t0
    emit("build", seconds=secs, libraries={
        stem: dict(library=path.name, ptxas=[
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln])
        for stem, (path, log) in libs.items()})


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


def _kernels():
    """The kernels' wrappers, each carrying its launch count."""
    from admm_library_torch.ops import fused, pallas_cg
    return {"fused_iterate_shared": fused.fused_iterate_shared,
            "pallas_cg_solve": pallas_cg.pallas_cg_solve}


def _timed_run(fn, *args):
    """fn(*args) from zeroed launch counts: (result, seconds, launches
    of each kernel)."""
    import torch
    kernels = _kernels()
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
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


def phase_cg_kernel(dev):
    import torch
    from admm_library_torch.ops import pallas_cg as pcg

    M, rhs = _pcg_flagship(dev)
    Ms, rhs_s = _spd_zero_lane(dev)
    cases = (("flagship_b128", M, rhs, 200, 1e-9),
             ("flagship_b1", M, rhs[:1].contiguous(), 200, 1e-9),
             ("spd_zero_lane_b4", Ms, rhs_s, 200, 1e-9))
    out = {}
    for case, M32, rhs32, iters, tol in cases:
        for dtype in (torch.float32, torch.float64):
            Mt, rt = M32.to(dtype), rhs32.to(dtype)
            kw = dict(iters=iters, tol=tol)
            got = pcg.pallas_cg_solve(Mt, rt, **kw)
            twin = pcg.pallas_cg_solve_reference(Mt, rt, **kw)
            ref64 = pcg.pallas_cg_solve_reference(Mt.double(), rt.double(),
                                                  **kw)
            torch.cuda.synchronize()
            err = max_abs_diff([got], [ref64])
            twin_err = max_abs_diff([twin], [ref64])
            tol_err = (max(ERR_FACTOR * twin_err, ERR_FLOOR)
                       if dtype == torch.float32 else F64_ERR_FLOOR)
            # A few steps: the same arithmetic within a few ulps.
            short = []
            for k in (1, 2, 3):
                a = pcg.pallas_cg_solve(Mt, rt, iters=k, tol=tol)
                b = pcg.pallas_cg_solve_reference(Mt, rt, iters=k, tol=tol)
                short.append(max_abs_diff([a], [b])
                             / max(float(b.abs().max()), 1e-30))
            short_tol = 64 * torch.finfo(dtype).eps
            ms = cuda_ms(lambda: pcg.pallas_cg_solve(Mt, rt, **kw))
            plain_ms = cuda_ms(
                lambda: pcg.pallas_cg_solve_reference(Mt, rt, **kw))
            name = f"{case}_{str(dtype).split('.')[-1]}"
            emit("cg_kernel", case=name, B=rt.shape[0], n=rt.shape[1],
                 iters=iters, tol=tol, lane_tile=pcg.auto_lane_tile(
                     rt.shape[0]), max_abs_err=err,
                 twin_max_abs_err=twin_err, err_tol=tol_err,
                 kernel_vs_twin=max_abs_diff([got], [twin]),
                 short_rel_err=short, short_tol=short_tol, ms=ms,
                 plain_ms=plain_ms)
            check(bool(torch.isfinite(got).all()),
                  f"{name}: kernel output not finite")
            check(err <= tol_err, f"{name}: kernel error {err:.3e} against "
                  f"the f64 twin exceeds {tol_err:.3e}")
            check(max(short) <= short_tol,
                  f"{name}: kernel and twin differ after 1-3 steps")
            if case.startswith("spd_zero_lane"):
                check(torch.equal(got[2], torch.zeros_like(got[2])),
                      f"{name}: the zero-rhs lane moved")
            out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return out


def _mixed_kkt(qp, sol):
    """Independent f64 KKT residuals (utils/oracle) and their 1e-6
    mixed-criterion thresholds: (r_prim, r_dual, eps_prim, eps_dual)."""
    from admm_library_torch.utils.oracle import kkt_residuals
    x, z, y = sol.x, sol.z, sol.y
    r_p, r_d, _ = kkt_residuals(qp, x, z, y)
    linf = lambda v: float(v.abs().max())  # noqa: E731
    eps_p = EPS + EPS * max(linf(x @ qp.A.mT), linf(z))
    eps_d = EPS + EPS * max(linf(x @ qp.P.mT), linf(y @ qp.A), linf(qp.q))
    return float(r_p), float(r_d), eps_p, eps_d


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
        sol, wall, launches = _timed_run(solve, qp, s)
        sol2, wall2, _ = _timed_run(solve, qp, s)
        inv = solve(qp, s.replace(backend="inv"))
        r_p, r_d, eps_p, eps_d = _mixed_kkt(qp, sol)
        iters = int(sol.iters)
        ref_iters = PCG_REFERENCE_ITERS[name]
        bitwise = all(torch.equal(getattr(sol, f), getattr(sol2, f))
                      for f in ("x", "z", "y", "status", "iters", "r_prim",
                                "r_dual"))
        rec = dict(config=name, n=qp.n, m=qp.m, status=sol.status_name(),
                   iters=iters, reference_iters=ref_iters,
                   kkt_r_prim=r_p, kkt_r_dual=r_d, eps_prim=eps_p,
                   eps_dual=eps_d, wall_s=wall, wall_rerun_s=wall2,
                   launches=launches, rerun_bitwise_identical=bitwise,
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
        check(bitwise, f"{name}: rerun not bitwise identical")
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
    sol, wall, launches = _timed_run(solve_batch_shared, qp, s)
    sol2, wall2, _ = _timed_run(solve_batch_shared, qp, s)
    inv = solve_batch_shared(qp, s.replace(backend="inv"))
    r_p, r_d, _ = kkt_residuals(qp, sol.x, sol.z, sol.y)
    lockstep = int(sol.iters.max())
    ref_iters = PCG_REFERENCE_ITERS["config5"]
    solved = int((sol.status == int(Status.SOLVED)).sum())
    bitwise = all(torch.equal(getattr(sol, f), getattr(sol2, f))
                  for f in ("x", "z", "y", "status", "iters", "r_prim",
                            "r_dual"))
    rec = dict(batch=batch, n=qp.n, m=qp.m, solved=solved,
               lockstep_iters=lockstep, reference_iters=ref_iters,
               iters_lane_mean=float(sol.iters.float().mean()),
               kkt_r_prim_max=float(r_p.max()),
               kkt_r_dual_max=float(r_d.max()), wall_s=wall,
               wall_rerun_s=wall2, launches=launches,
               rerun_bitwise_identical=bitwise,
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
    check(bitwise, "pcg batch: rerun not bitwise identical")
    check(rec["inv_x_max_abs_diff"] <= X_AGREE,
          "pcg batch: 'pallas_cg' and 'inv' solutions disagree")
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
    cg = phase_cg_kernel(dev)
    phase_solve(dev)
    pcg_run = phase_slice_pcg(dev)
    flag = kern["flagship_box_b128"]
    cg_flag = cg["flagship_b128_float32"]
    print(json.dumps({"kernels": [{
        "name": "fused_iterate_shared", "route": "cuda",
        "source": "admm_library_torch/csrc/fused_iterate.cu",
        "replaces": "admm_library_tpu/ops/fused.py:201",
        "launches": main_run["kernel_launches"],
        "max_abs_err": flag["max_abs_err"], "ms": flag["ms"],
        "plain_ms": flag["plain_ms"]}, {
        "name": "pallas_cg_solve", "route": "cuda",
        "source": "admm_library_torch/csrc/pallas_cg.cu",
        "replaces": "admm_library_tpu/ops/pallas_cg.py:82",
        "launches": pcg_run["launches"]["pallas_cg_solve"],
        "max_abs_err": cg_flag["max_abs_err"], "ms": cg_flag["ms"],
        "plain_ms": cg_flag["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
