"""The CUDA kernels on the card (the fused ADMM iteration and the
Jacobi-PCG solve): each against its plain twin, its input checks and its
launch counter, and small solves through it.

Needs a CUDA device, nvcc and no JAX; skipped elsewhere. On the GPU
machine run it without the JAX suite's conftest:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""
import contextlib
import dataclasses
import time

import numpy as np
import pytest
import torch

from admm_library_torch import ConeSpec, QPData, Settings, Status
from admm_library_torch import solve_batch_shared
from admm_library_torch.core import admm, graph
from admm_library_torch.core.scaling import ruiz_equilibrate
from admm_library_torch.models import monte_carlo as mc
from admm_library_torch.ops import fused, kkt
from admm_library_torch.utils import trace

pytestmark = pytest.mark.gpu

# Small shapes: one intra-op thread keeps the CPU free for the other
# test workers.
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _operands(qp, x, z, y):
    s = Settings(precision="single")
    qps, _ = ruiz_equilibrate(qp, s.scaling_iters)
    rho = admm.rho_vec_of(torch.tensor(s.rho, device=qp.device),
                          admm.is_equality_row_shared(qps), s)
    fac = kkt.factor_condensed(qps.P, qps.A, s.sigma, rho, "inv")
    args = [qps.A, fac["Minv"], fac["M"], qps.q, rho, qps.lam, qps.l,
            qps.u, x, z, y]
    return args, dict(cone=qps.cone, sigma=s.sigma, alpha=s.alpha,
                      refine_steps=s.refine_steps)


def _box(dev):
    qp, _, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(0),
                                  batch=37, N=9, dim=3, device=dev)
    B = qp.l.shape[0]
    x, z, y = (torch.zeros((B, w), device=dev) for w in (qp.n, qp.m, qp.m))
    return _operands(qp, x, z, y)


def _l1_soc(dev):
    rng = np.random.default_rng(3)
    n, mb, ml, nsoc, d = 20, 8, 6, 3, 4
    m = mb + ml + nsoc * d
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    l = np.full(m, -np.inf)
    u = np.full(m, np.inf)
    l[:mb], u[:mb] = -1.0, 1.0
    l[mb:mb + ml], u[mb:mb + ml] = -0.7, 0.7
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    qp = QPData(P=t(R @ R.T + 0.5 * np.eye(n)), q=t(rng.standard_normal(n)),
                A=t(rng.standard_normal((m, n)) / np.sqrt(n)), l=t(l), u=t(u),
                lam=torch.full((ml,), 0.3, device=dev),
                cone=ConeSpec(m_box=mb, m_l1=ml, soc_dims=(d,) * nsoc))
    x = t(rng.standard_normal((3, n)))
    z = torch.zeros((3, m), device=dev)
    return _operands(qp, x, z, torch.zeros_like(z))


@pytest.mark.parametrize("case", [_box, _l1_soc], ids=["box", "l1_soc"])
@pytest.mark.parametrize("k,refine", [(1, 1), (10, 1), (10, 0), (7, 2)])
def test_kernel_matches_twin(case, k, refine, dev):
    """Kernel and f32 twin are both held against the twin in f64 on the
    same inputs; M is ill-conditioned, so f32 rounding is amplified in
    any implementation: the kernel must stay within twice the twin's
    own error (floor 1e-5)."""
    args, kw = case(dev)
    kw.update(k=k, refine_steps=refine)
    before = fused.fused_iterate_shared.launches
    got = fused.fused_iterate_shared(*args, **kw)
    twin = fused.fused_iterate_shared_reference(*args, **kw)
    ref = fused.fused_iterate_shared_reference(*(a.double() for a in args),
                                               **kw)
    torch.cuda.synchronize()
    assert fused.fused_iterate_shared.launches == before + 1
    err = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref))
    twin_err = max(float((w.double() - r).abs().max())
                   for w, r in zip(twin, ref))
    assert err <= max(2.0 * twin_err, 1e-5)


def test_kernel_leaves_inputs_and_reruns_bitwise(dev):
    args, kw = _box(dev)
    kw["k"] = 5
    x0 = [a.clone() for a in args[-3:]]
    a = fused.fused_iterate_shared(*args, **kw)
    b = fused.fused_iterate_shared(*args, **kw)
    for t, t0 in zip(args[-3:], x0):
        assert torch.equal(t, t0)
    for p, q in zip(a, b):
        assert torch.equal(p, q)


def test_wrapper_rejects_bad_inputs(dev):
    args, kw = _box(dev)
    kw["k"] = 1
    bad_dtype = list(args)
    bad_dtype[0] = args[0].double()
    with pytest.raises(TypeError):
        fused.fused_iterate_shared(*bad_dtype, **kw)
    bad_layout = list(args)
    bad_layout[1] = args[1].t()
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_iterate_shared(*bad_layout, **kw)
    bad_shape = list(args)
    bad_shape[3] = args[3][:-1]
    with pytest.raises(ValueError, match="shape"):
        fused.fused_iterate_shared(*bad_shape, **kw)
    mixed = list(args)
    mixed[0] = args[0].cpu()
    with pytest.raises(ValueError, match="cpu"):
        fused.fused_iterate_shared(*mixed, **kw)


def _flagship(dev, B):
    """Config 5's operands (n=450, m=456: rows of 1,800 bytes, not a
    multiple of 16) for the first B of the reference's dispersions, with
    a nonzero iterate."""
    s0 = mc.reference_s0(1024 if B > 128 else 128)[:B]
    qp, _, _ = mc.monte_carlo_mpc_from_s0(s0, device=dev)
    rng = np.random.default_rng(B)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    x = t(0.1 * rng.standard_normal((B, qp.n)))
    z = t(0.1 * rng.standard_normal((B, qp.m)))
    return _operands(qp, x, z, torch.zeros_like(z))


def _odd_soc(dev, B):
    """Odd n and m, and SOC(3) blocks after 7 box/L1 rows: the kernel
    cuts rows in chunks of multiples of 4, so blocks straddle chunk
    boundaries of the products."""
    rng = np.random.default_rng(100 + B)
    n, mb, ml, nsoc, d = 37, 5, 2, 10, 3
    m = mb + ml + nsoc * d
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    l = np.full((B, m), -np.inf)
    u = np.full((B, m), np.inf)
    l[:, :mb] = -0.5 - rng.random((B, mb))
    u[:, :mb] = 0.5 + rng.random((B, mb))
    l[:, mb:mb + ml], u[:, mb:mb + ml] = -0.7, 0.7
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    qp = QPData(P=t(R @ R.T + 0.5 * np.eye(n)), q=t(rng.standard_normal(n)),
                A=t(rng.standard_normal((m, n)) / np.sqrt(n)), l=t(l), u=t(u),
                lam=torch.full((ml,), 0.3, device=dev),
                cone=ConeSpec(m_box=mb, m_l1=ml, soc_dims=(d,) * nsoc))
    x = t(rng.standard_normal((B, n)))
    z = t(rng.standard_normal((B, m)))
    return _operands(qp, x, z, t(0.1 * rng.standard_normal((B, m))))


@pytest.mark.parametrize("case", [_flagship, _odd_soc],
                         ids=["flagship_n450", "odd_soc"])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 37, 257, 1024])
def test_kernel_regimes(case, B, dev):
    """Both sides of the small-batch threshold (GEMV-shaped split-K up to
    8 lanes, register tiles of lanes above) and of F64_BATCH (the
    cluster design above it), n not a multiple of 4, SOC blocks across
    chunk and column-slice boundaries; k=1 with refine_steps 0 and 2,
    and k=10: each leaf within twice the f32 twin's error against the
    f64 twin (floor 1e-5), a rerun bitwise identical, and the design the
    plan names launched."""
    args, kw = case(dev, B)
    design = "cluster" if B > fused.F64_BATCH else "split"
    for k, refine in ((1, 0), (1, 2), (10, 1)):
        kw.update(k=k, refine_steps=refine)
        before = dict(fused.fused_iterate_shared.calls_by_design)
        got = fused.fused_iterate_shared(*args, **kw)
        again = fused.fused_iterate_shared(*args, **kw)
        after = fused.fused_iterate_shared.calls_by_design
        assert {d: after[d] - before[d] for d in after} == {
            d: 2 if d == design else 0 for d in after}
        twin = fused.fused_iterate_shared_reference(*args, **kw)
        ref = fused.fused_iterate_shared_reference(
            *(a.double() for a in args), **kw)
        torch.cuda.synchronize()
        for g, a, w, r in zip(got, again, twin, ref):
            assert torch.equal(g, a)
            err = float((g.double() - r).abs().max())
            twin_err = float((w.double() - r).abs().max())
            assert err <= max(2.0 * twin_err, 1e-5), (k, refine)


def test_kernel_never_runs_the_twin_and_raises_on_a_refused_launch(
        dev, monkeypatch):
    """On CUDA tensors the wrapper launches the kernel, never the plain
    twin; in both designs a grid larger than the card holds at once (a
    cooperative launch; clusters beyond cudaOccupancyMaxActiveClusters)
    is refused and raises, and is not counted."""
    def boom(*a, **k):
        raise AssertionError("the plain twin ran on CUDA tensors")

    monkeypatch.setattr(fused, "fused_iterate_shared_reference", boom)
    sms, smem = fused.device_limits(0)
    for B in (3, 257):
        args, kw = _flagship(dev, B)
        kw["k"] = 2
        before = fused.fused_iterate_shared.launches
        by_design = dict(fused.fused_iterate_shared.calls_by_design)
        fused.fused_iterate_shared(*args, **kw)
        torch.cuda.synchronize()
        assert fused.fused_iterate_shared.launches == before + 1
        p = fused.device_plan(B, 450, 456, kw["refine_steps"], 0)
        with monkeypatch.context() as patch:
            if p.design == "split":
                patch.setattr(fused, "device_limits",
                              lambda i: (4 * sms, smem))
            else:
                # The planner never asks for more clusters than the card
                # holds; a plan that does is refused by the entry point.
                wave = fused.max_clusters(0, p.cluster)
                big = dataclasses.replace(p, grid=(wave + 1) * p.cluster)
                patch.setattr(fused, "device_plan", lambda *a: big)
            with pytest.raises(RuntimeError, match="launch failed"):
                fused.fused_iterate_shared(*args, **kw)
        assert fused.fused_iterate_shared.launches == before + 1
        design = "cluster" if B > fused.F64_BATCH else "split"
        after = fused.fused_iterate_shared.calls_by_design
        assert after[design] == by_design[design] + 1


def test_small_solve_goes_through_the_kernel(dev):
    qp, spec, s0s = mc.monte_carlo_mpc(torch.Generator().manual_seed(1),
                                       batch=16, N=10, dim=2, device=dev)
    fused.fused_iterate_shared.launches = 0
    sol = solve_batch_shared(qp, Settings())
    assert fused.fused_iterate_shared.launches > 0
    assert bool((sol.status == int(Status.SOLVED)).all())
    plain = solve_batch_shared(qp, Settings(fused="off"))
    assert bool((plain.status == int(Status.SOLVED)).all())
    assert abs(int(sol.iters.max()) - int(plain.iters.max())) <= 25


def test_large_batch_solve_goes_through_the_cluster_design(dev):
    """Config 5's 1024 reference dispersions: phase 1 runs the cluster
    design; the plain body reaches the same statuses within 25
    iterations."""
    qp, _, _ = mc.monte_carlo_mpc_from_s0(mc.reference_s0(1024),
                                          device=dev)
    qp = qp.astype(torch.float64)
    from admm_library_torch.core import graph
    graph.CACHE.clear()     # a fresh warm-up and capture: calls counted
    fused.fused_iterate_shared.launches = 0
    cluster = fused.fused_iterate_shared.calls_by_design["cluster"]
    sol = solve_batch_shared(qp, Settings())
    assert fused.fused_iterate_shared.launches > 0
    assert fused.fused_iterate_shared.calls_by_design["cluster"] > cluster
    plain = solve_batch_shared(qp, Settings(fused="off"))
    assert bool((sol.status == int(Status.SOLVED)).all())
    assert torch.equal(sol.status, plain.status)
    assert abs(int(sol.iters.max()) - int(plain.iters.max())) <= 25


def test_mixed_cone_solve_through_the_kernel(dev):
    """Box + L1 + SOC rows: phase 1 runs the kernel's L1 and SOC
    epilogues inside a real solve; the plain body agrees."""
    rng = np.random.default_rng(7)
    n, mb, ml, d, nb, B = 10, 6, 3, 3, 2, 3
    m = mb + ml + d * nb
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    l = np.full((B, m), -np.inf)
    u = np.full((B, m), np.inf)
    l[:, :mb] = -0.3 - 0.2 * rng.random((B, mb))
    u[:, :mb] = 0.3 + 0.2 * rng.random((B, mb))
    l[:, mb:mb + ml], u[:, mb:mb + ml] = -0.5, 0.5
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    qp = QPData(P=t(R @ R.T + 0.5 * np.eye(n)), q=t(rng.standard_normal(n)),
                A=t(rng.standard_normal((m, n)) / np.sqrt(n)), l=t(l), u=t(u),
                lam=torch.full((ml,), 0.2, device=dev),
                cone=ConeSpec(m_box=mb, m_l1=ml, soc_dims=(d,) * nb))
    fused.fused_iterate_shared.launches = 0
    sol = solve_batch_shared(qp, Settings())
    assert fused.fused_iterate_shared.launches > 0
    plain = solve_batch_shared(qp, Settings(fused="off"))
    assert bool((sol.status == int(Status.SOLVED)).all())
    assert torch.equal(sol.status, plain.status)
    torch.testing.assert_close(sol.x, plain.x, atol=1e-5, rtol=0.0)


# ---- the Jacobi-PCG kernel (ops/pallas_cg.py, csrc/pallas_cg.cu) ----

def _pcg_case(dev, dtype, B=5):
    """M from a Ruiz-scaled 'pallas_cg' factor of a small Monte-Carlo
    MPC (n=81), rhs the x-update of a real iteration: z at the
    projection of zero onto the bounds."""
    from admm_library_torch.parallel.batch import _s32_of_shared
    qp, _, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(2),
                                  batch=B, N=9, dim=3, device=dev)
    s = _s32_of_shared(Settings())
    qps, _ = ruiz_equilibrate(qp, s.scaling_iters)
    rho = admm.rho_vec_of(torch.tensor(s.rho, device=dev),
                          admm.is_equality_row_shared(qps), s)
    M = kkt.factor_condensed(qps.P, qps.A, s.sigma, rho, "pallas_cg")["M"]
    z = torch.clamp(torch.zeros_like(qps.l), qps.l, qps.u)
    rhs = (rho * z) @ qps.A - qps.q
    return M.to(dtype), rhs.to(dtype)


def _pcg_ragged(dev, dtype, B=3, n=67):
    """A random SPD system (cond ~ 80) whose n no cluster size divides:
    the last block's slice is ragged (C=8: 9 columns, the last 4)."""
    rng = np.random.default_rng(n)
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    return t(R @ R.T + 0.05 * np.eye(n)), t(rng.standard_normal((B, n)))


def _pcg_fits(design, C, n, itemsize):
    """The lane tiles whose blocks fit one block's shared memory."""
    from admm_library_torch.ops import pallas_cg as pcg
    if design == "stream":
        return [t for t in pcg.LANE_TILES
                if pcg.stream_smem_bytes(t, n, itemsize) <= pcg.SMEM_LIMIT]
    return [t for t in pcg.RESIDENT_TILES
            if pcg.resident_smem_bytes(C, t, n, itemsize) <= pcg.SMEM_LIMIT]


def _pcg_plans(B, n, itemsize):
    """Every design and cluster size the plan admits at this shape: the
    stream design at its own tile, and the resident one at each C whose
    blocks fit, with a tile of up to 4 lanes (a partial last tile where
    B is not a multiple)."""
    from admm_library_torch.ops import pallas_cg as pcg
    plans = [("stream", 1, pcg.auto_lane_tile(B))]
    for C in pcg.CLUSTERS:
        fits = _pcg_fits("resident", C, n, itemsize)
        if fits:
            plans.append(("resident", C, min(fits[-1], 4)))
    return plans


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["mc81_b1", "mc81_b5", "mc81_b40",
                                  "ragged67_b3"])
def test_pcg_kernel_matches_twin(dtype, case, dev):
    """200 steps at tol 1e-9, under the card's own plan and under every
    design and cluster size forced: the kernel and the twin in the
    working type are both held against the twin in f64. f64: within
    1e-8 of it (two f64 summation orders). f32: within twice the f32
    twin's own error (floor 1e-5), since M is ill-conditioned. 1-3
    steps: within a few ulps of the twin."""
    from admm_library_torch.ops import pallas_cg as pcg
    kind, b = case.split("_b")
    make = _pcg_case if kind == "mc81" else _pcg_ragged
    M, rhs = make(dev, dtype, int(b))
    B, n = rhs.shape
    ref = pcg.pallas_cg_solve_reference(M.double(), rhs.double(),
                                        iters=200, tol=1e-9)
    twin = pcg.pallas_cg_solve_reference(M, rhs, iters=200, tol=1e-9)
    twin_err = float((twin.double() - ref).abs().max())
    ulp = torch.finfo(dtype).eps
    for plan in [None] + _pcg_plans(B, n, M.element_size()):
        got = pcg.pallas_cg_solve_planned(M, rhs, iters=200, tol=1e-9,
                                          plan=plan)
        torch.cuda.synchronize()
        err = float((got.double() - ref).abs().max())
        if dtype == torch.float64:
            assert err <= 1e-8, plan
        else:
            assert err <= max(2.0 * twin_err, 1e-5), plan
        for iters in (1, 2, 3):
            a = pcg.pallas_cg_solve_planned(M, rhs, iters=iters, tol=1e-9,
                                            plan=plan)
            b = pcg.pallas_cg_solve_reference(M, rhs, iters=iters, tol=1e-9)
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 64 * ulp * scale, \
                (plan, iters)


def test_pcg_kernel_freezes_lanes_and_reruns_bitwise(dev):
    """For each design and cluster size: reruns are bitwise identical,
    the zero-rhs lane stays exactly 0, and every lane is bitwise the
    same at every lane tile (the sums' order does not depend on LT), as
    is a 1-D rhs of lane 0."""
    from admm_library_torch.ops import pallas_cg as pcg
    M, rhs = _pcg_case(dev, torch.float64, B=6)
    rhs[3] = 0.0
    x0 = torch.zeros_like(rhs)
    a = pcg.pallas_cg_solve(M, rhs, x0=x0, iters=50, tol=1e-9)
    assert torch.equal(a, pcg.pallas_cg_solve(M, rhs, x0=x0, iters=50,
                                              tol=1e-9))
    assert torch.equal(a[3], torch.zeros_like(a[3]))
    n = rhs.shape[1]
    firsts = {}
    for design, C, _ in _pcg_plans(6, n, 8):
        first = None
        for tile in _pcg_fits(design, C, n, 8):
            plan = (design, C, tile)
            got = pcg.pallas_cg_solve_planned(M, rhs, x0=x0, iters=50,
                                              tol=1e-9, plan=plan)
            again = pcg.pallas_cg_solve_planned(M, rhs, x0=x0, iters=50,
                                                tol=1e-9, plan=plan)
            assert torch.equal(got, again), plan
            assert torch.equal(got[3], torch.zeros_like(got[3])), plan
            if first is None:
                first = got
            assert torch.equal(got, first), plan
        v = pcg.pallas_cg_solve_planned(M, rhs[0], iters=50, tol=1e-9,
                                        plan=(design, C, 1))
        assert v.shape == rhs[0].shape
        assert torch.equal(v, first[0]), (design, C)
        firsts[design, C] = first
    # Up to n=128 the resident product keeps k whole: a cluster of one
    # block computes bitwise what the stream design computes.
    assert torch.equal(firsts["resident", 1], firsts["stream", 1])


def test_pcg_refused_plan_raises_and_does_not_fall_back(dev, monkeypatch):
    """A forced plan whose blocks need more shared memory than the card
    has (a cluster of 8 at n=700 in f32: 246,400 B of M per block; the
    stream design with 8 lanes at n=2000) is refused: the wrapper
    raises, counts no launch and never runs the twin or another design;
    the next launch is unaffected."""
    from admm_library_torch.ops import pallas_cg as pcg

    def boom(*a, **k):
        raise AssertionError("the plain twin ran on CUDA tensors")

    monkeypatch.setattr(pcg, "_cg_math", boom)
    for plan, n in ((("resident", 8, 1), 700), (("stream", 1, 8), 2000)):
        M = torch.eye(n, device=dev)
        rhs = torch.ones((2, n), device=dev)
        before = pcg.pallas_cg_solve.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            pcg.pallas_cg_solve_planned(M, rhs, iters=5, plan=plan)
        assert pcg.pallas_cg_solve.launches == before
    M, rhs = _pcg_case(dev, torch.float32, B=3)
    x = pcg.pallas_cg_solve_planned(M, rhs, iters=5,
                                    plan=("resident", 8, 1))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())


def test_pcg_plan_matches_the_kernel_and_the_card(dev):
    """The plan's shared-memory reckoning is the kernel's, byte for
    byte; the card places at least one cluster of every resident plan
    it makes, and the flagship (n=450) is resident in f32 and f64."""
    from admm_library_torch.ops import pallas_cg as pcg
    _, smem_bytes, _, _ = pcg._entry()
    for n in (24, 60, 67, 81, 450, 451, 2000):
        for isz in (4, 8):
            for t in pcg.RESIDENT_TILES:
                assert smem_bytes(0, t, n, isz) == \
                    pcg.stream_smem_bytes(t, n, isz)
                for C in pcg.CLUSTERS:
                    assert smem_bytes(C, t, n, isz) == \
                        pcg.resident_smem_bytes(C, t, n, isz)
    for B, n in ((1, 60), (1, 450), (128, 450), (1024, 100)):
        for isz in (4, 8):
            design, C, LT = pcg.device_plan(B, n, isz, 0)
            assert design == "resident", (B, n, isz)
            assert pcg._max_clusters(0, C, LT, n, isz) >= 1


def test_pcg_wrapper_rejects_bad_inputs(dev):
    from admm_library_torch.ops import pallas_cg as pcg
    M, rhs = _pcg_case(dev, torch.float32, B=3)
    with pytest.raises(TypeError):
        pcg.pallas_cg_solve(M.half(), rhs.half())
    with pytest.raises(TypeError):
        pcg.pallas_cg_solve(M.double(), rhs)
    with pytest.raises(ValueError, match="contiguous"):
        pcg.pallas_cg_solve(M, rhs.repeat(1, 2)[:, ::2])
    with pytest.raises(ValueError, match="cpu"):
        pcg.pallas_cg_solve(M.cpu(), rhs)
    with pytest.raises(ValueError, match="unbatched"):
        pcg.pallas_cg_solve(M.expand(3, *M.shape), rhs)


def test_pcg_launch_counter_and_no_path_to_the_twin(dev, monkeypatch):
    """Each CUDA call is one launch; the kernel path never runs the twin,
    and a kernel that cannot be loaded raises instead of falling back."""
    from admm_library_torch.ops import pallas_cg as pcg
    M, rhs = _pcg_case(dev, torch.float32, B=3)

    def boom(*a, **k):
        raise AssertionError("the plain twin ran on CUDA tensors")

    monkeypatch.setattr(pcg, "_cg_math", boom)
    before = pcg.pallas_cg_solve.launches
    pcg.pallas_cg_solve(M, rhs, iters=10)
    pcg.pallas_cg_solve(M, rhs[0], iters=10)
    assert pcg.pallas_cg_solve.launches == before + 2

    def no_library():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(pcg, "_entry", no_library)
    with pytest.raises(RuntimeError, match="no kernel library"):
        pcg.pallas_cg_solve(M, rhs, iters=10)
    assert pcg.pallas_cg_solve.launches == before + 2


def test_small_solve_goes_through_the_pcg_kernel(dev):
    from admm_library_torch import solve
    from admm_library_torch.models.random_qp import random_box_qp
    from admm_library_torch.ops import pallas_cg as pcg
    qp = random_box_qp(torch.Generator().manual_seed(13), n=30, m=60,
                       device=dev)
    pcg.pallas_cg_solve.launches = 0
    sol = solve(qp, Settings(backend="pallas_cg"))
    assert pcg.pallas_cg_solve.launches > 0
    assert int(sol.status) == int(Status.SOLVED)
    ref = solve(qp, Settings(backend="inv"))
    assert int(ref.status) == int(Status.SOLVED)
    torch.testing.assert_close(sol.x, ref.x, atol=1e-4, rtol=0.0)
    for precision in ("single", "double"):
        pcg.pallas_cg_solve.launches = 0
        s = solve(qp, Settings(backend="pallas_cg", precision=precision,
                               eps_abs=1e-4, eps_rel=1e-4))
        assert pcg.pallas_cg_solve.launches > 0
        assert int(s.status) == int(Status.SOLVED)


# ---- polish and the f64 continuation on the card ----

def _loose(qp, **kw):
    """An unconverged f64 point on the CPU: one double-precision phase at
    a coarse tolerance, no polish."""
    from admm_library_torch import solve
    base = dict(eps_abs=1e-2, eps_rel=0.0, max_iter=2000,
                precision="double", polish=False, recenter_rounds=0,
                restart_every=0, stall_checks=0, backend="chol")
    return solve(qp, Settings(**{**base, **kw}))


def _soc_polish_case():
    """Box rows and two SOC(3) blocks, one active and one interior."""
    rng = np.random.default_rng(7)
    n, mb = 6, 4
    G = rng.normal(size=(n, n))
    q = rng.normal(size=n) * 5.0
    A = np.vstack([rng.normal(size=(mb, n)), rng.normal(size=(3, n)),
                   10.0 * np.abs(rng.normal(size=n)),
                   0.1 * rng.normal(size=(2, n))])
    l = np.concatenate([np.full(mb, -1.0), np.full(6, -np.inf)])
    u = np.concatenate([np.full(mb, 1.0), np.full(6, np.inf)])
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    qp = QPData(P=t(G @ G.T + n * np.eye(n)), q=t(q), A=t(A), l=t(l),
                u=t(u), lam=t(np.zeros(0)),
                cone=ConeSpec(m_box=mb, soc_dims=(3, 3)))
    return qp, _loose(qp)


def _cw_polish_case():
    from admm_library_torch.models.clohessy_wiltshire import (
        build_cw_rendezvous)
    s0 = np.array([100.0, -800.0, 30.0, 0.1, 0.4, -0.02])
    qp, _ = build_cw_rendezvous(s0, N=10, dt=600.0, dv_max=2.0,
                                dtype=torch.float64, device="cpu")
    return qp, _loose(qp, eps_abs=1e-4, max_iter=20000)


def _to(sol, dev):
    import dataclasses
    return dataclasses.replace(sol, **{
        f.name: getattr(sol, f.name).to(dev)
        for f in dataclasses.fields(sol)})


@pytest.mark.parametrize("case", [_soc_polish_case, _cw_polish_case],
                         ids=["soc", "cw"])
def test_polish_on_cuda_matches_cpu(case, dev):
    """polish runs on the problem's device in f64: the CUDA result lands
    SOLVED and each leaf equals the CPU one to 1e-7 of that leaf's
    scale ‖·‖∞. The bar is cond(M)·eps64 of the SOC case's polish
    systems (cond 4.1e8 at delta = 1e-7, measured on the CPU), the
    spread two Cholesky implementations may show. Measured on an NVIDIA
    H100 80GB HBM3, 700.00 W: SOC case x 3.9e-9 of 0.18, z 5.9e-9 of
    0.23, y 1.0e-8 of 0.76 (2.6e-8 relative at most); CW case
    (cond 4.1e3) x and z 7.2e-15 of 0.67, y 9.1e-10 of 31."""
    from admm_library_torch.core.polish import polish
    qp, sol0 = case()
    cpu = polish(qp, sol0, 1e-6, 0.0)
    gpu = polish(qp.to(dev), _to(sol0, dev), 1e-6, 0.0)
    assert gpu.x.device.type == "cuda" and gpu.x.dtype == torch.float64
    assert int(gpu.status) == int(cpu.status) == int(Status.SOLVED)
    for f in ("x", "z", "y"):
        ref = getattr(cpu, f)
        torch.testing.assert_close(getattr(gpu, f).cpu(), ref, rtol=0.0,
                                   atol=1e-7 * float(ref.abs().max()))


def test_polish_rejects_a_non_pd_system_on_cuda(dev):
    """cholesky_ex does not raise on CUDA either: the factor of a matrix
    that is not positive definite is NaN, and polish returns the input."""
    from admm_library_torch.core.polish import polish
    from admm_library_torch.ops.kkt import cholesky_or_nan
    M = -torch.eye(3, dtype=torch.float64, device=dev)
    assert bool(torch.isnan(cholesky_or_nan(M)).all())
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    qp = QPData(P=t(-np.eye(3)), q=t(np.ones(3)), A=t(np.eye(3)),
                l=t(np.full(3, -10.0)), u=t(np.full(3, 10.0)),
                lam=t(np.zeros(0)), cone=ConeSpec(m_box=3))
    zero = t(np.zeros(3))
    from admm_library_torch import Solution
    sol0 = Solution(x=zero, z=zero, y=zero,
                    status=torch.tensor(int(Status.MAX_ITER),
                                        dtype=torch.int32, device=dev),
                    iters=torch.tensor(7, dtype=torch.int32, device=dev),
                    r_prim=t(1.0), r_dual=t(1.0), obj=t(0.0), rho=t(0.1),
                    history=t(np.zeros((0, 3))))
    for force in (False, True):
        p = polish(qp, sol0, 1e-6, 0.0, force_accept=force)
        assert torch.equal(p.x, zero)
        assert int(p.status) == int(Status.MAX_ITER)


def test_f64_continuation_runs_one_chunk_on_cuda(dev, monkeypatch):
    """The continuation runs on the problem's device in native f64: one
    2000-iteration chunk (max_iter 2000) and a polish attempt, from an
    unsolved start, with every leaf back in the problem's dtype."""
    from admm_library_torch import Solution, api
    from admm_library_torch.models.low_thrust import build_low_thrust_socp
    qp, spec = build_low_thrust_socp(
        np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1]), N=25,
        device=dev)
    s = Settings(eps_abs=1e-6, eps_rel=5e-8, max_iter=2000,
                 rho_soc_scale=100.0, stall_checks=16, backend="inv")
    chunks, polished = [], []
    phase, pol = api._solve_one_phase, api.polish
    monkeypatch.setattr(api, "_solve_one_phase",
                        lambda *a, **k: chunks.append(a[0].device)
                        or phase(*a, **k))
    monkeypatch.setattr(api, "polish",
                        lambda *a, **k: polished.append(1) or pol(*a, **k))
    zx = torch.zeros(qp.n, device=dev)
    zz = torch.zeros(qp.m, device=dev)
    sol0 = Solution(x=zx, z=zz, y=zz,
                    status=torch.tensor(int(Status.MAX_ITER),
                                        dtype=torch.int32, device=dev),
                    iters=torch.tensor(5, dtype=torch.int32, device=dev),
                    r_prim=torch.tensor(1.0, device=dev),
                    r_dual=torch.tensor(1.0, device=dev),
                    obj=torch.tensor(0.0, device=dev),
                    rho=torch.tensor(0.1, device=dev),
                    history=torch.zeros((0, 3), device=dev))
    out = api._f64_continuation(qp, sol0, s, "inv")
    assert [d.type for d in chunks] == ["cuda"] and polished == [1]
    assert 5 < int(out.iters) <= 2005
    assert out.x.device.type == "cuda" and out.x.dtype == torch.float32
    assert out.history.dtype == torch.float32
    assert bool(torch.isfinite(out.x).all())


def _mpc_condensed(B=None, N=10, dim=2):
    """The condensed matrix of a Monte-Carlo MPC problem (f64) on the
    CPU, optionally one per lane with its own rho, and its block size."""
    from admm_library_torch.ops.kkt import condensed_matrix
    qp, spec, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(3),
                                     batch=2, N=N, dim=dim,
                                     dtype=torch.float64, device="cpu")
    if B is None:
        rho = torch.full((qp.m,), 0.3, dtype=torch.float64)
        return qp.P, qp.A, rho, spec.block
    rho = 0.1 + torch.rand(B, qp.m, dtype=torch.float64,
                           generator=torch.Generator().manual_seed(4))
    return qp.P.expand(B, -1, -1), qp.A.expand(B, -1, -1), rho, spec.block


@pytest.mark.parametrize("lanes", [None, 3], ids=["shared", "per_lane"])
@pytest.mark.parametrize("backend", ["banded", "spike", "chol", "inv"])
def test_kkt_backends_on_cuda_match_cpu(backend, lanes, dev):
    """Every leaf of the factor lies on the card, and the CUDA solve
    (refinement included) equals the CPU one to 1e-9 of the solution's
    scale: the same recursions in two f64 libraries on a system with
    cond(M) ~ 1e6."""
    P, A, rho, b = _mpc_condensed(lanes)
    kw = dict(band_block=b, spike_parts=5)
    cpu = kkt.factor_condensed(P, A, 1e-6, rho, backend, **kw)
    gpu = kkt.factor_condensed(P.to(dev), A.to(dev), 1e-6, rho.to(dev),
                               backend, **kw)
    assert set(gpu) == set(cpu)
    assert all(t.device.type == "cuda" for t in gpu.values())
    g = torch.Generator().manual_seed(5)
    rhs = torch.randn((lanes or 4, P.shape[-1]), dtype=torch.float64,
                      generator=g)
    x = kkt.solve_condensed(cpu, rhs, backend, refine_steps=1)
    xg = kkt.solve_condensed(gpu, rhs.to(dev), backend, refine_steps=1)
    assert xg.device.type == "cuda"
    torch.testing.assert_close(xg.cpu(), x, rtol=0.0,
                               atol=1e-9 * float(x.abs().max()))


@pytest.mark.parametrize("backend", ["banded", "spike"])
def test_solve_on_banded_backends_on_cuda(backend, dev):
    """Config 2's MPC at horizon 10 through solve on 'banded' and
    'spike' on the card: SOLVED at the CPU's status, iterations within
    one check interval (25), x within 1e-5 (f32 phases on two
    libraries)."""
    from admm_library_torch import solve
    from admm_library_torch.models.double_integrator import build_mpc_qp
    rng = np.random.default_rng(0)
    s0 = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(-0.2, 0.2, 3)])
    qp, spec = build_mpc_qp(s0, np.zeros(6), N=10, dim=3, device="cpu")
    s = Settings(backend=backend, band_block=spec.block, spike_parts=5)
    cpu = solve(qp.astype(torch.float64), s)
    gpu = solve(qp.to(dev).astype(torch.float64), s)
    assert gpu.x.device.type == "cuda"
    assert int(gpu.status) == int(cpu.status) == int(Status.SOLVED)
    assert abs(int(gpu.iters) - int(cpu.iters)) <= 25
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=0.0, atol=1e-5)


def _random_lanes():
    from admm_library_torch.models.random_qp import random_box_qp
    g = torch.Generator().manual_seed(0)
    return [random_box_qp(g, n=16, m=24, dtype=torch.float64, device="cpu")
            for _ in range(6)], 0


def _mpc_lanes():
    from admm_library_torch.models.double_integrator import build_mpc_qp
    rng = np.random.default_rng(1)
    lanes = []
    for _ in range(3):
        s0 = np.concatenate([rng.uniform(-2, 2, 3),
                             rng.uniform(-0.2, 0.2, 3)])
        qp, spec = build_mpc_qp(s0, np.zeros(6), N=10, dim=3,
                                dtype=torch.float64, device="cpu")
        lanes.append(qp)
    return lanes, spec.block


@pytest.mark.parametrize("backend,make", [
    ("auto", _random_lanes), ("banded", _mpc_lanes), ("spike", _mpc_lanes)],
    ids=["auto", "banded", "spike"])
def test_solve_batch_on_cuda_matches_cpu(backend, make, dev):
    """solve_batch on independent problems (6 random box QPs, n=16, m=24,
    each with its own P and A; or 3 horizon-10 MPC problems) on the card
    against the CPU: the same statuses, iterations within 25, x within
    1e-5 ('auto' is 'inv' on the card and 'chol' on the CPU)."""
    from admm_library_torch import solve_batch
    lanes, block = make()
    qp = QPData(**{f: torch.stack([getattr(q, f) for q in lanes])
                   for f in ("P", "q", "A", "l", "u", "lam")},
                cone=lanes[0].cone)
    s = Settings(backend=backend, band_block=block, spike_parts=5)
    cpu = solve_batch(qp, s)
    gpu = solve_batch(qp.to(dev), s)
    assert gpu.x.device.type == "cuda"
    assert gpu.iters.shape == (len(lanes),)
    assert torch.equal(gpu.status.cpu(), cpu.status)
    assert bool((cpu.status == int(Status.SOLVED)).all())
    assert int((gpu.iters.cpu() - cpu.iters).abs().max()) <= 25
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=0.0, atol=1e-5)
    with pytest.raises(ValueError, match="solve_batch_shared"):
        solve_batch(qp.to(dev), s.replace(backend="pallas_cg"))


def test_consensus_solve_mc_on_cuda_matches_cpu(dev):
    """consensus_solve_mc (4 scenarios, 4 horizon blocks) on a 1x1 mesh
    on the card ('auto' = 'inv') against the CPU ('chol'): the same
    statuses, iterations within 25, x within 1e-5, and the solution on
    the card."""
    from admm_library_torch.models.partitioned import partition_mpc_mc
    from admm_library_torch.parallel import consensus_solve_mc, runtime
    qp, spec, _, _ = partition_mpc_mc(
        torch.Generator().manual_seed(0), 4, [1.0, -2.0, 0.3, -0.1],
        np.zeros(4), N=8, n_blocks=4, dim=2, u_max=2.0, dtype=torch.float64,
        device="cpu")
    s = Settings(eps_abs=1e-7, eps_rel=1e-7)
    cpu = consensus_solve_mc(qp, spec, runtime.make_mesh(device="cpu"), s)
    mesh = runtime.make_mesh()
    assert mesh.device == dev
    gpu = consensus_solve_mc(qp.to(dev), spec, mesh, s)
    assert gpu.x.device.type == "cuda"
    assert torch.equal(gpu.status.cpu(), cpu.status)
    assert bool((cpu.status == int(Status.SOLVED)).all())
    assert int((gpu.iters.cpu() - cpu.iters).abs().max()) <= 25
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=0.0, atol=1e-5)


def test_runtime_collectives_on_a_world1_nccl_group(dev, tmp_path):
    """The runtime's collectives through NCCL on the card: a world-1
    process group (file:// store) whose group stands in for both axes.
    A 1x1 mesh from make_mesh has no group and makes no call."""
    import torch.distributed as dist
    from admm_library_torch.parallel import runtime
    runtime.initialize()                 # one process: a no-op
    assert not dist.is_initialized()
    runtime.initialize(init_method=f"file://{tmp_path / 'store'}",
                       world_size=1, rank=0, backend="nccl")
    try:
        assert dist.get_backend() == "nccl"
        world = dist.group.WORLD
        mesh = runtime.Mesh(shape={"data": 1, "horizon": 1},
                            coords={"data": 0, "horizon": 0},
                            groups={"data": world, "horizon": world},
                            ranks={"data": (0,), "horizon": (0,)}, world=1,
                            device=dev)
        v = torch.arange(6, dtype=torch.float64, device=dev).reshape(2, 3)
        for axis in ("data", "horizon"):
            assert torch.equal(runtime.pmax(v, mesh, axis), v)
            assert torch.equal(runtime.psum(v, mesh, axis), v)
            assert torch.equal(runtime.all_gather(v, mesh, axis, dim=1), v)
            assert torch.equal(runtime.ring_shift(v, mesh, axis, 1), v)
        torch.cuda.synchronize()
        assert runtime.describe(mesh)["backend"] == "nccl"
    finally:
        runtime.shutdown()
    assert not dist.is_initialized()


def test_rowsharded_on_cuda_matches_cpu(dev):
    """solve_rowsharded (f64, a box and an L1 case) and the hybrid path
    (f32 data) on a 1-rank data mesh on the card against the CPU: the
    same status and iterations, x within 1e-8 (f64) and 1e-5 (hybrid)."""
    from admm_library_torch.models.random_qp import random_box_qp
    from admm_library_torch.parallel import make_data_mesh
    from admm_library_torch.parallel.rowshard import (
        solve_rowsharded, solve_rowsharded_hybrid)
    qp = random_box_qp(torch.Generator().manual_seed(21), n=32, m=64,
                       dtype=torch.float64, device="cpu")
    mesh = make_data_mesh()
    assert mesh.device == dev
    cpu_mesh = make_data_mesh(device="cpu")
    s = Settings(eps_abs=1e-8, eps_rel=1e-8, precision="single")
    cpu = solve_rowsharded(qp, cpu_mesh, s)
    gpu = solve_rowsharded(qp, mesh, s)
    assert gpu.x.device.type == "cuda"
    assert int(cpu.status) == int(Status.SOLVED)
    assert int(gpu.status) == int(cpu.status)
    assert int(gpu.iters) == int(cpu.iters)
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=0.0, atol=1e-8)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6)
    qp32 = qp.astype(torch.float32).astype(torch.float64)
    cpu = solve_rowsharded_hybrid(qp32, cpu_mesh, s)
    gpu = solve_rowsharded_hybrid(qp32, mesh, s)
    assert int(cpu.status) == int(gpu.status) == int(Status.SOLVED)
    assert abs(int(gpu.iters) - int(cpu.iters)) <= 25
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=0.0, atol=1e-5)


def test_horizon_sharded_on_cuda_matches_cpu(dev):
    """solve_horizon_sharded (4 scenarios, 4 parts, f64 plain settings)
    on a 1x1 mesh on the card against the CPU: the same statuses and
    iterations, x within 1e-10."""
    from admm_library_torch.parallel import runtime
    from admm_library_torch.parallel.horizon import (
        mpc_row_time, partition_qp, solve_horizon_sharded)
    qp, spec, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(0),
                                     batch=4, N=8, dim=2,
                                     dtype=torch.float64, device="cpu")
    hp, hspec = partition_qp(qp, spec.block, 4,
                             mpc_row_time(8, spec.ns, spec.nu))
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, precision="double",
                 scaling_iters=0, restart_every=0, stall_checks=0,
                 polish=False, eps_pinf=0.0, eps_dinf=0.0)
    cpu = solve_horizon_sharded(hp, hspec, runtime.make_mesh(device="cpu"),
                                s)
    gpu = solve_horizon_sharded(hp, hspec, runtime.make_mesh(), s)
    assert gpu.x.device.type == "cuda"
    assert bool((cpu.status == int(Status.SOLVED)).all())
    assert torch.equal(gpu.status.cpu(), cpu.status)
    assert torch.equal(gpu.iters.cpu(), cpu.iters)
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=0.0, atol=1e-10)


def test_data_axis_on_cuda_is_the_solve_without_a_mesh(dev):
    """At one rank the data axis changes nothing: solve_batch_shared on
    shard_batch(make_data_mesh()) is bitwise the solve without a mesh,
    through the fused kernel (f32 'single')."""
    from admm_library_torch import make_data_mesh, shard_batch
    qp, _, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(3),
                                  batch=16, N=8, dim=2, device=dev)
    s = Settings(eps_abs=1e-5, eps_rel=1e-5, precision="single")
    mesh = make_data_mesh()
    qs, *_ = shard_batch(qp, mesh)
    fused.fused_iterate_shared.launches = 0
    sol = solve_batch_shared(qs, s, mesh=mesh)
    assert fused.fused_iterate_shared.launches > 0
    alone = solve_batch_shared(qp, s)
    for f in ("x", "z", "y", "status", "iters"):
        assert torch.equal(getattr(sol, f), getattr(alone, f)), f


def test_checkpoint_loads_onto_the_card(dev, tmp_path):
    from admm_library_torch.utils import checkpoint
    x = torch.arange(6, dtype=torch.float64, device=dev)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, {"x": x, "z": x[:2], "y": x[:2]})
    st = checkpoint.load_state(path)
    assert st["x"].device == dev and torch.equal(st["x"], x)
    x0, _, _ = checkpoint.resume_warm_start(path, device="cpu")
    assert x0.device.type == "cpu"


# ---- captured checks (core/graph.py) ----

# The loops that start from raw data with a prologue before their checks.
_PHASE_LOOPS = ("run_admm", "run_admm_lanes", "run_admm_batch_shared")


def _recorded_loops(monkeypatch, fn, *args, **kw):
    """fn(*args, **kw) with every CheckLoop's (kind, step, state at its
    first check) recorded: the loop's own step (with the pre it runs
    inside its checks) and a clone of its initial state, for the phase
    loops, which start from raw data, after their prologue. Every loop
    runs plain, so that a program's loops are met once and nothing of
    the recording enters a graph. Returns (fn's result, the records)."""
    from admm_library_torch.core import graph
    loops = []
    real = graph.CheckLoop

    def spy(kind, step, state, *a, **k):
        loop = real(kind, step, state, *a, **k)
        first = graph._map(torch.clone, state)
        if kind in _PHASE_LOOPS:
            first = dict(first, **loop.step(first, admm.PROLOGUE))
        loops.append((kind, loop.step, first))
        return loop
    with monkeypatch.context() as m:
        m.setattr(graph, "CheckLoop", spy)
        m.setattr(graph, "capturable", lambda *a, **k: False)
        out = fn(*args, **kw)
    return out, loops


_CHECK_VARIANTS = [(False, False), (False, True), (True, False),
                   (True, True)]


def _replay_is_eager(step, state, variants=_CHECK_VARIANTS):
    """Every variant of `step` from `state`, three times each from the
    same state: the entry's first run eager (the warm-up), then each
    variant captured the first time it is met and replayed after. Each
    run agrees bitwise with the eager step on the default stream on
    every entry the step updates. Returns the cache entry."""
    from admm_library_torch.core import graph
    cache = graph.CheckCache()
    cache.prepare_nodes(next(t for _, t in graph._leaves(state)).device)
    entry = cache.entry("case", step, state)
    for variant in variants:
        want = step(graph._map(torch.clone, state), variant)
        runs = []
        for _ in range(3):
            entry.load(state)
            entry.run(variant)
            runs.append({k: entry.buffers[k].clone() for k in want})
        for key, value in want.items():
            for got in runs:
                assert torch.equal(got[key], value), (variant, key)
    v = len(variants)
    assert cache.stats["captures"] == v
    assert cache.stats["replays"] == 3 * v - 1
    assert cache.stats["eager_checks"] == 1
    return entry


def test_replayed_check_is_the_eager_check_config4_f64_chunk(
        dev, monkeypatch):
    """The state of a config-4 f64 chunk (the reference's continuation
    entry, the bench settings): replay == eager, bitwise."""
    from admm_library_torch import api
    from admm_library_torch.models import low_thrust as lt
    qp, _ = lt.build_low_thrust_socp(
        np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1]), N=200,
        device=dev)
    qp64 = qp.astype(torch.float64)
    entry = lt.reference_continuation_entry(dev)
    s = Settings(eps_abs=1e-6, eps_rel=5e-8, max_iter=0, warm_start=True,
                 precision="single", polish=False, recenter_rounds=0,
                 rho_soc_scale=100.0, stall_checks=0, backend="inv")
    _, loops = _recorded_loops(monkeypatch, api._solve_one_phase, qp64,
                               entry.x, entry.z, entry.y, s, "inv",
                               rho0=float(entry.rho.max()))
    (kind, step, state), = loops
    assert kind == "run_admm" and state["x"].dtype == torch.float64
    _replay_is_eager(step, state)


def test_replayed_check_is_the_eager_check_b128_round(dev, monkeypatch):
    """The state of config 5's first re-centred round at batch 128 (the
    reference's dispersions, f32, per-lane q): replay == eager."""
    qp32, _, _ = mc.monte_carlo_mpc_from_s0(mc.reference_s0(128),
                                            device=dev)
    _, loops = _recorded_loops(monkeypatch, solve_batch_shared,
                               qp32.astype(torch.float64),
                               Settings(eps_abs=1e-6, eps_rel=1e-6))
    rounds = [(step, st) for kind, step, st in loops
              if kind == "run_admm_batch_shared"
              and st["qp"]["q"].dim() == 2]
    step, state = rounds[0]
    assert state["x"].dtype == torch.float32 and state["x"].shape[0] == 128
    _replay_is_eager(step, state)


def _eager_and_captured(monkeypatch, fn, *args):
    """fn(*args) with every check eager; then twice with utils/trace on,
    which alone counts the phases' WHILE passes on the card; then with
    the capture rule as it is and tracing off, from an empty cache,
    twice (a program's first run is its warm-up and capture, the second
    its replay; the second bitwise the first, and each traced run
    bitwise the first): (eager result, captured result, the cache's
    counters over the two untraced runs and the traced runs' WHILE
    passes). The cache is left as the untraced runs leave it."""
    from admm_library_torch.core import graph
    with monkeypatch.context() as m:
        m.setattr(graph, "capturable", lambda *a, **k: False)
        eager = fn(*args)
    graph.CACHE.clear()
    trace.enable()
    try:
        graph.zero_counts()
        traced = [fn(*args) for _ in range(2)]
        passes = graph.CACHE.while_passes()
    finally:
        trace.disable()
        trace.reset()
    graph.CACHE.clear()
    graph.zero_counts()
    before = dict(graph.CACHE.stats)
    captured = fn(*args)
    again = fn(*args)
    for f in ("x", "z", "y", "status"):
        for other in [again] + traced:
            assert torch.equal(getattr(captured, f), getattr(other, f)), f
    stats = {k: graph.CACHE.stats[k] - before[k] for k in before}
    stats["while_passes"] = passes
    return eager, captured, stats


def _assert_checks_in_phases(stats):
    """The captured runs' checks ran inside phase graphs: a phase, or a
    program holding phases (graph.program), in the cache, captured and
    launched, its WHILE nodes passed."""
    from admm_library_torch.core import graph
    phases = [v for e in graph.CACHE.entries.values() for v in e.graphs
              if isinstance(v, graph.Phase) or v == graph.PROGRAM]
    assert phases and stats["while_passes"] > 0
    assert stats["captures"] >= len(phases) and stats["replays"] >= 1


def _small_l1_soc(dev, dtype=torch.float64):
    rng = np.random.default_rng(11)
    n, mb, ml, d, nb = 10, 6, 3, 3, 2
    m = mb + ml + d * nb
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    l = np.full(m, -np.inf)
    u = np.full(m, np.inf)
    l[:mb], u[:mb] = -0.4, 0.4
    l[mb:mb + ml], u[mb:mb + ml] = -0.5, 0.5
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    return QPData(P=t(R @ R.T + 0.5 * np.eye(n)),
                  q=t(rng.standard_normal(n)),
                  A=t(rng.standard_normal((m, n)) / np.sqrt(n)), l=t(l),
                  u=t(u), lam=t(np.full(ml, 0.2)),
                  cone=ConeSpec(m_box=mb, m_l1=ml, soc_dims=(d,) * nb))


@pytest.mark.parametrize("backend", ["inv", "chol"])
@pytest.mark.parametrize("loop", ["run_admm", "run_admm_lanes",
                                  "run_admm_batch_shared"])
def test_captured_loop_is_the_eager_loop_through_refactors(
        loop, backend, dev, monkeypatch):
    """A whole loop replayed from graphs equals the same loop run
    eagerly on the card, bitwise, through rho refactors (rho starts 100x
    off, so the factor changes between replays) and restarts."""
    _captured_loop_is_eager(loop, backend, dev, monkeypatch)


@pytest.mark.parametrize("loop,backend,cg_max_iter", [
    ("run_admm", "cg", 13), ("run_admm_lanes", "cg", 13),
    ("run_admm_batch_shared", "cg", 200), ("run_admm", "pallas_cg", 13),
    ("run_admm_batch_shared", "pallas_cg", 13)])
def test_captured_cg_loop_is_the_eager_loop(loop, backend, cg_max_iter, dev,
                                            monkeypatch):
    """The same on the CG backends: on 'cg' the checks inside the phase's
    WHILE node, their CGs conditional nodes nested in it (a WHILE node of
    8-step blocks, and an IF node of 5 steps at cg_max_iter 13), on
    'pallas_cg' kernel 2 a node of each check body, counted on the card
    at each pass as often as the eager loop launches it."""
    from admm_library_torch.core import graph
    from admm_library_torch.ops import pallas_cg as pcg
    counts = _captured_loop_is_eager(loop, backend, dev, monkeypatch,
                                     cg_max_iter=cg_max_iter)
    if backend == "pallas_cg":
        # Every launch of the captured run came from the phase's bodies,
        # counted on the card (counts: eager, two traced runs, then the
        # untraced first run and rerun).
        assert counts[0] > 0 and counts[0] == counts[3]
        assert pcg.pallas_cg_solve.host == 0
    else:
        bodies = [e.body_nodes[v] for e in graph.CACHE.entries.values()
                  for v in e.graphs if isinstance(v, graph.Phase)]
        assert bodies and min(bodies) > 0


def test_config1_on_cg_captured_is_the_capture_off_solve(dev, monkeypatch):
    """Config 1 (the JAX draw, n=100, m=200) through solve on 'cg': the
    captured solve, each check one replay with its CGs conditional
    nodes, is bitwise the solve with every segment eager; a rerun
    captures nothing."""
    from admm_library_torch import solve
    from admm_library_torch.core import graph
    from admm_library_torch.models.random_qp import reference_random_box_qp
    qp = reference_random_box_qp(dev).astype(torch.float64)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, backend="cg")
    eager, captured, stats = _eager_and_captured(monkeypatch, solve, qp, s)
    for f in ("x", "z", "y", "status", "iters", "r_prim", "r_dual", "rho"):
        assert torch.equal(getattr(eager, f), getattr(captured, f)), f
    assert int(captured.status) == int(Status.SOLVED)
    assert stats["captures"] > 0 and stats["replays"] > 0
    before = dict(graph.CACHE.stats)
    again = solve(qp, s)
    assert graph.CACHE.stats["captures"] == before["captures"]
    assert torch.equal(again.x, captured.x)


def test_a_fresh_process_captures_a_cg_solve(dev):
    """A process whose first cuBLAS call is in a captured 'cg' loop: the
    prologue runs no product, so the first CG head is captured before
    any eager product on the capture stream; it must not have to make
    the stream's cuBLAS handle inside the capture."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import torch, admm_library_torch as T\n"
        "from admm_library_torch.core import graph\n"
        "from admm_library_torch.models.random_qp import random_box_qp\n"
        "qp = random_box_qp(torch.Generator().manual_seed(2), n=20, m=40,"
        " device='cuda').astype(torch.float64)\n"
        "sol = T.solve(qp, T.Settings(backend='cg'))\n"
        "assert int(sol.status) == 1, sol.status_name()\n"
        "assert graph.CACHE.stats['captures'] > 0\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _captured_loop_is_eager(loop, backend, dev, monkeypatch, **kw):
    """The loop `loop` on `backend` from a small problem, eager then
    captured: bitwise, refactored, replayed. Returns kernel 2's launches
    in the eager and in the captured run."""
    from admm_library_torch.ops import pallas_cg as pcg
    from admm_library_torch.parallel import batch
    s = Settings(check_every=5, adaptive_rho_interval=10, restart_every=15,
                 history=3, max_iter=300, rho=10.0, eps_abs=1e-8,
                 eps_rel=1e-8, backend=backend, **kw)
    if loop == "run_admm":
        qps, sc = ruiz_equilibrate(_small_l1_soc(dev), 10)
        zeros = [torch.zeros(w, dtype=qps.dtype, device=dev)
                 for w in (qps.n, qps.m, qps.m)]
        run = admm.run_admm
    elif loop == "run_admm_lanes":
        one = _small_l1_soc(dev)
        qp = QPData(**{f: torch.stack([getattr(one, f)] * 3)
                       for f in ("P", "q", "A", "l", "u", "lam")},
                    cone=one.cone)
        qp = QPData(P=qp.P, q=qp.q * torch.tensor(
            [[1.0], [0.5], [2.0]], dtype=qp.dtype, device=dev),
            A=qp.A, l=qp.l, u=qp.u, lam=qp.lam, cone=qp.cone)
        qps, sc = ruiz_equilibrate(qp, 10)
        zeros = [torch.zeros((3, w), dtype=qps.dtype, device=dev)
                 for w in (qps.n, qps.m, qps.m)]
        run = admm.run_admm_lanes
    else:
        qp, _, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(5),
                                      batch=8, N=8, dim=2,
                                      dtype=torch.float64, device=dev)
        qps, sc = batch._ruiz(qp, s, None)
        zeros = [torch.zeros((8, w), dtype=qps.dtype, device=dev)
                 for w in (qps.n, qps.m, qps.m)]
        run = batch.run_admm_batch_shared
    counts = []

    def counted(*args):
        pcg.pallas_cg_solve.launches = 0
        out = run(*args)
        counts.append(pcg.pallas_cg_solve.launches)
        return out
    eager, captured, stats = _eager_and_captured(
        monkeypatch, counted, qps, sc, s, *zeros, backend)
    for f in eager._fields:
        a, b = getattr(eager, f), getattr(captured, f)
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a), f
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f
        else:
            assert a == b, f
    assert not torch.all(captured.rho_bar == s.rho)      # refactored
    _assert_checks_in_phases(stats)
    return counts


def test_captured_solves_are_the_eager_solves(dev, monkeypatch):
    """solve (staged L1 path; SOC through the B=1 batch, its rounds, the
    f64 fallback and continuation) and solve_batch_shared with the fused
    kernel before the captured tail: bitwise the eager runs."""
    from admm_library_torch import solve
    qp, _, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(1),
                                  batch=16, N=10, dim=2, device=dev)
    cases = [(solve, _small_l1_soc(dev), Settings(backend="inv")),
             (solve_batch_shared, qp, Settings())]
    from admm_library_torch.core import graph
    for fn, problem, s in cases:
        fused.fused_iterate_shared.launches = 0
        eager, captured, stats = _eager_and_captured(monkeypatch, fn,
                                                     problem, s)
        # A program's first run is its warm-up, then its capture.
        assert stats["captures"] > 0
        replays = graph.CACHE.stats["replays"]
        again = fn(problem, s)
        for f in ("x", "z", "y", "status", "iters", "r_prim", "r_dual"):
            assert torch.equal(getattr(eager, f), getattr(captured, f)), f
            assert torch.equal(getattr(eager, f), getattr(again, f)), f
        assert graph.CACHE.stats["replays"] > replays
    assert fused.fused_iterate_shared.launches > 0


def _mixed_batch(dev):
    """_small_l1_soc shared by 3 lanes whose box bounds differ: the
    rounds' dual base and shifted prox run."""
    one = _small_l1_soc(dev)
    shift = torch.zeros((3, one.m), dtype=one.dtype, device=dev)
    shift[:, :one.cone.m_box] = torch.tensor(
        [[0.0], [0.05], [-0.1]], dtype=one.dtype, device=dev)
    return QPData(P=one.P, q=one.q, A=one.A, l=one.l + shift,
                  u=one.u + shift, lam=one.lam, cone=one.cone)


@pytest.mark.parametrize("case", ["b128_hybrid", "mixed_hybrid"])
def test_captured_batch_solve_is_the_eager_solve(case, dev, monkeypatch):
    """solve_batch_shared as captured segments (prologue, checks with
    kernel 1 inside, refactors, epilogue, the rounds' set-up and
    safeguard, the f64 residuals) against the same solve with every
    segment eager, bitwise; a rerun replays and captures and warms
    nothing."""
    from admm_library_torch.core import graph
    if case == "b128_hybrid":
        qp = mc.monte_carlo_mpc_from_s0(mc.reference_s0(128), device=dev)[
            0].astype(torch.float64)
        s = Settings(eps_abs=1e-6, eps_rel=1e-6)
    else:
        qp, s = _mixed_batch(dev), Settings(backend="inv", rho=10.0)
    fused.fused_iterate_shared.launches = 0
    eager, captured, stats = _eager_and_captured(monkeypatch,
                                                 solve_batch_shared, qp, s)
    fields = ("x", "z", "y", "status", "iters", "r_prim", "r_dual", "obj",
              "rho", "history")
    for f in fields:
        assert torch.equal(getattr(eager, f), getattr(captured, f)), f
    assert stats["eager_checks"] == len(graph.CACHE.entries)
    before = dict(graph.CACHE.stats)
    again = solve_batch_shared(qp, s)
    for f in fields:
        assert torch.equal(getattr(again, f), getattr(captured, f)), f
    assert graph.CACHE.stats["captures"] == before["captures"]
    assert graph.CACHE.stats["eager_checks"] == before["eager_checks"]
    if case == "b128_hybrid":
        assert fused.fused_iterate_shared.launches > 0


@pytest.mark.parametrize("B", [128, 1024])
def test_check_graph_with_kernel_1_is_the_eager_pre_and_check(
        dev, monkeypatch, B):
    """Config 5's phase-1 loop at batch 128 (the split design) and 1024
    (the cluster design, n not a multiple of 4: the entry point's row
    copies and its TMA boxes inside the graph) (f32, 'inv'): each check
    variant with the fused kernel's launch inside its graph replays
    bitwise the eager kernel launch and check, and every captured check
    holds the kernel, of the design the plan names."""
    from admm_library_torch.core import graph
    qp = mc.monte_carlo_mpc_from_s0(mc.reference_s0(B), device=dev)[0]
    _, loops = _recorded_loops(monkeypatch, solve_batch_shared,
                               qp.astype(torch.float64),
                               Settings(eps_abs=1e-6, eps_rel=1e-6,
                                        max_iter=0))
    step, state = next((step, st) for kind, step, st in loops
                       if kind == "run_admm_batch_shared")
    assert isinstance(step, graph._PreStep)
    assert state["x"].dtype == torch.float32
    before = dict(fused.fused_iterate_shared.calls_by_design)
    entry = _replay_is_eager(step, state)
    for variant in _CHECK_VARIANTS:
        assert entry.kernels[variant] == [fused.fused_iterate_shared]
    design = "cluster" if B > fused.F64_BATCH else "split"
    calls = {d: c - before[d]
             for d, c in fused.fused_iterate_shared.calls_by_design.items()}
    assert calls[design] > 0 and sum(calls.values()) == calls[design]


def test_first_meeting_capture_is_the_eager_segment(dev, monkeypatch):
    """A new entry runs its first segment (the prologue) eagerly and
    captures it for later; every other segment is captured the first
    time it is met: a check with kernel 1 and a refactor, then the
    prologue replayed on the entry's next loop, each bitwise the eager
    segment from the same state."""
    from admm_library_torch.core import graph
    from admm_library_torch.parallel import batch
    qp, _, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(3),
                                  batch=16, N=10, dim=2, device=dev)
    raw = []
    real = graph.CheckLoop

    def spy(kind, step, state, *a, **k):
        loop = real(kind, step, state, *a, **k)
        raw.append((kind, loop.step, graph._map(torch.clone, state)))
        return loop
    with monkeypatch.context() as m:
        m.setattr(graph, "CheckLoop", spy)
        m.setattr(graph, "capturable", lambda *a, **k: False)
        solve_batch_shared(qp.astype(torch.float64),
                           Settings(rho=10.0, max_iter=0))
    step, state = next((st, s0) for kind, st, s0 in raw
                       if kind == "run_admm_batch_shared")
    cache = graph.CheckCache()
    entry = cache.entry("case", step, state)
    plain = graph._map(torch.clone, state)
    for i, variant in enumerate([batch.PROLOGUE, (False, True),
                                 batch.REFACTOR, batch.PROLOGUE]):
        if i == 3:                      # a new loop of the same key
            entry.load(state)
            plain = graph._map(torch.clone, state)
        plain.update(step(plain, variant))
        entry.run(variant)
        for path, t in graph._leaves(plain):
            got = entry.buffers
            for k in path:
                got = got[k]
            assert torch.equal(got, t), (variant, path)
        assert cache.stats["eager_checks"] == 1
        assert cache.stats["captures"] == min(i + 1, 3)
    assert cache.stats["replays"] == 3
    torch.cuda.synchronize()


def test_launch_counter_counts_replays(dev, monkeypatch):
    """Kernel 1's count is the number of times it ran: inside a phase's
    body one per pass, counted on the card, not one per capture. The
    captured b128 solve and its rerun count what the eager solve counts,
    and the rerun's all come from the card's counter."""
    from admm_library_torch.core import graph
    qp = mc.monte_carlo_mpc_from_s0(mc.reference_s0(128), device=dev)[
        0].astype(torch.float64)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6)
    counts = []
    with monkeypatch.context() as m:
        m.setattr(graph, "capturable", lambda *a, **k: False)
        fused.fused_iterate_shared.launches = 0
        solve_batch_shared(qp, s)
        counts.append(fused.fused_iterate_shared.launches)
    graph.CACHE.clear()
    for _ in range(2):
        fused.fused_iterate_shared.launches = 0
        before = dict(graph.CACHE.stats)
        solve_batch_shared(qp, s)
        counts.append(fused.fused_iterate_shared.launches)
    assert counts[0] > 0 and counts == [counts[0]] * 3
    assert graph.CACHE.stats["captures"] == before["captures"]
    # The rerun's launches all came from the phases' bodies, counted on
    # the card.
    assert fused.fused_iterate_shared.host == 0


def test_an_added_entry_outlives_the_replays_of_earlier_graphs(dev):
    """An entry that a captured segment adds gets a buffer outside the
    entry's graph pool: replaying a graph captured before it, whose
    scratch the pool freed as the new entry was made, leaves it as it
    was. The segment that adds it is captured twice, and kept once."""
    from admm_library_torch.core import graph
    n = 1 << 20

    def step(state, variant):
        x = state["x"]
        if variant == ("scratch",):
            t = torch.full_like(x, 7.0)
            return dict(x=x + (t - 7.0))
        if variant == ("add",):
            return dict(k=x * 2.0)
        return dict(x=x + 1.0)
    cache = graph.CheckCache()
    state = {"x": torch.arange(n, dtype=torch.float32, device=dev)}
    loop = graph.CheckLoop("probe", step, state, Settings(), "inv",
                           cache=cache)
    for variant in [("start",), ("scratch",), ("add",), ("scratch",),
                    ("scratch",)]:
        loop(variant)
    want = (torch.arange(n, dtype=torch.float32, device=dev) + 1.0) * 2.0
    assert torch.equal(loop.state["k"], want)
    assert torch.equal(loop.state["x"], want / 2.0)
    assert cache.stats["captures"] == 3
    assert cache.stats["eager_checks"] == 1
    assert cache.stats["replays"] == 4
    torch.cuda.synchronize()


def test_capture_refuses_an_eager_only_backend(dev):
    """capture=True for a loop outside the rule (a backend it does not
    list, a mesh axis of two ranks) raises; nothing falls back to an
    eager check in silence."""
    from admm_library_torch.core import graph
    from admm_library_torch.parallel.runtime import Mesh
    state = {"x": torch.zeros(3, device=dev),
             "flags": torch.ones(2, dtype=torch.bool, device=dev)}
    wide = Mesh(shape={"data": 2, "horizon": 1},
                coords={"data": 0, "horizon": 0},
                groups={"data": None, "horizon": None},
                ranks={"data": (0, 1), "horizon": (0,)}, world=1,
                device=dev)
    for backend, mesh in (("lu", None), ("cg", wide)):
        with pytest.raises(ValueError, match="not captured"):
            graph.CheckLoop("run_consensus", None, state, Settings(),
                            backend, mesh=mesh, capture=True,
                            cache=graph.CheckCache())


def test_a_failed_capture_raises(dev):
    """A step that reads the device inside capture raises at its capture
    (right after the entry's eager first check), not later and not
    silently."""
    from admm_library_torch.core import graph

    def reading(state, variant):
        x = state["x"] + 1.0
        return dict(x=x, flags=torch.stack([x.sum() > float(x.sum()),
                                            x.sum() < 0]))
    cache = graph.CheckCache()
    state = {"x": torch.zeros(3, device=dev),
             "flags": torch.ones(2, dtype=torch.bool, device=dev)}
    loop = graph.CheckLoop("probe", reading, state, Settings(), "inv",
                           cache=cache)
    with pytest.raises(RuntimeError):
        loop((False, False))                # warm-up, then its capture
    assert cache.stats["eager_checks"] == 1
    assert cache.stats["captures"] == 0
    torch.cuda.synchronize()


# ---- captured checks of the partitioned drivers and the block backends ----

_PART_SETTINGS = dict(check_every=5, adaptive_rho_interval=10,
                      restart_every=15, history=3, eps_abs=1e-6,
                      eps_rel=1e-6, max_iter=4000)


def _partitioned_path(name, dev):
    """(solve function, its arguments) of a small path on the card: the
    two consensus drivers on a 1-rank mesh, the horizon driver, and the
    block backends under solve_batch_shared. Each crosses restarts, rho
    refactors (rho far off) and, for the batches, lanes that freeze
    early."""
    from admm_library_torch.models.partitioned import (
        partition_mpc, partition_mpc_from_s0)
    from admm_library_torch.parallel import (consensus, consensus_mc,
                                             horizon, runtime)
    s0 = np.array([1.0, -2.0, 0.3, -0.1])
    mesh = runtime.make_mesh(device=dev)
    if name.endswith("_cg"):
        fn, args = _partitioned_path(name[:-3], dev)
        return fn, args[:-1] + (args[-1].replace(backend="cg",
                                                 cg_max_iter=13),)
    if name == "consensus":
        qp, spec, _ = partition_mpc(s0, np.zeros(4), N=16, n_blocks=4,
                                    dim=2, u_max=2.0, dtype=torch.float64,
                                    device=dev)
        return consensus.consensus_solve, (qp, spec, mesh, Settings(
            precision="single", rho=0.1, **_PART_SETTINGS))
    if name == "consensus_mc":
        s0s = np.stack([s0, 0.5 * s0, 1.5 * s0])
        qp, spec, _, _ = partition_mpc_from_s0(
            s0s, s0, np.zeros(4), N=16, n_blocks=4, dim=2, u_max=2.0,
            dtype=torch.float32, device=dev)
        return consensus_mc.consensus_solve_mc, (qp, spec, mesh, Settings(
            rho=0.1, **_PART_SETTINGS))
    qp, mspec, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(0),
                                      batch=4, N=8, dim=2,
                                      dtype=torch.float64, device=dev)
    if name == "horizon":
        hp, hs = horizon.partition_qp(qp, mspec.block, 4,
                                      horizon.mpc_row_time(8, mspec.ns,
                                                           mspec.nu))
        return horizon.solve_horizon_sharded, (hp, hs, mesh, Settings(
            precision="double", rho=10.0, **_PART_SETTINGS))
    return solve_batch_shared, (qp, Settings(
        backend=name, band_block=mspec.block, spike_parts=2, rho=0.1,
        **_PART_SETTINGS))


# "<driver>_cg": the consensus drivers on 'cg', their CGs conditional
# nodes of the check graphs.
_PARTITIONED = ["consensus", "consensus_mc", "horizon", "banded", "spike",
                "consensus_cg", "consensus_mc_cg"]


@pytest.mark.parametrize("name", _PARTITIONED)
def test_replayed_partitioned_check_is_the_eager_check(name, dev,
                                                       monkeypatch):
    """The first state of each loop of a partitioned driver or a block
    backend: every variant's replay == the eager check, bitwise."""
    fn, args = _partitioned_path(name, dev)
    _, loops = _recorded_loops(monkeypatch, fn, *args)
    kinds = {kind for kind, _, _ in loops}
    want = {"consensus": "run_consensus", "consensus_mc": "run_consensus_mc",
            "horizon": "run_horizon"}.get(name.removesuffix("_cg"),
                                          "run_admm_batch_shared")
    assert want in kinds
    checked = [rec for rec in loops if rec[0] != "solve_shared_recentered"]
    for kind, step, state in checked[:3]:
        _replay_is_eager(step, state)


@pytest.mark.parametrize("name", _PARTITIONED)
def test_captured_partitioned_solve_is_the_eager_solve(name, dev,
                                                       monkeypatch):
    """A whole solve replayed from graphs equals the same solve with
    every check eager, bitwise, through the refactors between replays
    (the factor is written into the static buffers) and restarts."""
    fn, args = _partitioned_path(name, dev)
    eager, captured, stats = _eager_and_captured(monkeypatch, fn, *args)
    for f in ("x", "z", "y", "status", "iters", "r_prim", "r_dual", "rho"):
        assert torch.equal(getattr(eager, f), getattr(captured, f)), f
    settings = args[-1]
    assert float(captured.rho) != settings.rho          # refactored
    _assert_checks_in_phases(stats)


# ---- the row-sharded loop's segments as captured graphs ----

# Restart every 3 checks, rho test every 2, rho far off, a CG cut at 13
# steps (a WHILE node of 8-step blocks and an IF node of 5 steps): every
# check variant occurs.
_ROWSHARD_SETTINGS = dict(check_every=5, adaptive_rho_interval=10,
                          restart_every=15, rho=0.01, cg_max_iter=13,
                          eps_abs=1e-7, eps_rel=1e-7, max_iter=3000)
_ROWSHARD_VARIANTS = [("check",) + v for v in _CHECK_VARIANTS]


def _rowshard_path(name, dev):
    """(solve function, its arguments) of a small row-sharded solve on a
    1-rank data mesh on the card: mixed cones in f64, or the hybrid
    path on f32 data (phase 1 and each re-centred round cut at 60
    iterations). Each loop meets every segment it runs at least twice."""
    from admm_library_torch.models.random_qp import random_box_qp
    from admm_library_torch.parallel import make_data_mesh
    from admm_library_torch.parallel import rowshard
    mesh = make_data_mesh()
    if name == "mixed_f64":
        return rowshard.solve_rowsharded, (
            _small_l1_soc(dev), mesh,
            Settings(precision="single", **_ROWSHARD_SETTINGS))
    qp = random_box_qp(torch.Generator().manual_seed(21), n=32, m=64,
                       dtype=torch.float32, device="cpu").to(dev)
    return rowshard.solve_rowsharded_hybrid, (
        qp.astype(torch.float64), mesh,
        Settings(**dict(_ROWSHARD_SETTINGS, rho=0.1, cg_max_iter=200,
                        max_iter=60, eps_abs=1e-6, eps_rel=1e-6)))


def test_replayed_rowshard_segment_is_the_eager_segment(dev, monkeypatch):
    """The first state of the row-sharded loop (its CG head done): every
    check's replay, its CGs conditional nodes, == the eager check,
    bitwise."""
    fn, (qp, mesh, s) = _rowshard_path("mixed_f64", dev)
    _, loops = _recorded_loops(monkeypatch, fn, qp, mesh,
                               s.replace(max_iter=0))
    (kind, step, state), = loops
    assert kind == "solve_rowsharded" and state["A_loc"].is_cuda
    _replay_is_eager(step, state, _ROWSHARD_VARIANTS)


@pytest.mark.parametrize("name", ["mixed_f64", "hybrid"])
def test_captured_rowsharded_solve_is_the_eager_solve(name, dev,
                                                      monkeypatch):
    """A whole row-sharded solve replayed from graphs equals the same
    solve with every segment eager, bitwise, through restarts, rho
    updates and the short last CG block; a second call replays and
    captures nothing."""
    from admm_library_torch.core import graph
    fn, args = _rowshard_path(name, dev)
    eager, captured, stats = _eager_and_captured(monkeypatch, fn, *args)
    fields = ("x", "z", "y", "status", "iters", "r_prim", "r_dual", "rho",
              "cg_steps")
    for f in fields:
        assert torch.equal(getattr(eager, f), getattr(captured, f)), f
    if name == "mixed_f64":
        assert int(captured.status) == int(Status.SOLVED)
    else:
        assert int(captured.iters) > 60                 # rounds ran
    _assert_checks_in_phases(stats)
    before = dict(graph.CACHE.stats)
    again = fn(*args)
    for f in fields:
        assert torch.equal(getattr(again, f), getattr(captured, f)), f
    assert graph.CACHE.stats["captures"] == before["captures"]
    assert graph.CACHE.stats["eager_checks"] == before["eager_checks"]
    assert graph.CACHE.stats["replays"] > before["replays"]


# ---- The single-problem programs as captured segments (api.py,
# core/admm.run_phase, core/polish.polish_step). ----

def _recorded_segments(monkeypatch, fn, *args):
    """fn(*args) with (kind, step, variant, a clone of the state before
    it) of every segment any CheckLoop runs, every loop plain (a captured
    phase runs its checks and refactors inside its graph). Returns the
    records."""
    from admm_library_torch.core import graph
    runs = []
    real = graph.CheckLoop.__call__

    def call(loop, variant):
        runs.append((loop.kind, loop.step, variant,
                     graph._map(torch.clone, loop.state)))
        return real(loop, variant)
    with monkeypatch.context() as m:
        m.setattr(graph.CheckLoop, "__call__", call)
        m.setattr(graph, "capturable", lambda *a, **k: False)
        fn(*args)
    return runs


def _segment_replay_is_eager(step, state, variant):
    """One segment from `state`: the eager step on the default stream
    against three runs of it from a cache entry, each from the same
    state (the entry's first run its eager warm-up, the segment captured
    there, then replayed twice); bitwise on every leaf the step
    writes."""
    from admm_library_torch.core import graph
    cache = graph.CheckCache()
    entry = cache.entry("case", step, state)
    want = list(graph._leaves(step(graph._map(torch.clone, state),
                                   variant)))
    for _ in range(3):
        entry.load(state)
        entry.run(variant)
        got = dict(graph._leaves(entry.buffers))
        for path, value in want:
            assert torch.equal(got[path], value), (variant, path)
    assert cache.stats["captures"] == 1 and cache.stats["replays"] == 2
    assert cache.stats["eager_checks"] == 1


def _config3_f64(dev):
    from admm_library_torch.models.clohessy_wiltshire import (
        build_cw_rendezvous)
    rng = np.random.default_rng(0)                  # bench_cw, seed 0
    s0 = np.array([100.0, -1000.0, 20.0, 0.1, 0.5, -0.05])
    s0[:3] += rng.uniform(-20, 20, 3)
    qp, _ = build_cw_rendezvous(s0, N=20, dtype=torch.float32, device=dev)
    return qp.astype(torch.float64)


def _config4_f64(dev):
    from admm_library_torch.models.low_thrust import build_low_thrust_socp
    qp, spec = build_low_thrust_socp(
        np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1]), N=200,
        device=dev)
    return qp.astype(torch.float64), Settings(
        eps_abs=1e-6, eps_rel=5e-8, band_block=spec.block, max_iter=50000,
        rho_soc_scale=100.0, stall_checks=16, backend="inv")


def _pick_segment(runs, kind, variant, dtype=None, joined=False):
    """(step, state) of the first `variant` of a loop of `kind` (of the
    phase dtype `dtype` where given; with `joined`, of a hybrid solve's
    second phase, whose state holds the first's 'p1')."""
    return next((step, state) for k, step, v, state in runs
                if k == kind and v == variant
                and dtype in (None, step.keywords.get("dtype"))
                and joined == ("p1" in state))


def test_replayed_phase_prologue_is_eager_config3_f32(dev, monkeypatch):
    """The staged path's f32 phase prologue of config 3 (cast, Ruiz,
    factor, carry from the raw f64 data): replay == eager, bitwise."""
    from admm_library_torch import solve
    runs = _recorded_segments(monkeypatch, solve, _config3_f64(dev),
                              Settings(eps_abs=1e-6, eps_rel=1e-6,
                                       max_iter=50000))
    step, state = _pick_segment(runs, "run_admm", admm.PROLOGUE,
                                dtype=torch.float32)
    assert state["raw"]["P"].dtype == torch.float64
    _segment_replay_is_eager(step, state, admm.PROLOGUE)


def test_replayed_lanes_refactor_is_eager(dev, monkeypatch):
    """A lanes refactor of solve_batch (rho 100x off, so lanes take the
    new factor where their own test fired): replay == eager, bitwise."""
    from admm_library_torch import solve_batch
    one = _small_l1_soc(dev)
    qp = QPData(**{f: torch.stack([getattr(one, f)] * 3)
                   for f in ("P", "q", "A", "l", "u", "lam")},
                cone=one.cone)
    qp = QPData(P=qp.P, q=qp.q * torch.tensor(
        [[1.0], [0.5], [2.0]], dtype=qp.dtype, device=dev), A=qp.A,
        l=qp.l, u=qp.u, lam=qp.lam, cone=qp.cone)
    runs = _recorded_segments(monkeypatch, solve_batch, qp,
                              Settings(check_every=5, rho=10.0,
                                       adaptive_rho_interval=10,
                                       restart_every=15, history=3,
                                       backend="chol"))
    step, state = _pick_segment(runs, "run_admm_lanes", admm.REFACTOR)
    assert bool(state["do_t"].any())
    _segment_replay_is_eager(step, state, admm.REFACTOR)


def test_replayed_soc_polish_is_eager_config4(dev):
    """Polish of config 4 (n=2000, 200 SOC(4) blocks) at the reference's
    continuation entry, as the continuation calls it: replay == eager,
    bitwise."""
    import dataclasses
    import functools
    from admm_library_torch.core.admm import qp_leaves
    from admm_library_torch.core.polish import POLISH, polish_step
    from admm_library_torch.models import low_thrust as lt
    qp64, s = _config4_f64(dev)
    entry = lt.reference_continuation_entry(dev)
    step = functools.partial(polish_step, cone=qp64.cone,
                             eps_abs=s.eps_abs, eps_rel=s.eps_rel,
                             act_tol=1e-4)
    state = dict(qp64=qp_leaves(qp64), sol={
        f.name: getattr(entry, f.name) for f in dataclasses.fields(entry)})
    _segment_replay_is_eager(step, state, POLISH)


def test_replayed_hybrid_join_is_eager(dev, monkeypatch):
    """`_solve_core`'s join on config 1 at hybrid precision: the second
    phase's prologue (the first phase's f32 iterates cleaned into f64)
    and its epilogue (the two phases joined): replay == eager,
    bitwise."""
    from admm_library_torch import api
    from admm_library_torch.models.random_qp import reference_random_box_qp
    qp = reference_random_box_qp(dev).astype(torch.float64)
    zeros = [torch.zeros(w, dtype=qp.dtype, device=dev)
             for w in (qp.n, qp.m, qp.m)]
    runs = _recorded_segments(monkeypatch, api._solve_core, qp, *zeros,
                              Settings(eps_abs=1e-6, eps_rel=1e-6), "inv")
    for variant in (admm.PROLOGUE, admm.EPILOGUE):
        step, state = _pick_segment(runs, "run_admm", variant, joined=True)
        _segment_replay_is_eager(step, state, variant)


@pytest.mark.parametrize("path", ["config3", "continuation_chunk"])
def test_a_rerun_captures_nothing(path, dev):
    """A rerun of solve on config 3 (the staged path: phases, polish,
    rounds) and of a config-4 continuation chunk with its polish, on a
    warm cache: every segment replays, none is warmed up or captured,
    and the result is bitwise the first run's."""
    from admm_library_torch import api, solve
    from admm_library_torch.core import graph
    from admm_library_torch.models import low_thrust as lt
    if path == "config3":
        fn, args = solve, (_config3_f64(dev), Settings(
            eps_abs=1e-6, eps_rel=1e-6, max_iter=50000))
    else:
        qp64, s = _config4_f64(dev)
        fn, args = api._f64_continuation, (
            qp64, lt.reference_continuation_entry(dev),
            s.replace(max_iter=2000), "inv")
    graph.CACHE.clear()
    first = fn(*args)
    before = dict(graph.CACHE.stats)
    again = fn(*args)
    stats = {k: graph.CACHE.stats[k] - before[k] for k in before}
    assert stats["captures"] == 0 and stats["eager_checks"] == 0
    assert stats["replays"] > 0
    for f in ("x", "z", "y", "status", "iters"):
        assert torch.equal(getattr(first, f), getattr(again, f)), f



# ---- whole-solve programs (graph.program) ----

def _count_reads(monkeypatch):
    """A list that grows by one at each host read of a CUDA tensor
    (item, tolist, bool, float, int) while the test runs."""
    reads = []
    for name in ("item", "tolist", "__bool__", "__float__", "__int__"):
        real = getattr(torch.Tensor, name)

        def read(t, *a, _real=real, **k):
            if t.is_cuda:
                reads.append(1)
            return _real(t, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, read)
    return reads


def _program_case(case, dev):
    from admm_library_torch import solve, solve_batch
    qp16 = mc.monte_carlo_mpc(torch.Generator().manual_seed(4), batch=16,
                              N=10, dim=2, device=dev)[0].astype(
                                  torch.float64)
    one = _small_l1_soc(dev)
    cases = {
        "fallback_inv": (solve_batch_shared, qp16, Settings(
            eps_abs=1e-9, eps_rel=1e-9)),
        "mixed_chol": (solve_batch_shared, _mixed_batch(dev), Settings(
            backend="chol", rho=10.0)),
        "two_phase": (solve_batch_shared, qp16, Settings(
            recenter_rounds=0)),
        "cg_rounds": (solve_batch_shared, qp16, Settings(
            backend="cg", max_iter=300)),
        "solve_batch_hybrid": (solve_batch, QPData(
            **{f: torch.stack([getattr(one, f)] * 3)
               for f in ("P", "q", "A", "l", "u", "lam")}, cone=one.cone),
            Settings(backend="chol", rho=10.0)),
        "solve_double": (solve, one, Settings(precision="double",
                                              backend="inv")),
    }
    return cases[case]


@pytest.mark.parametrize("case", ["fallback_inv", "mixed_chol",
                                  "two_phase", "cg_rounds",
                                  "solve_batch_hybrid", "solve_double"])
def test_a_program_rerun_is_one_graph_launch(case, dev, monkeypatch):
    """solve_batch_shared and api._solve_core as one program: the first
    run (its warm-up, then its capture) and a rerun (one graph launch,
    no host read, nothing captured or warmed) bitwise the same solve
    with every segment eager, the kernels launched as often; with a
    1e-9 target the f64 fallback's phase ran inside the IF node."""
    from admm_library_torch.core import graph
    from admm_library_torch.ops import pallas_cg
    fn, qp, s = _program_case(case, dev)
    kernels = (fused.fused_iterate_shared, pallas_cg.pallas_cg_solve)

    def run(count=False):
        for k in kernels:
            k.launches = 0
        with monkeypatch.context() as m:
            reads = _count_reads(m) if count else []
            out = fn(qp, s)
            torch.cuda.synchronize()
            n_reads = len(reads)
        return out, [k.launches for k in kernels], n_reads
    with monkeypatch.context() as m:
        m.setattr(graph, "capturable", lambda *a, **k: False)
        eager, eager_launches, _ = run()
    graph.CACHE.clear()
    first, first_launches, _ = run()
    before = dict(graph.CACHE.stats)
    again, again_launches, n_reads = run(count=True)
    stats = {k: graph.CACHE.stats[k] - before[k] for k in before}
    for f in ("x", "z", "y", "status", "iters", "r_prim", "r_dual", "obj",
              "rho", "history"):
        assert torch.equal(getattr(eager, f), getattr(first, f)), f
        assert torch.equal(getattr(eager, f), getattr(again, f)), f
    assert eager_launches == first_launches == again_launches
    assert stats["replays"] == 1 and n_reads == 0
    assert stats["captures"] == 0 and stats["eager_checks"] == 0
    if case == "fallback_inv":
        entry, = graph.CACHE.entries.values()
        assert int(entry.loops["node1/loop0:run_admm_batch_shared"]
                   ["it"]) > 0


# ---- conditional nodes: graph.while_blocks inside a capture ----

def _cond_probe():
    """IF and WHILE nodes in a CheckLoop on the card, each replay held
    to the plain loop: a loop of unit blocks adds 1 to 'n' and 'x' while
    n < k. Blocks [1] * 6 + [2]: a WHILE node of at most 6 passes, then
    an IF node of a block of 2 steps. The body's allocations come from
    the entry's body pool, those after the nodes from its graph pool.
    Prints 'ok'."""
    from admm_library_torch.core import graph
    dev = torch.device("cuda", 0)
    blocks = [1] * 6 + [2]
    ptrs = {"body": [], "after": []}

    def step(state, variant):
        def body(c, steps):
            n = c["n"] + steps
            ptrs["body"].append(n.data_ptr())
            return dict(n=n, x=c["x"] + float(steps))
        out = graph.while_blocks(dict(n=state["n0"], x=state["x"]),
                                 lambda c: c["n"] < state["k"], body,
                                 blocks)
        y = out["x"] * 2.0
        ptrs["after"].append(y.data_ptr())
        return dict(n=out["n"], y=y)

    def plain(k):
        n = 0
        for steps in blocks:
            if not n < k:
                break
            n += steps
        return n

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    state = dict(n0=zero, k=zero.clone(), n=zero.clone(),
                 x=torch.zeros(4, device=dev), y=torch.zeros(4, device=dev))
    cache = graph.CheckCache()
    loop = graph.CheckLoop("probe", step, state, None, "cg", cache=cache)
    assert loop.capture
    # k 0: no block; 3: the WHILE node stops on the flag; 6: on its
    # budget, the IF node then runs; 7: the same; 20: both to the end.
    for k in (0, 3, 6, 7, 20, 0, 1):
        loop.set(dict(k=torch.tensor(k, device=dev)))
        loop((False, False))
        want = plain(k)
        assert int(loop.state["n"]) == want, (k, int(loop.state["n"]))
        assert torch.equal(loop.state["y"],
                           torch.full((4,), 2.0 * want, device=dev))
    assert cache.stats["captures"] == 1 and cache.stats["replays"] == 6
    entry, = cache.entries.values()
    # Two nodes' bodies: the WHILE body ends with the re-arm kernel.
    assert entry.body_nodes[(False, False)] >= 4
    # Where the captured run's memory lies: the body in the body pool,
    # the tensors after the nodes in the graph pool.
    segs = torch.cuda.memory_snapshot()

    def pool_of(ptr):
        for seg in segs:
            if seg["address"] <= ptr < seg["address"] + seg["total_size"]:
                return tuple(seg["segment_pool_id"])
        return None
    assert pool_of(ptrs["body"][-1]) == tuple(entry.body_pool_ids[1])
    assert pool_of(ptrs["after"][-1]) == tuple(entry.pool)
    print("ok")


def test_conditional_nodes_in_a_fresh_process(dev):
    """The node library built and loaded by a fresh process, IF and
    WHILE nodes replayed against the plain loop (`_cond_probe`)."""
    import os
    import subprocess
    import sys
    tests = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import test_torch_gpu as t; t._cond_probe()\n"
            % (os.path.dirname(tests), tests))
    out = subprocess.run([sys.executable, "-c", code], cwd=tests,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", (
        out.stdout + out.stderr)


def test_a_body_that_fails_to_capture_raises(dev):
    """A conditional body that reads the device cannot be captured: the
    capture raises (no fallback to a host loop), and the cache captures
    the next loop as before."""
    from admm_library_torch.core import graph

    def step(state, variant):
        def body(c, steps):
            return dict(x=c["x"] + float(c["x"].sum()))
        out = graph.while_blocks(dict(x=state["x"]),
                                 lambda c: c["x"].sum() < 10.0, body,
                                 [1, 1])
        return dict(x=out["x"])
    cache = graph.CheckCache()
    state = {"x": torch.ones(3, device=dev)}
    loop = graph.CheckLoop("probe", step, state, None, "cg", cache=cache)
    with pytest.raises(RuntimeError):
        loop((False, False))                # warm-up, then its capture
    assert cache.stats["captures"] == 0
    torch.cuda.synchronize()

    def good(state, variant):
        out = graph.while_blocks(
            dict(x=state["x"]), lambda c: c["x"].sum() < 10.0,
            lambda c, steps: dict(x=c["x"] + 1.0), [1, 1])
        return dict(x=out["x"])
    loop = graph.CheckLoop("probe2", good, state, None, "cg", cache=cache)
    loop((False, False))                    # eager: 1 -> 3, then captured
    assert torch.equal(loop.state["x"], torch.full((3,), 3.0, device=dev))
    loop((False, False))                    # replayed: 3 -> 4
    assert cache.stats["captures"] == 1
    assert torch.equal(loop.state["x"], torch.full((3,), 4.0, device=dev))


def test_cg_solve_in_a_capture_is_the_plain_cg(dev):
    """ops/kkt.cg_solve as conditional nodes, replayed, is bitwise the
    plain CG with host reads: lanes that freeze at different steps, a
    NaN lane, a max_iter no multiple of 8 (a WHILE and an IF node)."""
    from admm_library_torch.core import graph
    gen = torch.Generator().manual_seed(7)
    n, m, B = 12, 20, 4
    R = torch.randn(n, n, generator=gen, dtype=torch.float64)
    P = (R @ R.T / n + 0.1 * torch.eye(n, dtype=torch.float64)).to(dev)
    A = torch.randn(m, n, generator=gen, dtype=torch.float64).to(dev)
    rho = (0.1 + torch.rand(m, generator=gen, dtype=torch.float64)).to(dev)
    fac = kkt.factor_condensed(P, A, 1e-6, rho, "cg")
    rhs = torch.randn(B, n, generator=gen, dtype=torch.float64).to(dev)
    rhs[1] *= 1e-3
    rhs[2] = float("nan")
    for max_iter, tol in ((13, 1e-12), (200, 1e-9), (3, 1e-14)):
        want = kkt.cg_solve(fac, rhs, tol=tol, max_iter=max_iter)

        def step(state, variant):
            return dict(x=kkt.cg_solve(state["fac"], state["rhs"], tol=tol,
                                       max_iter=max_iter))
        state = dict(fac=fac, rhs=rhs, x=torch.zeros_like(rhs))
        cache = graph.CheckCache()
        loop = graph.CheckLoop("probe", step, state, None, "cg",
                               cache=cache)
        for _ in range(3):                  # warm-up, capture, replays
            loop((False, False))
            got = loop.state["x"].clone()
            assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
        assert cache.stats["captures"] == 1 and cache.stats["replays"] == 2


# ---- the phase loop: checks inside a WHILE node, nested nodes ----

def _nested_step(state, variant):
    """A toy check whose body holds a WHILE node of its own (m counts to
    it % 3 + 1 in unit blocks), fingerprints its variant into 'acc' and
    stops at 'stop'; its rho-test variant asks for a refactor on even
    counts, which folds the count into 'r'."""
    from admm_library_torch.core import graph
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


@pytest.mark.parametrize("stop,max_iter", [(5, 20), (9, 20), (30, 13),
                                           (1, 20), (7, 7)])
def test_nested_phase_nodes_are_the_plain_loop(stop, max_iter, dev):
    """A phase three deep on the card (its WHILE node, an IF node a check
    variant, the check's own WHILE node; the refactor an IF node),
    bitwise the same loop run plain on the card, whatever the stop and
    the bound; the second loop of the key replays the first's graph."""
    from admm_library_torch.core import graph
    s = Settings(check_every=1, max_iter=max_iter, adaptive_rho_interval=2)
    cache = graph.CheckCache()
    got = []
    for capture in (False, True, True):
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        state = dict(it=zero, acc=zero.clone(), r=zero.clone(),
                     stop=torch.tensor(stop, device=dev),
                     flags=torch.ones(2, dtype=torch.bool, device=dev))
        loop = graph.CheckLoop("nested", _nested_step, state, None, "cg",
                               capture=capture, cache=cache)
        loop.run_checks(s, 3)
        got.append([int(loop.state[k]) for k in ("it", "acc", "r")])
    assert got[1] == got[0] and got[2] == got[0]
    assert got[0][0] == min(stop, max_iter)
    assert cache.stats["captures"] == 1 and cache.stats["replays"] == 2
    entry, = cache.entries.values()
    (phase, nodes), = entry.body_nodes.items()
    assert isinstance(phase, graph.Phase) and nodes > 0
    assert len(phase.reachable) == (4 if max_iter >= 6 else 3)


def test_kernel_1_in_an_if_body_is_the_eager_launch(dev):
    """Kernel 1, a cooperative launch, inside an IF node: each replay
    with the flag set is bitwise the eager launch, with it clear leaves
    the iterates, and the launches are counted on the card, one a pass
    that ran."""
    from admm_library_torch.core import graph
    qp, _, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(0),
                                  batch=8, N=10, dim=2, device=dev)
    qps, _ = ruiz_equilibrate(qp, 10)
    s = Settings()
    rho = admm.rho_vec_of(torch.tensor(s.rho, device=dev),
                          admm.is_equality_row_shared(qps), s)
    fac = kkt.factor_condensed(qps.P, qps.A, s.sigma, rho, "inv")
    x, z, y = (torch.zeros((8, w), device=dev)
               for w in (qps.n, qps.m, qps.m))
    args = (qps.A, fac["Minv"], fac["M"], qps.q, rho, qps.lam, qps.l,
            qps.u)
    kw = dict(cone=qps.cone, sigma=s.sigma, alpha=s.alpha, k=5)
    want = fused.fused_iterate_shared(*args, x, z, y, **kw)

    def step(state, variant):
        return graph.while_blocks(
            dict(x=state["x"], z=state["z"], y=state["y"]),
            lambda c: state["go"], lambda c, steps: dict(zip(
                "xzy", fused.fused_iterate_shared(*args, c["x"], c["z"],
                                                  c["y"], **kw))), [1])

    cache = graph.CheckCache()
    loop = graph.CheckLoop("kernel1_if", step, dict(
        x=x, z=z, y=y, go=torch.ones((), dtype=torch.bool, device=dev)),
        None, "inv", cache=cache)
    loop((False, False))                 # the warm-up, eager
    fused.fused_iterate_shared.launches = 0
    for flag in (True, False, True):
        loop.set(dict(x=x, z=z, y=y, go=torch.tensor(flag, device=dev)))
        loop((False, False))
        for key, w, v in zip("xzy", want, (x, z, y)):
            assert torch.equal(loop.state[key], w if flag else v), (flag,
                                                                    key)
    assert fused.fused_iterate_shared.launches == 2
    assert fused.fused_iterate_shared.host == 0
    assert cache.stats["captures"] == 1 and cache.stats["replays"] == 3


# ---------------------------------------------------------------- spans

def _mc16(dev, seed=2):
    qp, _, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(seed),
                                  batch=16, N=10, dim=2, device=dev)
    return qp


@pytest.fixture
def tracing(dev):
    """Tracing on for the test, with counts zeroed and everything
    recorded forgotten after."""
    trace.reset()
    trace.enable()
    graph.zero_counts()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


def _graph_nodes(entry, variant):
    """Nodes of an entry's captured graph (its kept template) and of its
    conditional bodies."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(
        ctypes.c_void_p(entry.graphs[variant].raw_cuda_graph()), None,
        ctypes.byref(n))
    assert rc == 0
    return n.value + entry.body_nodes.get(variant, 0)


def test_stamps_time_a_captured_kernel_as_cuda_events_do(dev, tracing):
    """A span around products of known CUDA-event time inside a captured
    graph reads that time within 2% or 2 us a replay; its count is the
    replays."""
    trace.prepare(dev)
    a = torch.randn(4096, 4096, device=dev)
    side = torch.cuda.Stream(dev)
    graphs = []
    for spanned in (False, True):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            for _ in range(2):
                a @ a
        torch.cuda.synchronize()
        with torch.cuda.graph(g, stream=side):
            with (trace.span("probe") if spanned
                  else contextlib.nullcontext()):
                b = a @ a
                b = b @ a
        graphs.append(g)
    times = []
    for g in graphs:
        g.replay()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(10):
            g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    out = trace.read()
    probe = out["device"]["probe"]
    assert probe["count"] == 11
    span_ms = probe["ns"] / probe["count"] / 1e6
    assert abs(span_ms - times[0]) <= max(0.02 * times[0], 0.002), (
        span_ms, times)
    (clock,) = out["clock"].values()
    assert clock["uncertainty_ns"] < 20_000 and out["replays"] == []


def test_a_traced_program_records_its_tree_on_the_card(dev, tracing):
    """A traced solve_batch_shared: its first run (the eager warm-up)
    timed on the host, its replay on the card's stamps with the same
    paths and, on the same data, the same counts; the program span one
    ring row that lies between the launch and the end of the call on
    the host clock, and within 1% of the replay's CUDA-event time."""
    qp, s = _mc16(dev), Settings()
    graph.CACHE.replay_events = []
    try:
        solve_batch_shared(qp, s)
        warm = trace.read()
        trace.reset()
        fused.fused_iterate_shared.launches = 0
        solve_batch_shared(qp, s)
        torch.cuda.synchronize()
        t_end = time.perf_counter_ns()
        events = graph.CACHE.replay_events
        (event_ms,) = [a.elapsed_time(b) for a, b in events]
    finally:
        graph.CACHE.replay_events = None
    out = trace.read()
    device, host = out["device"], warm["host"]
    root = "solve_batch_shared"
    assert device and set(device) <= set(host)
    for path, t in device.items():
        assert t["count"] == host[path]["count"], path
    for path in ("", "/phase1/checks/check/kernel1", "/round/checks/check",
                 "/final"):
        assert root + path in device, path
    assert device[root]["count"] == 1
    assert (device[root + "/phase1/checks/check/kernel1"]["count"]
            == device[root + "/phase1/checks/check"]["count"])
    (row,) = out["replays"]
    (clock,) = out["clock"].values()
    u = clock["uncertainty_ns"]
    assert u < 20_000 and row["path"] == root
    launch = [sp for sp in out["spans"] if sp["name"] == "launch"]
    assert len(launch) == 1
    assert launch[0]["start"] - u <= row["start"] < row["end"] <= t_end + u
    assert abs(device[root]["ns"] / 1e6 - event_ms) <= 0.01 * event_ms
    assert fused.fused_iterate_shared.launches == sum(
        t["count"] for p, t in device.items() if p.endswith("/kernel1"))
    # On the card too each span holds its children: the parts of the
    # program (kernel 1, the plain body, the rest of the checks, the
    # work outside them) sum to its span.
    for path, t in device.items():
        inner = sum(c["ns"] for p, c in device.items()
                    if p.rpartition("/")[0] == path)
        assert t["ns"] >= inner, path


def test_an_untraced_program_holds_no_stamp_and_no_counter(dev,
                                                            monkeypatch):
    """With tracing off the captured program holds no stamp and no count
    of its phases' WHILE passes: its node count is the traced graph's
    less one node a stamp and a phase's pass counter (kernel 1's launch
    counters are in both). Its answers are the traced program's, bit
    for bit; after its replay the launches still read, the passes raise,
    and zeroing the counts clears that."""
    qp, s = _mc16(dev, seed=3), Settings()
    stamps, phases = [], []
    real_stamp, real_phase = trace._stamp, graph.phase_nodes

    def stamp(d, slot, mode):
        if torch.cuda.is_current_stream_capturing():
            stamps.append(mode)
        return real_stamp(d, slot, mode)

    def phase(*a, **k):
        phases.append(1)
        return real_phase(*a, **k)
    monkeypatch.setattr(trace, "_stamp", stamp)
    monkeypatch.setattr(graph, "phase_nodes", phase)
    monkeypatch.setattr(graph.CACHE, "keep_graphs", True)
    graph.CACHE.clear()
    try:
        nodes, entries, sols = [], [], []
        for on in (False, True):
            if on:
                trace.enable()
            del stamps[:], phases[:]
            for _ in range(2):
                sol = solve_batch_shared(qp, s)
            sols.append(sol)
            entry = list(graph.CACHE.entries.values())[-1]
            nodes.append(_graph_nodes(entry, graph.PROGRAM))
            entries.append((entry, len(stamps), len(phases)))
            if not on:
                assert entry.blind_passes[graph.PROGRAM] == 1
                assert stamps == []
                assert fused.fused_iterate_shared.launches > 0
                with pytest.raises(RuntimeError, match="tracing off"):
                    graph.CACHE.while_passes()
                graph.zero_counts()
        for f in ("x", "z", "y", "status", "iters"):
            assert torch.equal(getattr(sols[0], f), getattr(sols[1], f)), f
        (off, _, _), (on, n_stamps, n_phases) = entries
        assert on.blind_passes[graph.PROGRAM] == 0
        assert (len(on.body_kernels[graph.PROGRAM])
                == len(off.body_kernels[graph.PROGRAM]) > 0)
        assert n_stamps > 0 and n_phases > 0
        assert nodes[1] - nodes[0] == n_stamps + n_phases, (nodes, n_stamps,
                                                            n_phases)
    finally:
        trace.disable()
        trace.reset()
        graph.zero_counts()
        graph.CACHE.clear()
