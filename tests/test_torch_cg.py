"""Port parity for the CG backends: the plain twin of the Jacobi-PCG
kernel (ops/pallas_cg.py), the matrix-free lockstep CG of ops/kkt.py
and the 'cg' / 'pallas_cg' factors, against the JAX package.

The JAX kernel runs in Pallas interpret mode on the CPU; the port's
wrapper takes its twin for CPU tensors. Both are the same lockstep
iteration in the same order, so f64 results agree to rounding (the
solves converge to ~1e-12, atol 1e-8 as tests/test_kkt.py uses); f32
after 5 steps agrees to a few f32 ulps of the solution (atol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_library_tpu.ops import kkt as jkkt
from admm_library_tpu.ops.pallas_cg import pallas_cg_solve as jpcg
from admm_library_torch import Settings
from admm_library_torch.core import admm as tadmm
from admm_library_torch.ops import kkt as tkkt
from admm_library_torch.ops import pallas_cg as tpcg
from admm_library_torch.problem import ConeSpec, QPData

# Small shapes: one intra-op thread keeps the CPU free for the other
# test workers.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _spd_case():
    """The inputs of tests/test_kkt.py::test_pallas_cg_matches_chol."""
    n, B = 24, 4
    R = jax.random.normal(jax.random.key(11), (n, n), dtype=jnp.float64)
    M = R @ R.T + n * jnp.eye(n, dtype=jnp.float64)
    rhs = jax.random.normal(jax.random.key(12), (B, n), dtype=jnp.float64)
    return M, rhs


def test_twin_matches_jax_kernel_f64():
    M, rhs = _spd_case()
    ref = jpcg(M, rhs, iters=200, tol=1e-12, interpret=True)
    got = tpcg.pallas_cg_solve_reference(_t(M), _t(rhs), iters=200,
                                         tol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-8)
    np.testing.assert_allclose(
        got.numpy(), np.linalg.solve(np.asarray(M), np.asarray(rhs).T).T,
        atol=1e-8)
    # The wrapper on CPU tensors is the twin.
    wrapped = tpcg.pallas_cg_solve(_t(M), _t(rhs), iters=200, tol=1e-12)
    assert torch.equal(wrapped, got)


def test_twin_matches_jax_kernel_f32_few_steps():
    M, rhs = _spd_case()
    M32, rhs32 = M.astype(jnp.float32), rhs.astype(jnp.float32)
    ref = jpcg(M32, rhs32, iters=5, tol=1e-7, interpret=True)
    got = tpcg.pallas_cg_solve(_t(M32), _t(rhs32), iters=5, tol=1e-7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_vector_rhs_x0_and_frozen_lane():
    M, rhs = _spd_case()
    rhs = rhs.at[2].set(0.0)              # a zero-rhs lane
    Mt, rt = _t(M), _t(rhs)
    x = tpcg.pallas_cg_solve(Mt, rt, iters=200, tol=1e-12)
    ref = jpcg(M, rhs, iters=200, tol=1e-12, interpret=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=1e-8)
    # ‖rhs‖ = 0 ≤ tol from the start: the lane never moves from x0.
    assert torch.equal(x[2], torch.zeros_like(x[2]))
    # 1-D rhs keeps its shape and solves the same lane.
    x1 = tpcg.pallas_cg_solve(Mt, rt[0], iters=200, tol=1e-12)
    assert x1.shape == (rt.shape[1],)
    np.testing.assert_allclose(x1.numpy(), x[0].numpy(), atol=1e-12)
    # A given x0: from the solution every lane is frozen at once and
    # returns x0 bitwise; from a perturbed start it matches JAX.
    assert torch.equal(tpcg.pallas_cg_solve(Mt, rt, x0=x, iters=50,
                                            tol=1e-6), x)
    x0 = np.random.default_rng(0).standard_normal(rt.shape)
    got = tpcg.pallas_cg_solve(Mt, rt, x0=_t(x0), iters=7, tol=1e-12)
    want = jpcg(M, rhs, x0=jnp.asarray(x0), iters=7, tol=1e-12,
                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_non_cpu_tensors_never_take_the_twin():
    """Any device but the CPU goes to the kernel or raises: a tensor on
    the meta device (no data, no kernel) raises instead of running the
    plain twin."""
    M = torch.eye(4, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="unsupported device"):
        tpcg.pallas_cg_solve(M, torch.ones(2, 4, device="meta",
                                           dtype=torch.float64))


def test_batched_m_raises():
    M = torch.eye(4, dtype=torch.float64).expand(2, 4, 4)
    with pytest.raises(ValueError, match="unbatched"):
        tpcg.pallas_cg_solve(M, torch.ones(2, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="unbatched"):
        tkkt.solve_condensed({"M": M}, torch.ones(2, 4, dtype=torch.float64),
                             "pallas_cg")


# ---- the kernel's plan (a CPU function of the card's limits) ----

H100_SMS = 132


def _one_block_per_sm(C, t):
    """Clusters a card holds where each block takes its own SM."""
    return H100_SMS // C


def _scarce(C, t):
    """Clusters of 8 placed only two to a 16-SM GPC, as on a card with
    SMs disabled: fewer clusters than SMs / C."""
    return max(1, 16 // C)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [60, 100])
@pytest.mark.parametrize("B", [1, 128])
def test_plan_holds_small_m_in_one_block(B, n, itemsize):
    design, C, _ = tpcg.plan(B, n, itemsize, H100_SMS, tpcg.SMEM_LIMIT,
                             _one_block_per_sm)
    assert (design, C) == ("resident", 1)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 128, 1024])
def test_plan_spreads_the_flagship_m_over_a_cluster(B, itemsize):
    """n=450: M is 810 KB in f32 and 1.6 MB in f64; a slice fits one
    block only in a cluster of 4 (f32: 113 columns, 203,400 B) or 8 (f64:
    57 columns, 205,200 B)."""
    design, C, LT = tpcg.plan(B, 450, itemsize, H100_SMS, tpcg.SMEM_LIMIT,
                              _one_block_per_sm)
    assert design == "resident" and C in (4, 8)
    assert tpcg.resident_smem_bytes(C, LT, 450, itemsize) <= tpcg.SMEM_LIMIT
    smallest = 4 if itemsize == 4 else 8
    assert tpcg.resident_smem_bytes(smallest // 2, 1, 450, itemsize) > \
        tpcg.SMEM_LIMIT
    # f32 at B=1: the cluster of 4 doubled to 8, which holds the lane in
    # one wave at the same tile; at 128 and 1024 lanes it is not.
    assert C == (8 if B == 1 else smallest)


@pytest.mark.parametrize("n", [60, 100, 450])
@pytest.mark.parametrize("B", [1, 3, 30, 128])
def test_plan_doubles_the_cluster_only_above_n128_in_one_wave(B, n):
    """The cluster grows past the smallest that fits only for n > 128,
    and only to a size whose clusters hold every lane in one wave at
    the same lane tile."""
    waves = {1: 264, 2: 132, 4: 30, 8: 15}          # as an H100 reports
    mc = lambda C, t: waves[C]  # noqa: E731
    design, C, LT = tpcg.plan(B, n, 4, H100_SMS, tpcg.SMEM_LIMIT, mc)
    smallest = next(c for c in tpcg.CLUSTERS
                    if tpcg.resident_smem_bytes(c, 1, n, 4)
                    <= tpcg.SMEM_LIMIT)
    assert design == "resident"
    if n <= 128 or C == smallest:
        assert C == smallest
        return
    assert -(-B // LT) <= waves[C]
    base = tpcg.plan(B, n, 4, H100_SMS, tpcg.SMEM_LIMIT,
                     lambda c, t: waves[c] if c == smallest else 0)
    assert base == ("resident", smallest, LT)
    assert (n, B) in {(450, 1), (450, 3)}


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 128, 1024])
def test_plan_streams_an_m_no_cluster_holds(B, itemsize):
    design, C, LT = tpcg.plan(B, 2000, itemsize, H100_SMS, tpcg.SMEM_LIMIT,
                              _one_block_per_sm)
    assert (design, C) == ("stream", 1)
    assert LT <= tpcg.auto_lane_tile(B)
    # auto_lane_tile's tile, cut only where its block would not fit.
    if tpcg.stream_smem_bytes(tpcg.auto_lane_tile(B), 2000, itemsize) \
            <= tpcg.SMEM_LIMIT:
        assert LT == tpcg.auto_lane_tile(B)


@pytest.mark.parametrize("max_clusters", [_one_block_per_sm, _scarce],
                         ids=["one_per_sm", "scarce"])
def test_plan_fits_shared_memory_and_one_wave(max_clusters):
    """Over B × n × item size: the plan's blocks fit 232,448 bytes, and
    its ⌈B/LT⌉ clusters fit one wave unless LT is already the largest
    tile that fits."""
    for B in (1, 3, 128, 1024):
        for n in (24, 60, 100, 450, 451, 2000):
            for itemsize in (4, 8):
                design, C, LT = tpcg.plan(B, n, itemsize, H100_SMS,
                                          tpcg.SMEM_LIMIT, max_clusters)
                case = (B, n, itemsize, design, C, LT)
                if design == "stream":
                    assert LT in tpcg.LANE_TILES, case
                    assert C == 1, case
                    assert tpcg.stream_smem_bytes(LT, n, itemsize) <= \
                        tpcg.SMEM_LIMIT, case
                    assert tpcg.resident_smem_bytes(8, 1, n, itemsize) > \
                        tpcg.SMEM_LIMIT, case
                    continue
                assert C in tpcg.CLUSTERS, case
                assert LT in tpcg.RESIDENT_TILES, case
                assert tpcg.resident_smem_bytes(C, LT, n, itemsize) <= \
                    tpcg.SMEM_LIMIT, case
                fits = [t for t in tpcg.RESIDENT_TILES
                        if tpcg.resident_smem_bytes(C, t, n, itemsize)
                        <= tpcg.SMEM_LIMIT]
                wave = min(max_clusters(C, LT), H100_SMS // C)
                assert -(-B // LT) <= wave or LT == fits[-1], case
                # The smallest such LT: one less would need a second wave.
                smaller = [t for t in fits if t < LT]
                for t in smaller:
                    assert -(-B // t) > min(max_clusters(C, t),
                                            H100_SMS // C), case


def test_plan_skips_a_cluster_size_the_card_cannot_place():
    """A card that can place no cluster of 4 (max_clusters 0) gets 8."""
    design, C, _ = tpcg.plan(1, 450, 4, H100_SMS, tpcg.SMEM_LIMIT,
                             lambda C, t: 0 if C == 4 else 16 // C)
    assert (design, C) == ("resident", 8)


def test_smem_reckoning_matches_the_worked_sizes():
    """The slice of M and p's two buffers as the kernel's layout counts
    them, at the sizes worked out by hand: n=450 f32, C=4: 113 columns,
    203,400 B of M; C=8: 57 columns, 102,600 B, plus 2·8·452·4 B of p at
    LT=8 (rows padded to 16 bytes)."""
    m4 = 450 * 113 * 4
    assert m4 == 203400
    assert tpcg.resident_smem_bytes(4, 1, 450, 4) - m4 < 8 * 1024
    m8 = 450 * 57 * 4
    assert m8 == 102600
    extra = tpcg.resident_smem_bytes(8, 8, 450, 4) - m8 - 2 * 8 * 452 * 4
    # Product partials (8 groups·8 lanes·57), reduction scratch (16
    # warps·3·8), slots (6·8 blocks·8 lanes).
    assert extra == 4 * (8 * 8 * 57 + 16 * 3 * 8 + 6 * 8 * 8)
    # Up to n=128 k stays whole: one group of partials.
    assert tpcg.resident_smem_bytes(1, 1, 60, 4) == 4 * (
        2 * 60 + 60 * 60 + 60 + 48 + 6)
    # C=4 holds 4 lanes in f32 (226,248 B), C=8 2 lanes in f64.
    assert tpcg.resident_smem_bytes(4, 4, 450, 4) <= tpcg.SMEM_LIMIT
    assert tpcg.resident_smem_bytes(4, 8, 450, 4) > tpcg.SMEM_LIMIT
    assert tpcg.resident_smem_bytes(8, 2, 450, 8) <= tpcg.SMEM_LIMIT
    assert tpcg.resident_smem_bytes(8, 4, 450, 8) > tpcg.SMEM_LIMIT


def _system(seed, n=40, m=60):
    """tests/test_kkt.py's random condensed system."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    P = R @ R.T + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    rho = np.abs(rng.standard_normal(m)) + 0.5
    return P, A, rho


@pytest.mark.parametrize("lanes", [None, 5], ids=["vector", "batch5"])
def test_cg_solve_matches_jax(lanes):
    P, A, rho = _system(3)
    shape = (40,) if lanes is None else (lanes, 40)
    rhs = np.random.default_rng(4).standard_normal(shape)
    jfac = jkkt.factor_condensed(jnp.asarray(P), jnp.asarray(A), 1e-6,
                                 jnp.asarray(rho), "cg")
    tfac = tkkt.factor_condensed(_t(P), _t(A), 1e-6, _t(rho), "cg")
    assert sorted(tfac) == ["A", "P", "rho", "sigma"]
    ref = jkkt.solve_condensed(jfac, jnp.asarray(rhs), "cg", cg_tol=1e-12,
                               cg_max_iter=500)
    got = tkkt.solve_condensed(tfac, _t(rhs), "cg", cg_tol=1e-12,
                               cg_max_iter=500)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-10)
    M = tkkt.condensed_matrix(_t(P), _t(A), 1e-6, _t(rho))
    assert float((_t(rhs) - got @ M.T).abs().max()) < 1e-8
    # A step cap stops it early, as the reference's loop bound does.
    ref5 = jkkt.cg_solve(jfac, jnp.asarray(rhs), max_iter=5)
    got5 = tkkt.cg_solve(tfac, _t(rhs), max_iter=5)
    np.testing.assert_allclose(got5.numpy(), np.asarray(ref5), atol=1e-12)


def test_pallas_cg_factor_is_symmetric_and_matches_jax():
    P, A, rho = _system(5)
    A = A * np.exp(np.random.default_rng(6).standard_normal((60, 1)))
    jfac = jkkt.factor_condensed(jnp.asarray(P), jnp.asarray(A), 1e-6,
                                 jnp.asarray(rho), "pallas_cg")
    tfac = tkkt.factor_condensed(_t(P), _t(A), 1e-6, _t(rho), "pallas_cg")
    assert list(tfac) == ["M"]
    assert torch.equal(tfac["M"], tfac["M"].T)
    np.testing.assert_allclose(tfac["M"].numpy(), np.asarray(jfac["M"]),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("backend", ["cg", "pallas_cg"])
def test_cg_backends_ignore_refine_steps(backend):
    P, A, rho = _system(7)
    rhs = _t(np.random.default_rng(8).standard_normal((3, 40)))
    fac = tkkt.factor_condensed(_t(P), _t(A), 1e-6, _t(rho), backend)
    kw = dict(cg_tol=1e-6, cg_max_iter=20)
    plain = tkkt.solve_condensed(fac, rhs, backend, refine_steps=0, **kw)
    refined = tkkt.solve_condensed(fac, rhs, backend, refine_steps=3, **kw)
    assert torch.equal(plain, refined)


@pytest.mark.parametrize("backend", ["cg", "pallas_cg"])
def test_admm_iteration_passes_the_cg_settings(backend):
    """admm_iteration hands cg_tol / cg_max_iter to the KKT solve: one CG
    step gives another x-update than 200."""
    P, A, rho = _system(9, n=20, m=30)
    rng = np.random.default_rng(10)
    qp = QPData(P=_t(P), q=_t(rng.standard_normal(20)), A=_t(A),
                l=_t(-np.ones(30)), u=_t(np.ones(30)),
                lam=torch.zeros(0, dtype=torch.float64),
                cone=ConeSpec(m_box=30))
    fac = tkkt.factor_condensed(qp.P, qp.A, 1e-6, _t(rho), backend)
    x, z, y = (_t(rng.standard_normal((2, w))) for w in (20, 30, 30))
    outs = [tadmm.admm_iteration(qp, fac, x, z, y, _t(rho),
                                 Settings(cg_max_iter=it), backend)
            for it in (1, 200)]
    assert not torch.equal(outs[0][0], outs[1][0])
    # 200 steps solve the x-update; one step does not.
    M = tkkt.condensed_matrix(qp.P, qp.A, 1e-6, _t(rho))
    rhs = 1e-6 * x - qp.q + (_t(rho) * z - y) @ qp.A
    xt = tkkt.solve_condensed(fac, rhs, backend, cg_max_iter=200)
    assert float((xt @ M - rhs).abs().max()) < 1e-7
