"""Port parity for the fused ADMM iteration: the plain PyTorch twin
against the JAX Pallas kernel (interpret mode, as tests/test_fused.py
runs it), the CPU dispatch of the wrapper, and the port's import
boundary. The CUDA kernel itself is tested in test_torch_gpu.py.

The scaled problem and the factor are computed once by the JAX package
and carried across with numpy, so both sides iterate on identical f32
inputs; tolerances are those of tests/test_fused.py.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_library_tpu import Settings as JSettings
from admm_library_tpu.core import admm as jadmm
from admm_library_tpu.core.scaling import ruiz_equilibrate
from admm_library_tpu.models import monte_carlo as jmc
from admm_library_tpu.ops import fused as jfused, kkt as jkkt
from admm_library_tpu.problem import ConeSpec as JCone, QPData as JQP
from admm_library_torch.ops import fused as tfused
from admm_library_torch.problem import ConeSpec as TCone

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Small shapes: one intra-op thread keeps the CPU free for the other
# test workers.
torch.set_num_threads(1)


def _operands(qp, settings, x, z, y):
    """JAX Ruiz + rho + 'inv' factor; returns the kernel's operands as
    numpy arrays, in the wrapper's argument order."""
    qps, _ = ruiz_equilibrate(qp, settings.scaling_iters)
    eq = jadmm.is_equality_row_shared(qps)
    rho = jadmm.rho_vec_of(jnp.asarray(settings.rho, qps.dtype), eq,
                           settings)
    fac = jkkt.factor_condensed(qps.P, qps.A, settings.sigma, rho, "inv")
    arrs = (qps.A, fac["Minv"], fac["M"], qps.q, rho, qps.lam, qps.l,
            qps.u, x, z, y)
    return qps.cone, [np.array(a, np.float32) for a in arrs]


def _box_case():
    settings = JSettings(precision="single", refine_steps=1)
    qp, _, _ = jmc.monte_carlo_mpc(jax.random.key(0), batch=4, N=6, dim=2,
                                   dtype=jnp.float32)
    B = 4
    zero = lambda w: jnp.zeros((B, w), jnp.float32)  # noqa: E731
    cone, ops = _operands(qp, settings, zero(qp.n), zero(qp.m), zero(qp.m))
    return settings, cone, ops, 10, (1e-5, 1e-6)


def _l1_soc_case():
    """Mixed cone: box + bounded L1 + uniform SOC blocks."""
    rng = np.random.default_rng(3)
    n, mb, ml, nsoc, d = 20, 8, 6, 3, 4
    m = mb + ml + nsoc * d
    cone = JCone(m_box=mb, m_l1=ml, soc_dims=(d,) * nsoc)
    A = jnp.asarray(rng.standard_normal((m, n)) / np.sqrt(n), jnp.float32)
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    P = jnp.asarray(R @ R.T + 0.5 * np.eye(n), jnp.float32)
    q = jnp.asarray(rng.standard_normal(n), jnp.float32)
    l = np.full(m, -np.inf)
    u = np.full(m, np.inf)
    l[:mb], u[:mb] = -1.0, 1.0
    l[mb:mb + ml], u[mb:mb + ml] = -0.7, 0.7
    qp = JQP(P=P, q=q, A=A, l=jnp.asarray(l, jnp.float32),
             u=jnp.asarray(u, jnp.float32),
             lam=jnp.full((ml,), 0.3, jnp.float32), cone=cone)
    settings = JSettings(precision="single", refine_steps=1)
    B = 3
    x = jax.random.normal(jax.random.key(1), (B, n), jnp.float32)
    z = jnp.zeros((B, m), jnp.float32)
    _, ops = _operands(qp, settings, x, z, jnp.zeros((B, m), jnp.float32))
    return settings, cone, ops, 7, (1e-4, 1e-5)


def _tcone(c):
    return TCone(m_box=c.m_box, m_l1=c.m_l1, soc_dims=c.soc_dims)


def _kw(settings, cone, k):
    return dict(cone=cone, sigma=settings.sigma, alpha=settings.alpha, k=k,
                refine_steps=settings.refine_steps)


@pytest.mark.parametrize("case", [_box_case, _l1_soc_case],
                         ids=["box", "l1_soc"])
def test_twin_matches_pallas_interpret(case):
    settings, cone, ops, k, (rtol, atol) = case()
    ref = jfused.fused_iterate_shared(
        *map(jnp.asarray, ops), **_kw(settings, cone, k), interpret=True)
    got = tfused.fused_iterate_shared_reference(
        *map(torch.from_numpy, ops), **_kw(settings, _tcone(cone), k))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("case", [_box_case, _l1_soc_case],
                         ids=["box", "l1_soc"])
def test_wrapper_on_cpu_is_the_twin(case):
    settings, cone, ops, k, _ = case()
    kw = _kw(settings, _tcone(cone), k)
    before = tfused.fused_iterate_shared.launches
    by_design = dict(tfused.fused_iterate_shared.calls_by_design)
    got = tfused.fused_iterate_shared(*map(torch.from_numpy, ops), **kw)
    ref = tfused.fused_iterate_shared_reference(
        *map(torch.from_numpy, ops), **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert tfused.fused_iterate_shared.launches == before
    assert tfused.fused_iterate_shared.calls_by_design == by_design


def test_wrapper_rejects_ragged_soc():
    settings, cone, ops, k, _ = _l1_soc_case()
    ragged = TCone(m_box=cone.m_box, m_l1=cone.m_l1, soc_dims=(3, 4, 5))
    with pytest.raises(ValueError, match="uniform SOC"):
        tfused.fused_iterate_shared(*map(torch.from_numpy, ops),
                                    **_kw(settings, ragged, k))


def test_import_leaves_jax_out():
    code = ("import sys, admm_library_torch, admm_library_torch.ops.fused, "
            "admm_library_torch.parallel.batch, "
            "admm_library_torch.models.monte_carlo, "
            "admm_library_torch.utils.oracle; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'admm_library_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---- the CUDA kernel's partition (ops/fused.plan), checked on the CPU ----

H100 = dict(sms=132, smem_bytes=232448)

# (B, n, m, cone): the main path's shapes (config 4 at B=1; config 5 at
# B=128 and 1024; config 2, 1 and 3's shapes through solve at B=1) and
# small, odd and mixed-cone cases either side of the small-batch
# threshold.
PLAN_CASES = {
    "config4_b1": (1, 2000, 2206, TCone(m_box=1406, soc_dims=(4,) * 200)),
    "config5_b128": (128, 450, 456, TCone(m_box=456)),
    "config5_b1024": (1024, 450, 456, TCone(m_box=456)),
    "config2_b1": (1, 450, 456, TCone(m_box=456)),
    "config1_b1": (1, 100, 200, TCone(m_box=200)),
    "config3_b1": (1, 60, 66, TCone(m_box=6, m_l1=60)),
    "l1_soc_b3": (3, 20, 26, TCone(m_box=8, m_l1=6, soc_dims=(4,) * 3)),
    "l1_soc_b9": (9, 20, 26, TCone(m_box=8, m_l1=6, soc_dims=(4,) * 3)),
    "odd_b8": (8, 7, 13, TCone(m_box=4, soc_dims=(3,) * 3)),
    "odd_b37": (37, 81, 101, TCone(m_box=2, m_l1=3, soc_dims=(3,) * 32)),
    "config5_b257": (257, 450, 456, TCone(m_box=456)),
    "odd_b300": (300, 81, 101, TCone(m_box=2, m_l1=3, soc_dims=(3,) * 32)),
}


def _partition(ranges, extent):
    """The distinct ranges tile [0, extent) without gap or overlap."""
    rs = sorted(set(ranges), key=lambda r: r.start)
    assert rs[0].start == 0 and rs[-1].stop == extent
    for a, b in zip(rs, rs[1:]):
        assert a.stop == b.start
    assert all(len(r) > 0 for r in rs)
    return rs


def _cluster_outputs(p, B, width, cols):
    """(lane, column) of every output a block of the cluster plan p
    writes in a product `width` columns wide, block by block."""
    out = []
    for blk in range(p.grid):
        g, rank = divmod(blk, p.cluster)
        b0, b1 = g * p.lanes, min(B, (g + 1) * p.lanes)
        c0 = min(width, rank * cols)
        c1 = min(width, c0 + cols)
        for lb in range(b0, b1, tfused.CLUSTER_LANES):
            for ct in range(c0, c1, tfused.CLUSTER_COLS):
                out += [(b, c)
                        for b in range(lb, min(b1, lb + tfused.CLUSTER_LANES))
                        for c in range(ct, min(c1, ct + tfused.CLUSTER_COLS))]
    return out


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_covers_every_output_once(case):
    """Split design: each tiling's tiles are the product of a partition
    of the lanes, one of the matrix rows and one of its columns, each
    tile once, at most one per block: so every output of the rhs and
    x-tilde products (columns) and of the z-tilde product (rows of A) is
    written by one tile of each reduction chunk, and summed once per
    chunk. Cluster design: every output of the n-wide products and of
    the z-tilde product is written by exactly one tile of one block, over
    the whole reduction axis; the clusters own disjoint lanes."""
    B, n, m, _ = PLAN_CASES[case]
    p = tfused.plan(B, n, m, 1, **H100)
    if p.design == "cluster":
        for width, cols in ((n, p.cols_n), (m, p.cols_m)):
            outs = _cluster_outputs(p, B, width, cols)
            assert len(outs) == len(set(outs)) == B * width
        assert p.grid % p.cluster == 0
        assert (p.grid // p.cluster - 1) * p.lanes < B <= \
            p.grid // p.cluster * p.lanes
        # Tile columns start on 16 bytes (the bulk copies' boxes).
        assert p.cols_n % 4 == p.cols_m % 4 == 0
        return
    for t, rows, cols in ((p.a, m, n), (p.nn, n, n)):
        assert t.tiles <= p.grid
        tiles = [t.tile(i, B, rows, cols) for i in range(t.tiles)]
        assert len({(a.start, b.start, c.start) for a, b, c in tiles}) \
            == t.tiles
        lanes = _partition([a for a, _, _ in tiles], B)
        rws = _partition([b for _, b, _ in tiles], rows)
        cls = _partition([c for _, _, c in tiles], cols)
        assert len(lanes) * len(rws) * len(cls) == t.tiles
        assert (len(lanes), len(rws), len(cls)) == (
            t.lane_groups, t.row_splits, t.col_splits)
        # Chunks start on 16-byte boundaries (float4 loads of a row).
        assert all(r.start % 4 == 0 for r in rws + cls)


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_fits_shared_memory_and_keeps_soc_blocks_whole(case):
    B, n, m, cone = PLAN_CASES[case]
    assert cone.m == m
    p = tfused.plan(B, n, m, 1, **H100)
    if p.design == "cluster":
        _cluster_plan_fits(p, n, m)
    else:
        _split_plan_fits(p)
    # The prox phase: every row in exactly one unit, each SOC block one
    # whole unit.
    units = tfused.prox_units(cone)
    rows = [r for s, d in units for r in range(s, s + d)]
    assert rows == list(range(m))
    soc0 = cone.m_box + cone.m_l1
    d = cone.soc_dims[0] if cone.m_soc else 0
    assert [u for u in units if u[0] >= soc0] == [
        (soc0 + b * d, d) for b in range(cone.n_soc)]


def _cluster_plan_fits(p, n, m):
    """Within the card's shared memory and the portable cluster sizes,
    one wave of clusters, scratch and matrix rows of 16 bytes, and each
    block's columns within one or more whole tiles."""
    assert p.smem_bytes == tfused.cluster_smem_bytes() <= H100["smem_bytes"]
    assert 1 <= p.cluster <= tfused.CLUSTER_MAX
    assert p.grid // p.cluster <= H100["sms"] // p.cluster
    assert p.threads == 64 * tfused.CLUSTER_GROUPS + 32 <= 1024
    assert p.ld_n >= n and p.ld_m >= m and p.ld_n % 4 == p.ld_m % 4 == 0
    assert p.cols_n * p.cluster >= n and p.cols_m * p.cluster >= m
    assert len(p.as_ints()) == 9


def _split_plan_fits(p):
    offs, floats = p.offsets()
    assert p.smem_bytes == 4 * floats <= H100["smem_bytes"]
    assert offs == sorted(offs) and all(o % 4 == 0 for o in offs)
    # Tiles in shared memory hold a whole chunk in rows of ld floats.
    assert p.ld_a >= p.a.col_chunk and p.ld_nn >= p.nn.col_chunk
    assert p.ld_a % 4 == p.ld_nn % 4 == p.ld_left % 4 == 0
    assert offs[1] - offs[0] == (p.a.row_chunk * p.ld_a if p.a_resident
                                 else 0)
    assert p.m_resident <= p.minv_resident
    assert p.ld_left >= max(p.a.row_chunk, p.a.col_chunk, p.nn.row_chunk)
    assert p.lane_chunk % p.lane_tile == 0 and p.lane_chunk >= p.lane_tile
    assert 4 * p.lane_chunk * p.ld_left <= tfused.LEFT_BYTES


@pytest.mark.parametrize("B", [1, 3, 8, 9, 37, 128, 257, 1024])
def test_plan_regimes(B):
    """Up to F64_BATCH lanes the split design: up to SMALL_BATCH lanes
    the products are GEMV-shaped, one lane per register tile and the
    reduction axis split over the grid (split-K); above it, register
    tiles of 4 lanes; f64 accumulators; the flagship matrices stay in
    shared memory. Above F64_BATCH the cluster design: clusters of 8
    blocks own their lanes, one 64-column tile a block."""
    p = tfused.plan(B, 450, 456, 1, **H100)
    if B > tfused.F64_BATCH:
        assert p.design == "cluster" and isinstance(p, tfused.ClusterPlan)
        assert p.cluster == 8 and p.cols_n <= tfused.CLUSTER_COLS
        assert p.cols_m <= tfused.CLUSTER_COLS
        assert p.lanes <= tfused.CLUSTER_LANES
        return
    assert p.design == "split" and isinstance(p, tfused.Plan)
    small = B <= tfused.SMALL_BATCH
    assert p.lane_tile == (1 if small else 4)
    assert tfused.threads(p.lane_tile) == (512 if small else 256)
    # f64 accumulators: 4 of 8 bytes for each lane of a register tile.
    offs, floats = p.offsets()
    assert tfused.ACC_BYTES == 8
    assert 4 * (floats - offs[-1]) == (
        tfused.threads(p.lane_tile) * p.lane_tile * 4 * 8)
    if small:
        assert p.a.row_splits > 1 and p.a.col_splits > 1
        assert p.nn.row_splits > 1
    assert p.a_resident and p.minv_resident
    assert p.a.tiles > p.grid // 2 and p.nn.tiles > p.grid // 2


# The split design's plans at the main path's shapes (B=1: config 2
# through solve and config 4; config 5 at B=128), pinned: work on the
# cluster design leaves them be.
SPLIT_PLANS = {
    (1, 450, 456): [132, 1, 1, 512, 41200, 1, 1, 1, 52, 28, 76, 0, 1872,
                    4000, 6128, 6204, 1, 1, 13, 36, 10, 48, 1, 1, 6, 76,
                    19, 24],
    (128, 450, 456): [132, 4, 16, 256, 210624, 1, 1, 1, 116, 60, 228, 0,
                      13456, 27136, 40816, 44464, 8, 16, 4, 116, 4, 116, 8,
                      16, 2, 228, 8, 60],
    (1, 2000, 2206): [132, 1, 1, 512, 156112, 1, 0, 0, 188, 92, 340, 0,
                      34592, 34592, 34592, 34932, 1, 1, 12, 184, 11, 184, 1,
                      1, 6, 336, 22, 92],
}


@pytest.mark.parametrize("shape", sorted(SPLIT_PLANS))
def test_split_plans_are_pinned(shape):
    p = tfused.plan(*shape, 1, **H100, max_clusters=15)
    assert p.design == "split"
    assert p.as_ints() == SPLIT_PLANS[shape]


@pytest.mark.parametrize("clusters,grid,lanes", [(15, 120, 69),
                                                 (16, 120, 69),
                                                 (10, 80, 103),
                                                 (4, 32, 256)])
def test_cluster_plan_fills_one_wave_of_the_card(clusters, grid, lanes):
    """B=1024 at the flagship shape on a card that holds `clusters`
    clusters of 8 at once (the H100 80GB HBM3: 15): one wave of at most
    ⌈B / CLUSTER_LANES⌉ clusters, the lanes spread evenly; where a
    cluster's lanes pass one tile it runs several tiles."""
    p = tfused.plan(1024, 450, 456, 1, **H100, max_clusters=clusters)
    assert (p.grid, p.lanes) == (grid, lanes)
    assert p.grid // p.cluster <= clusters
    assert _cluster_outputs(p, 1024, 450, p.cols_n) and len(set(
        _cluster_outputs(p, 1024, 456, p.cols_m))) == 1024 * 456


def test_cluster_plan_refuses_a_card_without_room():
    with pytest.raises(ValueError, match="cluster"):
        tfused.plan(1024, 450, 456, 1, **H100, max_clusters=0)
    with pytest.raises(ValueError, match="shared memory"):
        tfused.plan(1024, 450, 456, 1, sms=132, smem_bytes=100 * 1024)


def test_design_counters_sit_beside_the_launch_count():
    """The wrapper counts its calls by design beside the launch count,
    one count for each design the planner chooses."""
    kernel = tfused.fused_iterate_shared
    assert isinstance(kernel.launches, int)
    assert set(kernel.calls_by_design) == {"split", "cluster"} == {
        tfused.plan(B, 450, 456, 1, **H100).design for B in (128, 1024)}


def test_plan_at_config4_keeps_a_resident_and_streams_the_rest():
    """n=2000: A (17.6 MB) fits the grid's shared memory, M⁻¹ and M do
    not and are streamed from L2."""
    p = tfused.plan(1, 2000, 2206, 1, **H100)
    assert p.a_resident and not p.m_resident
    assert p.a.tiles * p.a.row_chunk * p.a.col_chunk >= 2000 * 2206


def test_plan_refuses_too_little_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        tfused.plan(128, 450, 456, 1, sms=132, smem_bytes=48 * 1024)
