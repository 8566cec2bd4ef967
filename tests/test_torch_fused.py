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
    got = tfused.fused_iterate_shared(*map(torch.from_numpy, ops), **kw)
    ref = tfused.fused_iterate_shared_reference(
        *map(torch.from_numpy, ops), **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert tfused.fused_iterate_shared.launches == before


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
}


def _partition(ranges, extent):
    """The distinct ranges tile [0, extent) without gap or overlap."""
    rs = sorted(set(ranges), key=lambda r: r.start)
    assert rs[0].start == 0 and rs[-1].stop == extent
    for a, b in zip(rs, rs[1:]):
        assert a.stop == b.start
    assert all(len(r) > 0 for r in rs)
    return rs


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_covers_every_output_once(case):
    """Each tiling's tiles are the product of a partition of the lanes,
    one of the matrix rows and one of its columns, each tile once, at
    most one per block: so every output of the rhs and x-tilde products
    (columns) and of the z-tilde product (rows of A) is written by one
    tile of each reduction chunk, and summed once per chunk."""
    B, n, m, _ = PLAN_CASES[case]
    p = tfused.plan(B, n, m, 1, **H100)
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
    # The prox phase: every row in exactly one unit, each SOC block one
    # whole unit.
    units = tfused.prox_units(cone)
    rows = [r for s, d in units for r in range(s, s + d)]
    assert rows == list(range(m))
    soc0 = cone.m_box + cone.m_l1
    d = cone.soc_dims[0] if cone.m_soc else 0
    assert [u for u in units if u[0] >= soc0] == [
        (soc0 + b * d, d) for b in range(cone.n_soc)]


@pytest.mark.parametrize("B", [1, 3, 8, 9, 37, 128, 1024])
def test_plan_regimes(B):
    """Up to SMALL_BATCH lanes the products are GEMV-shaped: one lane per
    register tile and the reduction axis split over the grid (split-K).
    Above it, register tiles of 4 lanes. f64 accumulators up to
    F64_BATCH lanes, f32 above. The flagship matrices stay in shared
    memory."""
    p = tfused.plan(B, 450, 456, 1, **H100)
    small = B <= tfused.SMALL_BATCH
    assert p.lane_tile == (1 if small else 4)
    assert tfused.threads(p.lane_tile) == (512 if small else 256)
    assert p.acc_bytes == tfused.acc_bytes(B) == (
        8 if B <= tfused.F64_BATCH else 4)
    if small:
        assert p.a.row_splits > 1 and p.a.col_splits > 1
        assert p.nn.row_splits > 1
    assert p.a_resident and p.minv_resident
    assert p.a.tiles > p.grid // 2 and p.nn.tiles > p.grid // 2


def test_plan_at_config4_keeps_a_resident_and_streams_the_rest():
    """n=2000: A (17.6 MB) fits the grid's shared memory, M⁻¹ and M do
    not and are streamed from L2."""
    p = tfused.plan(1, 2000, 2206, 1, **H100)
    assert p.a_resident and not p.m_resident
    assert p.a.tiles * p.a.row_chunk * p.a.col_chunk >= 2000 * 2206


def test_plan_refuses_too_little_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        tfused.plan(128, 450, 456, 1, sms=132, smem_bytes=48 * 1024)
