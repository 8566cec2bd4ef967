"""Port parity for the data axis of solve_batch_shared: make_data_mesh,
shard_batch and solve_batch_shared(..., mesh=) of admm_library_torch at
world size 1, against the JAX package's solve_batch_shared on
shard_batch(make_data_mesh(4)) (its shard_map branch, on the virtual CPU
mesh of tests/conftest.py). The same seeded JAX draw feeds both.

Bars. The hybrid pipeline (the default, the main path) at eps 1e-6 and
'double' at eps 1e-8: per-lane status equal, iterations within one check
interval (25), x within 1e-6. f32 'single' through the fused kernel's
twin at eps 1e-5: status, iterations within 25, x within 1e-4 (two f32
points each within the 1e-5 criterion). At world size 1 every
collective is the identity: the solve with a mesh is bitwise the solve
without one. Across ranks see tests/test_torch_sharded_ranks.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_library_tpu import Settings as JSettings
from admm_library_tpu.models import monte_carlo as jmc
from admm_library_tpu.parallel import batch as jbatch
from admm_library_torch import (ConeSpec, Settings, Status, make_data_mesh,
                                qp_from_numpy, shard_batch,
                                solve_batch_shared)
from admm_library_torch.parallel import runtime

torch.set_num_threads(1)

FIELDS = ("P", "q", "A", "l", "u", "lam")
CHECK = 25

CASES = {
    "hybrid_f64": (jnp.float64, dict(eps_abs=1e-6, eps_rel=1e-6), 1e-6),
    "hybrid_f32": (jnp.float32, dict(eps_abs=1e-6, eps_rel=1e-6), 1e-6),
    "double": (jnp.float64, dict(eps_abs=1e-8, eps_rel=1e-8,
                                 precision="double"), 1e-6),
    "single_fused": (jnp.float32, dict(eps_abs=1e-5, eps_rel=1e-5,
                                       precision="single", fused="on",
                                       backend="inv"), 1e-4),
}


def _draw(dtype, batch=16):
    jqp, _, _ = jmc.monte_carlo_mpc(jax.random.key(4), batch=batch, N=6,
                                    dim=2, dtype=dtype)
    cone = ConeSpec(m_box=jqp.cone.m_box)
    qp = qp_from_numpy({f: np.asarray(getattr(jqp, f)) for f in FIELDS},
                       cone, device="cpu")
    return jqp, qp


def _fake_mesh(data, d):
    """Rank d's view of a data mesh of `data` ranks: enough for
    shard_batch, which makes no collective."""
    return runtime.Mesh(shape={"data": data, "horizon": 1},
                        coords={"data": d, "horizon": 0},
                        groups={"data": None, "horizon": None},
                        ranks={"data": tuple(range(data)), "horizon": (0,)},
                        world=1, device=torch.device("cpu"))


def test_make_data_mesh_is_one_rank_here():
    mesh = make_data_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "horizon": 1}
    assert mesh.groups == {"data": None, "horizon": None}
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError):
        make_data_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        make_data_mesh(device="cpu", axis="horizon")


def test_shard_batch_slices_the_lanes_like_jax():
    jqp, qp = _draw(jnp.float64)
    B = qp.l.shape[0]
    x0 = torch.arange(B * qp.n, dtype=torch.float64).reshape(B, qp.n)
    jsh = jbatch.shard_batch(jqp, jbatch.make_data_mesh(4),
                             x0=jnp.asarray(x0.numpy()))
    for d in range(4):
        got, gx, gz, gy = shard_batch(qp, _fake_mesh(4, d), x0=x0)
        lanes = slice(d * B // 4, (d + 1) * B // 4)
        for f in ("l", "u"):
            shard = getattr(jsh[0], f).addressable_shards[d]
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(shard.data))
        for f in ("P", "q", "A", "lam"):       # unbatched: whole
            assert torch.equal(getattr(got, f), getattr(qp, f))
        assert torch.equal(gx, x0[lanes])
        assert gz is None and gy is None
    with pytest.raises(ValueError):
        shard_batch(qp, _fake_mesh(3, 0))


def test_shard_batch_slices_a_per_lane_q():
    _, qp = _draw(jnp.float64, batch=8)
    q = torch.randn((8, qp.n), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    qpq = qp_from_numpy({**{f: getattr(qp, f).numpy() for f in FIELDS},
                         "q": q.numpy()}, qp.cone, device="cpu")
    got, *_ = shard_batch(qpq, _fake_mesh(2, 1))
    assert torch.equal(got.q, q[4:])


@pytest.mark.parametrize("case", list(CASES))
def test_data_axis_matches_jax_sharded(case):
    dtype, kw, x_tol = CASES[case]
    jqp, qp = _draw(dtype)
    jqs, *_ = jbatch.shard_batch(jqp, jbatch.make_data_mesh(4))
    jsol = jbatch.solve_batch_shared(jqs, JSettings(**kw))
    mesh = make_data_mesh(device="cpu")
    qs, *_ = shard_batch(qp, mesh)
    sol = solve_batch_shared(qs, Settings(**kw), mesh=mesh)
    assert torch.all(sol.status == int(Status.SOLVED))
    np.testing.assert_array_equal(sol.status.numpy(),
                                  np.asarray(jsol.status))
    assert np.max(np.abs(sol.iters.numpy() - np.asarray(jsol.iters))) \
        <= CHECK
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(jsol.x), rtol=0,
                               atol=x_tol)
    # World size 1: every collective is the identity.
    alone = solve_batch_shared(qp, Settings(**kw))
    for f in ("x", "z", "y", "status", "iters", "r_prim", "r_dual"):
        assert torch.equal(getattr(sol, f), getattr(alone, f)), f
