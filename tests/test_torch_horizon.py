"""Port parity for the horizon-sharded SPIKE driver: partition_qp and
solve_horizon_sharded of admm_library_torch against the JAX package's
(the cases of tests/test_horizon.py, JAX on its (data=2, horizon=4)
virtual CPU mesh), and against the port's own solve_batch_shared with
the same plain settings. The port runs in one process (a 1x1 mesh);
across ranks see tests/test_torch_sharded_ranks.py.

Bars. partition_qp is host f64 numpy in both: bitwise. f64 solves:
per-scenario status and iterations equal, x within 1e-8·(1 + ‖x‖∞)
(the reference test's bar; the separator solve and the products round
in another order). The f32 case at eps 1e-4: statuses equal and
iterations within one check interval (25).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_library_tpu import Settings as JSettings
from admm_library_tpu.models import monte_carlo as jmc
from admm_library_tpu.models.clohessy_wiltshire import (
    build_cw_rendezvous_sparse, cw_sparse_bounds_for_s0)
from admm_library_tpu.models.double_integrator import MPCSpec
from admm_library_tpu.models.low_thrust import (build_low_thrust_socp,
                                                lt_bounds_for_s0)
from admm_library_tpu.parallel import horizon as jhorizon
from admm_library_tpu.parallel.runtime import make_mesh as jmake_mesh
from admm_library_tpu.problem import QPData as JQPData
from admm_library_torch import (ConeSpec, Settings, Status, qp_from_numpy,
                                solve_batch_shared)
from admm_library_torch.parallel import horizon, runtime

torch.set_num_threads(1)

PLAIN = dict(eps_abs=1e-6, eps_rel=1e-6, precision="double",
             scaling_iters=0, restart_every=0, stall_checks=0,
             polish=False, eps_pinf=0.0, eps_dinf=0.0)
FIELDS = ("P", "q", "A", "l", "u", "lam")
X_RTOL = 1e-8
CHECK = 25


def _port(jqp):
    cone = ConeSpec(m_box=jqp.cone.m_box, m_l1=jqp.cone.m_l1,
                    soc_dims=tuple(jqp.cone.soc_dims))
    return qp_from_numpy({f: np.asarray(getattr(jqp, f)) for f in FIELDS},
                         cone, device="cpu")


def _mpc(batch=4, N=8, dim=2, dtype=jnp.float64):
    jqp, _, _ = jmc.monte_carlo_mpc(jax.random.PRNGKey(0), batch=batch,
                                    N=N, dim=dim, dtype=dtype)
    mspec = MPCSpec(N=N, dim=dim, dt=1.0)
    return jqp, mspec.block, 4, jhorizon.mpc_row_time(N, mspec.ns,
                                                      mspec.nu)


def _cw():
    N = 8
    s0 = np.array([5.0, -3.0, 1.0, 0.01, 0.02, -0.01])
    qp1, spec = build_cw_rendezvous_sparse(s0, N=N, dt=600.0, lam=0.1,
                                           dtype=jnp.float64)
    s0s = s0 + 0.1 * np.random.default_rng(3).standard_normal((4, 6))
    l, u = cw_sparse_bounds_for_s0(qp1, spec, s0s)
    jqp = JQPData(P=qp1.P, q=qp1.q, A=qp1.A, l=l, u=u, lam=qp1.lam,
                  cone=qp1.cone)
    return jqp, 9, 4, jhorizon.cw_sparse_row_time(N)


def _lt():
    N = 8
    s0 = np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1])
    qp1, spec = build_low_thrust_socp(s0, N=N, dt=600.0, dtype=jnp.float64)
    s0s = s0 + (np.array([20, 20, 5, 0.01, 0.01, 0.01])
                * np.random.default_rng(5).standard_normal((2, 6)))
    l, u = lt_bounds_for_s0(qp1, spec, s0s)
    jqp = JQPData(P=qp1.P, q=qp1.q, A=qp1.A, l=l, u=u, lam=qp1.lam,
                  cone=qp1.cone)
    return jqp, spec.block, 4, jhorizon.lt_row_time(N)


# (builder, JAX mesh (data, horizon), extra settings)
CASES = {"mpc": (_mpc, (2, 4), {}), "cw_l1": (_cw, (2, 4), {}),
         "lt_soc": (_lt, (1, 4), dict(max_iter=40000))}


def _both_parts(make):
    jqp, b, parts, row_time = make()
    jhp, jspec = jhorizon.partition_qp(jqp, b, parts, row_time)
    qp = _port(jqp)
    hp, spec = horizon.partition_qp(qp, b, parts, row_time)
    return jqp, jhp, jspec, qp, hp, spec


@pytest.mark.parametrize("case", list(CASES))
def test_partition_qp_bitwise(case):
    _, jhp, jspec, qp, hp, spec = _both_parts(CASES[case][0])
    assert (spec.parts, spec.b, spec.npb, spec.mp) == (
        jspec.parts, jspec.b, jspec.npb, jspec.mp)
    assert (spec.cone.m_box, spec.cone.m_l1, spec.cone.soc_dims) == (
        jspec.cone.m_box, jspec.cone.m_l1, tuple(jspec.cone.soc_dims))
    for f in horizon.HorizonParts._fields:
        got = getattr(hp, f)
        assert got.dtype == qp.dtype and got.device == qp.device
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jhp,
                                                                      f)))


def test_partition_qp_rejects_what_the_reference_rejects():
    jqp, b, _, row_time = _mpc()
    qp = _port(jqp)
    for parts in (3, 8):      # 8 blocks: not divisible by 3; 1 block a part
        with pytest.raises(ValueError):
            jhorizon.partition_qp(jqp, b, parts, row_time)
        with pytest.raises(ValueError):
            horizon.partition_qp(qp, b, parts, row_time)
    P = qp.P.numpy().copy()
    P[0, 1] = P[1, 0] = 0.5                 # not the MPC family's P
    dense = qp_from_numpy({**{f: getattr(qp, f).numpy() for f in FIELDS},
                           "P": P}, qp.cone, device="cpu")
    with pytest.raises(ValueError):
        horizon.partition_qp(dense, b, 4, row_time)


def _x_gap(x_h, x_r):
    return float(np.max(np.abs(x_h - x_r))) / (1.0 + float(np.max(
        np.abs(x_r))))


@pytest.mark.parametrize("case", list(CASES))
def test_horizon_matches_jax_and_solve_batch_shared(case):
    make, (jd, jh), extra = CASES[case]
    jqp, jhp, jspec, qp, hp, spec = _both_parts(make)
    settings = Settings(**PLAIN).replace(**extra)
    jsol = jhorizon.solve_horizon_sharded(
        jhp, jspec, jmake_mesh(data=jd, horizon=jh,
                               devices=jax.devices()[:jd * jh]),
        JSettings(**PLAIN).replace(**extra))
    sol = horizon.solve_horizon_sharded(hp, spec,
                                        runtime.make_mesh(device="cpu"),
                                        settings)
    B = qp.l.shape[0]
    assert sol.x.shape == (B, spec.parts, spec.npb)
    assert torch.all(sol.status == int(Status.SOLVED))
    np.testing.assert_array_equal(sol.status.numpy(),
                                  np.asarray(jsol.status))
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(jsol.iters))
    assert _x_gap(sol.x.numpy(), np.asarray(jsol.x)) < X_RTOL
    # The port's own unpartitioned solver, Cholesky backend.
    ref = solve_batch_shared(qp, settings.replace(backend="chol"))
    assert torch.equal(ref.status, sol.status)
    assert torch.equal(ref.iters, sol.iters)
    assert _x_gap(sol.x.reshape(B, -1).numpy(), ref.x.numpy()) < X_RTOL


def test_horizon_f32_matches_jax():
    """f32 at a relaxed tolerance (the reference's test_horizon_f32)."""
    jqp, b, parts, row_time = _mpc(batch=2)
    jhp, jspec = jhorizon.partition_qp(jqp, b, parts, row_time)
    hp, spec = horizon.partition_qp(_port(jqp), b, parts, row_time)
    kw = dict(PLAIN, precision="single", eps_abs=1e-4, eps_rel=1e-4)
    jsol = jhorizon.solve_horizon_sharded(
        jhp, jspec, jmake_mesh(data=1, horizon=2,
                               devices=jax.devices()[:2]), JSettings(**kw))
    sol = horizon.solve_horizon_sharded(hp, spec,
                                        runtime.make_mesh(device="cpu"),
                                        Settings(**kw))
    assert sol.x.dtype == torch.float32
    assert torch.all(sol.status == int(Status.SOLVED))
    np.testing.assert_array_equal(sol.status.numpy(),
                                  np.asarray(jsol.status))
    assert np.max(np.abs(sol.iters.numpy() - np.asarray(jsol.iters))) \
        <= CHECK
    assert float(sol.r_prim.max()) < 1e-3


def test_horizon_rejects_an_unbatched_problem_and_a_bad_split():
    jqp, b, parts, row_time = _mpc()
    qp = _port(jqp)
    one = qp_from_numpy({**{f: getattr(qp, f).numpy() for f in FIELDS},
                         "l": qp.l[0].numpy(), "u": qp.u[0].numpy()},
                        qp.cone, device="cpu")
    hp1, spec1 = horizon.partition_qp(one, b, parts, row_time)
    mesh = runtime.make_mesh(device="cpu")
    with pytest.raises(ValueError):
        horizon.solve_horizon_sharded(hp1, spec1, mesh, Settings(**PLAIN))
    hp, spec = horizon.partition_qp(qp, b, parts, row_time)
    wide = runtime.Mesh(shape={"data": 3, "horizon": 1},
                        coords={"data": 0, "horizon": 0},
                        groups={"data": None, "horizon": None},
                        ranks={"data": (0, 1, 2), "horizon": (0,)},
                        world=1, device=torch.device("cpu"))
    with pytest.raises(ValueError):
        horizon.solve_horizon_sharded(hp, spec, wide, Settings(**PLAIN))
