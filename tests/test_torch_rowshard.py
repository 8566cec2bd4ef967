"""Port parity for the row-sharded single-problem driver: solve_rowsharded
and solve_rowsharded_hybrid of admm_library_torch against the JAX
package's on its 8-device virtual CPU mesh (the cases of
tests/test_rowshard.py), the port in one process on a 1-rank data mesh.

Bars. f64 solves: the same status and iterations, x within 1e-8 (the
two packages sum the row shards' products in another order, and the CG
stops at 1e-9). The hybrid path on f32 input: SOLVED, the f64 residuals
within 1e-5 (the reference test's bar), x within 1e-4 of JAX's (two
points each within the 1e-6 mixed criterion). The row permutation:
equal. Across ranks see tests/test_torch_sharded_ranks.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_library_tpu import Settings as JSettings
from admm_library_tpu.models.random_qp import random_box_qp as jrandom_box_qp
from admm_library_tpu.parallel import rowshard as jrowshard
from admm_library_tpu.parallel.batch import make_data_mesh as jmake_data_mesh
from admm_library_tpu.problem import ConeSpec as JConeSpec
from admm_library_tpu.problem import QPData as JQPData
from admm_library_torch import ConeSpec, Settings, Status, qp_from_numpy
from admm_library_torch.parallel import rowshard, runtime
from admm_library_torch.parallel.batch import make_data_mesh

torch.set_num_threads(1)

X_ATOL = 1e-8
FIELDS = ("P", "q", "A", "l", "u", "lam")


def _port(jqp):
    """The port's QPData of a JAX QPData: the same numbers, on the CPU."""
    cone = ConeSpec(m_box=jqp.cone.m_box, m_l1=jqp.cone.m_l1,
                    soc_dims=tuple(jqp.cone.soc_dims))
    return qp_from_numpy({f: np.asarray(getattr(jqp, f)) for f in FIELDS},
                         cone, device="cpu")


def _mesh():
    return make_data_mesh(device="cpu")


def _jqp(P, q, A, l, u, lam, cone):
    f = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
    return JQPData(P=f(P), q=f(q), A=f(A), l=f(l), u=f(u), lam=f(lam),
                   cone=cone)


def _box():
    return jrandom_box_qp(jax.random.key(21), n=32, m=64, dtype=jnp.float64)


def _l1():
    rng = np.random.default_rng(5)
    n, m_box, m_l1 = 24, 32, 16
    A = rng.standard_normal((m_box + m_l1, n))
    l = np.concatenate([np.full(m_box, -2.0), np.full(m_l1, -np.inf)])
    return _jqp(np.eye(n) * 0.5, rng.standard_normal(n), A, l, -l,
                np.full(m_l1, 0.3), JConeSpec(m_box=m_box, m_l1=m_l1))


def _soc():
    rng = np.random.default_rng(7)
    ndev, d, n, m_box = 8, 4, 24, 16
    m_soc = ndev * d
    A = rng.standard_normal((m_box + m_soc, n)) * 0.5
    l = np.concatenate([np.full(m_box, -3.0), np.full(m_soc, -np.inf)])
    u = np.concatenate([np.full(m_box, 3.0), np.full(m_soc, np.inf)])
    return _jqp(np.eye(n), rng.standard_normal(n), A, l, u, np.zeros(0),
                JConeSpec(m_box=m_box, soc_dims=(d,) * ndev))


CASES = {
    "box": (_box, dict(eps_abs=1e-8, eps_rel=1e-8, precision="single",
                       adaptive_rho=False)),
    "l1": (_l1, dict(eps_abs=1e-8, eps_rel=1e-8, precision="single")),
    "soc": (_soc, dict(eps_abs=1e-7, eps_rel=1e-7, precision="single",
                       max_iter=50000)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rowsharded_matches_jax(case):
    make, kw = CASES[case]
    jqp = make()
    jsol = jrowshard.solve_rowsharded(jqp, jmake_data_mesh(8),
                                      JSettings(**kw))
    sol = rowshard.solve_rowsharded(_port(jqp), _mesh(), Settings(**kw))
    assert int(jsol.status) == int(Status.SOLVED)
    assert int(sol.status) == int(jsol.status)
    assert int(sol.iters) == int(jsol.iters)
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(jsol.x), rtol=0,
                               atol=X_ATOL)
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(jsol.z), rtol=0,
                               atol=X_ATOL)
    # The CG steps are counted, at most cg_max_iter per x-update.
    assert 0 < int(sol.cg_steps) <= int(sol.iters) * 200


def test_rowsharded_rejects_straddling_soc():
    """SOC blocks that cannot be dealt evenly over 8 row shards: both
    packages refuse the layout, the port before any collective."""
    cone = ConeSpec(m_box=6, soc_dims=(5, 5))
    with pytest.raises(ValueError):
        jrowshard.uniform_row_permutation(
            JConeSpec(m_box=6, soc_dims=(5, 5)), 16, 8)
    with pytest.raises(ValueError):
        rowshard.uniform_row_permutation(cone, 16, 8)
    n = m = 16
    qp = qp_from_numpy({"P": np.eye(n), "q": np.zeros(n), "A": np.eye(m, n),
                        "l": np.full(m, -np.inf), "u": np.full(m, np.inf),
                        "lam": np.zeros(0)}, cone, device="cpu")
    wide = runtime.Mesh(shape={"data": 8, "horizon": 1},
                        coords={"data": 0, "horizon": 0},
                        groups={"data": None, "horizon": None},
                        ranks={"data": tuple(range(8)), "horizon": (0,)},
                        world=1, device=torch.device("cpu"))
    with pytest.raises(ValueError):
        rowshard.solve_rowsharded(qp, wide, Settings())


_PERM_CONES = [JConeSpec(m_box=16), JConeSpec(m_box=8, m_l1=8),
               JConeSpec(m_box=8, soc_dims=(4,) * 4),
               JConeSpec(m_box=16, m_l1=8, soc_dims=(3,) * 8),
               JConeSpec(m_l1=8, soc_dims=(2,) * 4)]


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("jcone", _PERM_CONES,
                         ids=lambda c: f"b{c.m_box}_l{c.m_l1}_s{c.m_soc}")
def test_uniform_row_permutation_matches_jax(jcone, ndev):
    cone = ConeSpec(m_box=jcone.m_box, m_l1=jcone.m_l1,
                    soc_dims=tuple(jcone.soc_dims))
    m = jcone.m_box + jcone.m_l1 + jcone.m_soc
    try:
        jperm, jloc = jrowshard.uniform_row_permutation(jcone, m, ndev)
    except ValueError:
        with pytest.raises(ValueError):
            rowshard.uniform_row_permutation(cone, m, ndev)
        return
    perm, loc = rowshard.uniform_row_permutation(cone, m, ndev)
    assert (perm is None) == (jperm is None)
    if perm is not None:
        np.testing.assert_array_equal(perm, jperm)
        assert sorted(perm.tolist()) == list(range(m))
    assert (loc.m_box, loc.m_l1, loc.soc_dims) == (
        jloc.m_box, jloc.m_l1, tuple(jloc.soc_dims))


def test_rowsharded_warm_start_matches_jax():
    jqp = jrandom_box_qp(jax.random.key(22), n=32, m=64, dtype=jnp.float64)
    kw = dict(eps_abs=1e-8, eps_rel=1e-8, precision="single")
    mesh, jmesh = _mesh(), jmake_data_mesh(8)
    qp = _port(jqp)
    cold = rowshard.solve_rowsharded(qp, mesh, Settings(**kw))
    warm = rowshard.solve_rowsharded(qp, mesh, Settings(**kw), x0=cold.x,
                                     z0=cold.z, y0=cold.y)
    jcold = jrowshard.solve_rowsharded(jqp, jmesh, JSettings(**kw))
    jwarm = jrowshard.solve_rowsharded(jqp, jmesh, JSettings(**kw),
                                       x0=jcold.x, z0=jcold.z, y0=jcold.y)
    assert int(warm.status) == int(Status.SOLVED)
    assert int(warm.iters) <= max(int(cold.iters) // 4, 25)
    assert int(warm.iters) == int(jwarm.iters)
    np.testing.assert_allclose(warm.x.numpy(), np.asarray(jwarm.x), rtol=0,
                               atol=X_ATOL)


def _primal_infeasible():
    n = 8
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((8, n))
    # Rows i and i+8 share a'x but demand a'x <= -1 and a'x >= 1.
    l = np.concatenate([np.full(8, -np.inf), np.full(8, 1.0)])
    u = np.concatenate([np.full(8, -1.0), np.full(8, np.inf)])
    return _jqp(np.eye(n), np.zeros(n), np.vstack([rows, rows]), l, u,
                np.zeros(0), JConeSpec(m_box=16))


def _dual_infeasible():
    n, m = 8, 16
    A = np.eye(m, n)
    A[8:] = np.eye(8, n)
    return _jqp(np.zeros((n, n)), -np.ones(n), A, np.zeros(m),
                np.full(m, np.inf), np.zeros(0), JConeSpec(m_box=m))


@pytest.mark.parametrize("make,expect", [
    (_primal_infeasible, Status.PRIMAL_INFEASIBLE),
    (_dual_infeasible, Status.DUAL_INFEASIBLE)], ids=["primal", "dual"])
def test_rowsharded_infeasible_matches_jax(make, expect):
    jqp = make()
    jsol = jrowshard.solve_rowsharded(jqp, jmake_data_mesh(8),
                                      JSettings(precision="single"))
    sol = rowshard.solve_rowsharded(_port(jqp), _mesh(),
                                    Settings(precision="single"))
    assert int(jsol.status) == int(expect)
    assert int(sol.status) == int(expect)
    assert int(sol.iters) == int(jsol.iters)


def test_rowsharded_hybrid_matches_jax():
    """The hybrid path on f32 input: an f32 phase and re-centred f32
    rounds, f64 residuals on the original data."""
    jqp = jrandom_box_qp(jax.random.key(33), n=32, m=64, dtype=jnp.float32)
    kw = dict(eps_abs=1e-6, eps_rel=1e-6)
    jsol = jrowshard.solve_rowsharded_hybrid(jqp, jmake_data_mesh(8),
                                             JSettings(**kw))
    sol = rowshard.solve_rowsharded_hybrid(_port(jqp), _mesh(),
                                           Settings(**kw))
    assert int(jsol.status) == int(Status.SOLVED)
    assert int(sol.status) == int(Status.SOLVED)
    assert sol.x.dtype == torch.float32
    assert float(sol.r_prim) <= 1e-5 and float(sol.r_dual) <= 1e-5
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(jsol.x), rtol=0,
                               atol=1e-4)


def _settings_of_calls(monkeypatch, module):
    """Record the Settings of every solve_rowsharded call in `module`."""
    seen = []
    inner = module.solve_rowsharded

    def spy(qp, mesh, settings, *a, **kw):
        seen.append(settings)
        return inner(qp, mesh, settings, *a, **kw)

    monkeypatch.setattr(module, "solve_rowsharded", spy)
    return seen


def test_hybrid_rounds_run_without_certificates(monkeypatch):
    """The reference's rounds reuse phase 1's settings (`s_c = s1`,
    rowshard.py:492), so the infeasibility certificates judge the
    shifted correction problems; the port's rounds run with both
    certificate tolerances at 0, and phase 1 keeps the caller's. A short
    iteration budget leaves phase 1 unsolved, so the rounds run."""
    jqp = jrandom_box_qp(jax.random.key(33), n=32, m=64, dtype=jnp.float32)
    kw = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=100)
    jseen = _settings_of_calls(monkeypatch, jrowshard)
    jrowshard.solve_rowsharded_hybrid(jqp, jmake_data_mesh(8),
                                      JSettings(**kw))
    seen = _settings_of_calls(monkeypatch, rowshard)
    sol = rowshard.solve_rowsharded_hybrid(_port(jqp), _mesh(),
                                           Settings(**kw))
    assert int(sol.status) == int(Status.SOLVED)
    assert len(seen) == len(jseen) >= 2
    caller = Settings(**kw)
    assert (seen[0].eps_pinf, seen[0].eps_dinf) == (caller.eps_pinf,
                                                    caller.eps_dinf)
    assert all((s.eps_pinf, s.eps_dinf) == (0.0, 0.0) for s in seen[1:])
    # The reference fault the port leaves out.
    assert all(s.eps_pinf > 0 for s in jseen[1:])
