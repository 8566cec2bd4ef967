"""Port parity for consensus ADMM over horizon blocks: the block-shared
Ruiz scaling, the partitioned MPC builder and consensus_solve of
admm_library_torch against the JAX package.

The JAX side runs on its 8-device virtual CPU mesh (tests/conftest.py),
the port in one process (a 1x1 mesh: every block on this rank). f64
data. Bars: the scaling to 1e-12; a solve to the same status,
iterations within one check interval (25), x within 1e-6 (two points
solved to 1e-7; measured 3.8e-8 apart at equal iterations).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_library_tpu import Settings as JSettings
from admm_library_tpu.core.scaling import Scaling as JScaling
from admm_library_tpu.core.scaling import \
    ruiz_equilibrate_blocks as jruiz_blocks
from admm_library_tpu.core.scaling import scale_qp_blocks as jscale_blocks
from admm_library_tpu.models.partitioned import \
    partition_mpc as jpartition_mpc
from admm_library_tpu.parallel.batch import make_data_mesh
from admm_library_tpu.parallel.consensus import ConsensusSpec as JSpec
from admm_library_tpu.parallel.consensus import \
    consensus_solve as jconsensus_solve
from admm_library_tpu.problem import ConeSpec as JCone
from admm_library_tpu.problem import QPData as JQP
from admm_library_torch import Settings, Status, solve
from admm_library_torch.core.scaling import (Scaling, ruiz_equilibrate_blocks,
                                             scale_qp_blocks)
from admm_library_torch.models.double_integrator import build_mpc_qp
from admm_library_torch.models.partitioned import (assemble_trajectory,
                                                    partition_mpc)
from admm_library_torch.parallel import runtime
from admm_library_torch.parallel.consensus import ConsensusSpec, consensus_solve
from admm_library_torch.problem import ConeSpec, QPData

torch.set_num_threads(1)

S0 = np.array([1.0, -2.0, 0.3, -0.1])
ST = np.zeros(4)
TOL = dict(eps_abs=1e-7, eps_rel=1e-7, max_iter=20000)
CHECK = 25
X_ATOL = 1e-6
F64 = torch.float64


def _mesh():
    return runtime.make_mesh(device="cpu")


def _np(t):
    return np.asarray(t)


def _mpc(N=16, n_blocks=8, **kw):
    return partition_mpc(S0, ST, N=N, n_blocks=n_blocks, dim=2, u_max=2.0,
                         dtype=F64, device="cpu", **kw)


def _mixed_blocks():
    """Random block data with box, L1 and SOC local rows (both packages'
    forms): 3 blocks, nb=6, m_local = 3 + 2 + 2*3, ns=2."""
    rng = np.random.default_rng(5)
    S, nb, ns = 3, 6, 2
    jc = JCone(m_box=3, m_l1=2, soc_dims=(3, 3))
    tc = ConeSpec(m_box=3, m_l1=2, soc_dims=(3, 3))
    ml = jc.m
    mb = ml + 2 * ns
    R = rng.standard_normal((S, nb, nb))
    arrays = dict(
        P=R @ R.transpose(0, 2, 1) + 0.1 * np.eye(nb),
        q=rng.standard_normal((S, nb)),
        A=rng.standard_normal((S, mb, nb)) * rng.uniform(0.1, 10, (S, mb, 1)),
        l=np.where(rng.random((S, mb)) < 0.3, -np.inf,
                   -rng.uniform(0.5, 2, (S, mb))),
        u=rng.uniform(0.5, 2, (S, mb)),
        lam=rng.uniform(0.1, 3, (S, 2)))
    jqp = JQP(**{k: jnp.asarray(v) for k, v in arrays.items()}, cone=jc)
    tqp = QPData(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                 cone=tc)
    return (jqp, JSpec(n_blocks=S, nb=nb, m_local=ml, ns=ns, cone=jc),
            tqp, ConsensusSpec(n_blocks=S, nb=nb, m_local=ml, ns=ns,
                               cone=tc))


def _mpc_blocks():
    jqp, jspec, _ = jpartition_mpc(S0, ST, N=16, n_blocks=8, dim=2,
                                   u_max=2.0, dtype=jnp.float64)
    tqp, tspec, _ = _mpc()
    return jqp, jspec, tqp, tspec


_BLOCKS = {"mpc": _mpc_blocks, "box_l1_soc": _mixed_blocks}


def _assert_qp_close(tqp, jqp, tol):
    for f in ("P", "q", "A", "l", "u", "lam"):
        np.testing.assert_allclose(getattr(tqp, f).numpy(), _np(getattr(jqp, f)),
                                   rtol=tol, atol=tol, err_msg=f)


def test_partition_mpc_matches_jax_data():
    jqp, jspec, tqp, tspec = _mpc_blocks()
    assert (tspec.n_blocks, tspec.nb, tspec.m_local, tspec.ns, tspec.mb) == (
        jspec.n_blocks, jspec.nb, jspec.m_local, jspec.ns, jspec.mb)
    assert tspec.cone.m_box == jspec.cone.m_box
    for f in ("P", "q", "A", "l", "u", "lam"):
        np.testing.assert_array_equal(getattr(tqp, f).numpy(),
                                      _np(getattr(jqp, f)), err_msg=f)


@pytest.mark.parametrize("case", sorted(_BLOCKS))
def test_ruiz_equilibrate_blocks_matches_jax(case):
    jqp, jspec, tqp, tspec = _BLOCKS[case]()
    jqs, js = jruiz_blocks(jqp, jspec, 10)
    tqs, ts = ruiz_equilibrate_blocks(tqp, tspec, 10)
    for f in ("d", "e", "c"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), _np(getattr(js, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    _assert_qp_close(tqs, jqs, 1e-12)
    # The edge-row factors are tied (left == right), bitwise.
    ml, ns = tspec.m_local, tspec.ns
    assert torch.equal(ts.e[ml:ml + ns], ts.e[ml + ns:])


@pytest.mark.parametrize("case", sorted(_BLOCKS))
def test_scale_qp_blocks_matches_jax(case):
    """The rounds' form: a precomputed scaling on scenario-batched l/u
    and q."""
    jqp, jspec, tqp, tspec = _BLOCKS[case]()
    _, js = jruiz_blocks(jqp, jspec, 10)
    rng = np.random.default_rng(9)
    shift = rng.standard_normal((2,) + tuple(tqp.l.shape))
    qshift = rng.standard_normal((2,) + tuple(tqp.q.shape))
    jb = JQP(P=jqp.P, q=jqp.q + qshift, A=jqp.A, l=jqp.l + shift,
             u=jqp.u + shift, lam=jqp.lam, cone=jqp.cone)
    tb = QPData(P=tqp.P, q=tqp.q + torch.from_numpy(qshift), A=tqp.A,
                l=tqp.l + torch.from_numpy(shift),
                u=tqp.u + torch.from_numpy(shift), lam=tqp.lam,
                cone=tqp.cone)
    ts = Scaling(*(torch.from_numpy(np.array(getattr(js, f)))
                   for f in ("d", "e", "c")))
    _assert_qp_close(scale_qp_blocks(tb, ts, tspec),
                     jscale_blocks(jb, JScaling(js.d, js.e, js.c), jspec),
                     1e-12)


def test_ruiz_identity_at_zero_iters():
    _, _, tqp, tspec = _mpc_blocks()
    qs, s = ruiz_equilibrate_blocks(tqp, tspec, 0)
    assert qs is tqp
    assert torch.equal(s.d, torch.ones(tspec.nb, dtype=F64))


@pytest.fixture(scope="module")
def jax_ref():
    jqp, jspec, _ = jpartition_mpc(S0, ST, N=16, n_blocks=8, dim=2,
                                   u_max=2.0, dtype=jnp.float64)
    return jconsensus_solve(jqp, jspec, make_data_mesh(8, axis="horizon"),
                            JSettings(**TOL))


@pytest.fixture(scope="module")
def port_sol():
    qp, spec, mpc = _mpc()
    return consensus_solve(qp, spec, _mesh(), Settings(**TOL))


def test_consensus_matches_jax_mesh(jax_ref, port_sol):
    assert int(port_sol.status) == int(jax_ref.status) == int(Status.SOLVED)
    assert abs(int(port_sol.iters) - int(jax_ref.iters)) <= CHECK
    np.testing.assert_allclose(port_sol.x.numpy(), _np(jax_ref.x),
                               atol=X_ATOL)
    assert port_sol.x.shape == (8, 16)


def test_consensus_matches_monolithic(port_sol):
    _, spec, mpc = _mpc()
    us, _ = assemble_trajectory(spec, mpc, port_sol.x)
    qp_mono, spec_mono = build_mpc_qp(S0, ST, N=16, dim=2, u_max=2.0,
                                      dtype=F64, device="cpu")
    mono = solve(qp_mono, Settings(eps_abs=1e-9, eps_rel=1e-9))
    assert mono.status_name() == "SOLVED"
    b, nu = spec_mono.block, spec_mono.nu
    us_mono = np.stack([mono.x[k * b:k * b + nu].numpy() for k in range(16)])
    np.testing.assert_allclose(us, us_mono, atol=5e-5)


def test_consensus_boundary_copies():
    """Both sides of a pair average the same two values: a phase's z
    copies agree bitwise; the x copies to the solve's tolerance."""
    qp, spec, _ = _mpc()
    ml, ns = spec.m_local, spec.ns
    one = consensus_solve(qp, spec, _mesh(), Settings(precision="single",
                                                      **TOL))
    assert int(one.status) == int(Status.SOLVED)
    assert torch.equal(one.z[1:, ml:ml + ns], one.z[:-1, ml + ns:])
    np.testing.assert_allclose(one.x[1:, :ns].numpy(),
                               one.x[:-1, -ns:].numpy(), atol=1e-6)


def test_consensus_warm_start_and_history():
    """A re-solve from a converged solution costs far fewer iterations;
    the residual ring buffer is filled."""
    qp, spec, _ = _mpc()
    s = Settings(history=64, **TOL)
    sol = consensus_solve(qp, spec, _mesh(), s)
    assert int(sol.status) == int(Status.SOLVED)
    warm = consensus_solve(qp, spec, _mesh(), s, x0=sol.x, z0=sol.z,
                           y0=sol.y, rho0=sol.rho)
    assert int(warm.status) == int(Status.SOLVED)
    assert int(warm.iters) <= int(sol.iters) // 4
    hist = sol.history.numpy()
    filled = hist[hist[:, 0] > 0]
    filled = filled[np.argsort(filled[:, 0])]
    assert filled.shape[0] >= 2
    assert np.all(np.diff(filled[:, 0]) > 0)
    assert np.all(filled[:, 1:] >= 0)


def test_consensus_1e8_no_f64_loop():
    """eps 1e-8 through the f32 phase and the re-centred f32 rounds."""
    qp, spec, _ = _mpc()
    sol = consensus_solve(qp, spec, _mesh(), Settings(
        eps_abs=1e-8, eps_rel=1e-8, max_iter=30000))
    assert int(sol.status) == int(Status.SOLVED)
    assert float(sol.r_prim) <= 1e-7 and float(sol.r_dual) <= 1e-7


@pytest.mark.parametrize("backend", ["inv", "cg"])
def test_consensus_backends_agree(backend):
    """Every per-block x-update backend reaches Cholesky's solution;
    'cg' carries its operator through the rho updates without
    refactoring. f64 iterations: there CG meets its 1e-9 tolerance
    within the block size."""
    qp, spec, _ = _mpc(N=8, n_blocks=4)
    s = Settings(precision="double", **TOL)
    ref = consensus_solve(qp, spec, _mesh(), s.replace(backend="chol"))
    sol = consensus_solve(qp, spec, _mesh(), s.replace(backend=backend))
    assert int(sol.status) == int(ref.status) == int(Status.SOLVED)
    np.testing.assert_allclose(sol.x.numpy(), ref.x.numpy(), atol=X_ATOL)


def test_consensus_primal_infeasible():
    """Zero control authority and an unreachable terminal equality: the
    block problem is primal infeasible and the certificate fires, as in
    the JAX package."""
    s_t = np.array([50.0, 40.0, 0.0, 0.0])
    qp, spec, _ = partition_mpc(S0, s_t, N=8, n_blocks=4, dim=2, u_max=0.0,
                                device="cpu")
    s = dict(precision="single", max_iter=4000)
    sol = consensus_solve(qp, spec, _mesh(), Settings(**s))
    assert int(sol.status) == int(Status.PRIMAL_INFEASIBLE)
    jqp, jspec, _ = jpartition_mpc(S0, s_t, N=8, n_blocks=4, dim=2,
                                   u_max=0.0)
    jsol = jconsensus_solve(jqp, jspec, make_data_mesh(4, axis="horizon"),
                            JSettings(**s))
    assert int(jsol.status) == int(sol.status)


def test_consensus_rejects_indivisible_mesh():
    qp, spec, _ = _mpc(N=15, n_blocks=3)
    mesh = runtime.Mesh(shape={"data": 1, "horizon": 2},
                        coords={"data": 0, "horizon": 0},
                        groups={"data": None, "horizon": None},
                        ranks={"data": (0,), "horizon": (0, 1)}, world=1,
                        device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        consensus_solve(qp, spec, mesh, Settings(**TOL))
