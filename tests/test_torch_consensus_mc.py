"""Port parity for Monte-Carlo consensus ADMM (scenarios x horizon
blocks): consensus_solve_mc of admm_library_torch against the JAX
package's on its 2x4 virtual CPU mesh, with the JAX draw of
the dispersions passed to the port. The port runs in one process (a 1x1
mesh). f64 data; bars as in test_torch_consensus.py: per-lane status,
iterations within 25, x within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_library_tpu import Settings as JSettings
from admm_library_tpu.models.partitioned import \
    partition_mpc_mc as jpartition_mpc_mc
from admm_library_tpu.parallel import runtime as jruntime
from admm_library_tpu.parallel.consensus_mc import \
    consensus_solve_mc as jconsensus_solve_mc
from admm_library_torch import Settings, Status
from admm_library_torch.models.double_integrator import rollout
from admm_library_torch.models.partitioned import (assemble_trajectory,
                                                    partition_mpc,
                                                    partition_mpc_from_s0,
                                                    partition_mpc_mc,
                                                    reference_s0)
from admm_library_torch.parallel import runtime
from admm_library_torch.parallel.consensus import consensus_solve
from admm_library_torch.parallel.consensus_mc import consensus_solve_mc

torch.set_num_threads(1)

S0 = np.array([1.0, -2.0, 0.3, -0.1])
ST = np.zeros(4)
TOL = dict(eps_abs=1e-7, eps_rel=1e-7, max_iter=20000)
CHECK = 25
X_ATOL = 1e-6
F64 = torch.float64


def _mesh():
    return runtime.make_mesh(device="cpu")


def _both(key, batch, N, n_blocks, dtype=jnp.float64, **kw):
    """The JAX problem and the port's built from JAX's dispersions."""
    jqp, jspec, jmpc, s0s = jpartition_mpc_mc(
        key, batch, S0, ST, N=N, n_blocks=n_blocks, dim=2, dtype=dtype, **kw)
    tdtype = F64 if dtype == jnp.float64 else torch.float32
    tqp, tspec, tmpc, _ = partition_mpc_from_s0(
        np.asarray(s0s), S0, ST, N=N, n_blocks=n_blocks, dim=2,
        dtype=tdtype, device="cpu", **kw)
    for f in ("P", "q", "A", "l", "u"):
        np.testing.assert_array_equal(getattr(tqp, f).numpy(),
                                      np.asarray(getattr(jqp, f)))
    return jqp, jspec, tqp, tspec, tmpc, np.array(s0s)


def test_consensus_mc_matches_jax_mesh():
    batch, n_blocks = 4, 4
    jqp, jspec, tqp, tspec, mpc, s0s = _both(
        jax.random.key(0), batch, N=8, n_blocks=n_blocks, u_max=2.0)
    jsol = jconsensus_solve_mc(jqp, jspec,
                               jruntime.make_mesh(data=2, horizon=4),
                               JSettings(**TOL))
    sol = consensus_solve_mc(tqp, tspec, _mesh(), Settings(**TOL))
    assert sol.x.shape == (batch, n_blocks, tspec.nb)
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(jsol.status))
    assert np.all(sol.status.numpy() == int(Status.SOLVED))
    assert np.abs(sol.iters.numpy() - np.asarray(jsol.iters)).max() <= CHECK
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(jsol.x),
                               atol=X_ATOL)
    # Honest per-scenario counts, whole check intervals.
    assert np.all(sol.iters.numpy() % CHECK == 0)
    # Stitched physics reach the target from each lane's s0.
    for b in range(batch):
        us, _ = assemble_trajectory(tspec, mpc, sol.x[b])
        x_mono = torch.from_numpy(np.concatenate(
            [np.concatenate([us[k], np.zeros(mpc.ns)])
             for k in range(mpc.N)]))
        traj = rollout(mpc, torch.from_numpy(s0s[b]), x_mono)
        assert float((traj[-1] - torch.from_numpy(ST)).abs().max()) < 1e-4


def test_consensus_mc_batch1_matches_consensus_solve():
    """B=1 with no dispersion: the same problem as consensus_solve."""
    qp_mc, spec, _, _ = partition_mpc_mc(
        torch.Generator().manual_seed(1), 1, S0, ST, N=16, n_blocks=8,
        dim=2, u_max=2.0, sigma_pos=0.0, sigma_vel=0.0, dtype=F64,
        device="cpu")
    sol_mc = consensus_solve_mc(qp_mc, spec, _mesh(), Settings(**TOL))
    assert int(sol_mc.status[0]) == int(Status.SOLVED)
    qp, spec1, _ = partition_mpc(S0, ST, N=16, n_blocks=8, dim=2,
                                 u_max=2.0, dtype=F64, device="cpu")
    sol_1 = consensus_solve(qp, spec1, _mesh(), Settings(**TOL))
    np.testing.assert_allclose(sol_mc.x[0].numpy(), sol_1.x.numpy(),
                               atol=2e-5)


def test_consensus_mc_infeasible_lane():
    """Zero control authority: every scenario whose drift misses the
    target is PRIMAL_INFEASIBLE, per lane, as in the JAX package."""
    s_t = np.array([50.0, 40.0, 0.0, 0.0])
    s = dict(precision="single", max_iter=4000)
    jqp, jspec, _, s0s = jpartition_mpc_mc(
        jax.random.PRNGKey(0), 4, S0, s_t, N=8, n_blocks=4, dim=2,
        u_max=0.0)
    tqp, tspec, _, _ = partition_mpc_from_s0(
        np.asarray(s0s), S0, s_t, N=8, n_blocks=4, dim=2, u_max=0.0,
        device="cpu")
    sol = consensus_solve_mc(tqp, tspec, _mesh(), Settings(**s))
    assert np.all(sol.status.numpy() == int(Status.PRIMAL_INFEASIBLE))
    jsol = jconsensus_solve_mc(jqp, jspec,
                               jruntime.make_mesh(data=2, horizon=4),
                               JSettings(**s))
    np.testing.assert_array_equal(sol.status.numpy(), np.asarray(jsol.status))


def test_reference_dispersions_are_the_jax_draw():
    """models/consensus_mc_s0_seed0.npz holds exactly what the JAX
    package's consensus_mc_1024 cell draws, and the port builds that
    cell's data bitwise as JAX does."""
    rng = np.random.default_rng(0)
    s0 = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(-0.2, 0.2, 3)])
    jqp, jspec, _, s0s = jpartition_mpc_mc(
        jax.random.PRNGKey(0), 1024, s0, np.zeros(6), N=50, n_blocks=10,
        dim=3)
    ref = reference_s0()
    assert ref.dtype == np.float32 and ref.shape == (1024, 6)
    np.testing.assert_array_equal(ref, np.asarray(s0s))
    tqp, tspec, _, _ = partition_mpc_from_s0(ref, s0, np.zeros(6), N=50,
                                             n_blocks=10, dim=3,
                                             device="cpu")
    assert (tspec.nb, tspec.m_local, tspec.mb) == (51, 45, 57)
    for f in ("P", "q", "A", "l", "u"):
        np.testing.assert_array_equal(getattr(tqp, f).numpy(),
                                      np.asarray(getattr(jqp, f)), err_msg=f)
