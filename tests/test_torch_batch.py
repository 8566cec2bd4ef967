"""Port parity for the slice: solve_batch_shared of admm_library_torch
against the JAX package on the same Monte-Carlo batch.

Both sides use backend='inv', so the f32 phase goes through the fused
kernel's path (the Pallas kernel in interpret mode in JAX, the twin on
CPU tensors in the port). f32 products round differently in the two
frameworks, so iterates are not bitwise equal: the bar is the same
status per lane, a lockstep count within one check interval (25), and
solutions within 2e-5 (each meets the 1e-6 residual criterion of a
strongly convex QP; measured ~2e-6 apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_library_tpu import Settings as JSettings
from admm_library_tpu.models import monte_carlo as jmc
from admm_library_tpu.parallel.batch import solve_batch_shared as jsolve
from admm_library_tpu.problem import make_qp as jmake_qp
from admm_library_tpu.problem import ConeSpec as JCone
from admm_library_torch import Settings, Status, solve_batch_shared
from admm_library_torch.models import monte_carlo as tmc
from admm_library_torch.models.double_integrator import rollout
from admm_library_torch.parallel import batch as tbatch
from admm_library_torch.problem import ConeSpec, qp_from_numpy
from admm_library_torch.utils.oracle import kkt_residuals

CHECK = 25
X_ATOL = 2e-5

# Small shapes: one intra-op thread keeps the CPU free for the other
# test workers.
torch.set_num_threads(1)


def _compare(jsol, tsol):
    np.testing.assert_array_equal(tsol.status.numpy(),
                                  np.asarray(jsol.status))
    j_lock = int(np.max(np.asarray(jsol.iters)))
    t_lock = int(tsol.iters.max())
    assert abs(j_lock - t_lock) <= CHECK, (j_lock, t_lock)
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x),
                               atol=X_ATOL)


_PATHS = {
    "hybrid": dict(precision="hybrid"),
    "single": dict(precision="single"),
    "double": dict(precision="double"),
    # The classic f32 -> f64 two-phase (no re-centring).
    "two_phase": dict(precision="hybrid", recenter_rounds=0),
}


@pytest.mark.parametrize("path", sorted(_PATHS))
def test_monte_carlo_matches_jax(path):
    qpj, spec, s0 = jmc.monte_carlo_mpc(jax.random.key(0), batch=4, N=8,
                                        dim=2)
    s = JSettings(backend="inv", **_PATHS[path])
    jsol = jsolve(qpj, s)
    qpt, tspec, s0t = tmc.monte_carlo_mpc_from_s0(np.asarray(s0), N=8,
                                                  dim=2, device="cpu")
    tsol = solve_batch_shared(qpt, Settings(**dataclasses.asdict(s)))
    _compare(jsol, tsol)
    assert bool((tsol.status == int(Status.SOLVED)).all())
    # Independent checks: raw KKT residuals and the simulated dynamics.
    r_p, r_d, _ = kkt_residuals(qpt.astype(torch.float64), tsol.x.double(),
                                tsol.z.double(), tsol.y.double())
    assert float(r_p.max()) <= 2e-6 and float(r_d.max()) <= 2e-6
    for i in range(4):
        term = rollout(tspec, s0t[i].double(), tsol.x[i].double())[-1]
        assert float(term.abs().max()) < 1e-4


def test_f64_fallback_matches_jax(monkeypatch):
    """A 1e-9 target is below what the f32 rounds can reach, so the f64
    fallback finishes. The rounds then stall at the f32 floor, where
    rounding differences move lanes by hundreds of iterations (one lane
    on identical inputs agrees to the check; the shared rho couples the
    lanes), so only statuses, solutions and residuals are compared."""
    qpj, _, s0 = jmc.monte_carlo_mpc(jax.random.key(0), batch=4, N=8,
                                     dim=2)
    s = JSettings(backend="inv", eps_abs=1e-9, eps_rel=1e-9)
    jsol = jsolve(qpj.astype(jnp.float64), s)
    qpt = tmc.monte_carlo_mpc_from_s0(np.asarray(s0), N=8, dim=2,
                                      device="cpu")[0].astype(torch.float64)
    phases = []
    phase = tbatch._phase

    def spy(qp, *args, **kw):
        phases.append(qp.dtype)
        return phase(qp, *args, **kw)

    monkeypatch.setattr(tbatch, "_phase", spy)
    tsol = solve_batch_shared(qpt, Settings(**dataclasses.asdict(s)))
    assert phases[-1] == torch.float64            # the fallback ran
    np.testing.assert_array_equal(tsol.status.numpy(),
                                  np.asarray(jsol.status))
    assert bool((tsol.status == int(Status.SOLVED)).all())
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x),
                               atol=1e-7)
    r_p, r_d, _ = kkt_residuals(qpt, tsol.x, tsol.z, tsol.y)
    assert float(r_p.max()) <= 1e-8 and float(r_d.max()) <= 1e-8


def test_rerun_is_bitwise_identical():
    qp, _, _ = tmc.monte_carlo_mpc(torch.Generator().manual_seed(5),
                                   batch=3, N=6, dim=2, device="cpu")
    s = Settings(backend="inv", history=32)
    a = solve_batch_shared(qp, s)
    b = solve_batch_shared(qp, s)
    for f in ("x", "z", "y", "status", "iters", "history"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    filled = a.history[a.history[:, 0] > 0]
    assert filled.shape[0] >= 1


def _mixed_batch(B=3, seed=7):
    """Box + bounded L1 + uniform SOC rows sharing (P, A), bounds
    dispersed per lane: the re-centred rounds' dual base (mask_dual)
    and shifted prox (f64 offset) run here."""
    rng = np.random.default_rng(seed)
    n, mb, ml, d, nb = 10, 6, 3, 3, 2
    m = mb + ml + d * nb
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    P = R @ R.T + 0.5 * np.eye(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    q = rng.standard_normal(n)
    l = np.full((B, m), -np.inf)
    u = np.full((B, m), np.inf)
    l[:, :mb] = -0.3 - 0.2 * rng.random((B, mb))
    u[:, :mb] = 0.3 + 0.2 * rng.random((B, mb))
    l[:, mb:mb + ml], u[:, mb:mb + ml] = -0.5, 0.5
    jc = JCone(m_box=mb, m_l1=ml, soc_dims=(d,) * nb)
    qpj = jmake_qp(jnp.asarray(P), q, A, l, u, cone=jc,
                   lam=np.full(ml, 0.2))
    qpt = qp_from_numpy(
        {f: np.asarray(getattr(qpj, f)) for f in
         ("P", "q", "A", "l", "u", "lam")},
        ConeSpec(m_box=mb, m_l1=ml, soc_dims=(d,) * nb), device="cpu")
    return qpj, qpt


def test_mixed_cone_recentred_matches_jax():
    qpj, qpt = _mixed_batch()
    s = JSettings(backend="inv")
    jsol = jsolve(qpj, s)
    tsol = solve_batch_shared(qpt, Settings(**dataclasses.asdict(s)))
    _compare(jsol, tsol)


_INFEASIBLE_CASES = {
    # x0 in [1, 2] and in [-2, -1] on lane 1.
    "primal": (np.eye(2), np.array([0.5, -0.3]),
               np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
               np.array([[1.0, 1.0, -1.0], [1.0, -2.0, -1.0]]),
               np.array([[2.0, 3.0, 1.0], [2.0, -1.0, 1.0]]),
               Status.PRIMAL_INFEASIBLE),
    # min -x0 with no curvature on x0, bounded above only on lane 0.
    "dual": (np.diag([0.0, 1.0]), np.array([-1.0, 0.0]), np.eye(2),
             np.array([[0.0, -1.0], [0.0, -1.0]]),
             np.array([[5.0, 1.0], [np.inf, 1.0]]),
             Status.DUAL_INFEASIBLE),
}


@pytest.mark.parametrize("kind", sorted(_INFEASIBLE_CASES))
def test_infeasible_lane_matches_jax(kind):
    """Lane 1 is infeasible: both packages certify it and solve lane 0."""
    P, q, A, l, u, want = _INFEASIBLE_CASES[kind]
    qpj = jmake_qp(jnp.asarray(P), q, A, l, u)
    qpt = qp_from_numpy({f: np.asarray(getattr(qpj, f)) for f in
                         ("P", "q", "A", "l", "u", "lam")},
                        ConeSpec(m_box=A.shape[0]), device="cpu")
    s = JSettings(backend="inv")
    jsol = jsolve(qpj, s)
    tsol = solve_batch_shared(qpt, Settings(**dataclasses.asdict(s)))
    np.testing.assert_array_equal(tsol.status.numpy(),
                                  np.asarray(jsol.status))
    assert tsol.status.tolist() == [int(Status.SOLVED), int(want)]
