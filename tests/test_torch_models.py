"""Port parity for the data side: MPC builders, Monte-Carlo batches, the
reference dispersions, the oracle, Settings and Status.

The builders assemble the problem in f64 numpy and convert once in both
packages, so the data must be bitwise equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_library_tpu as J
from admm_library_tpu.models import double_integrator as jdi
from admm_library_tpu.models import monte_carlo as jmc
from admm_library_tpu.utils import oracle as jor
import admm_library_torch as T
from admm_library_torch.models import double_integrator as tdi
from admm_library_torch.models import monte_carlo as tmc
from admm_library_torch.utils import oracle as tor

FIELDS = ("P", "q", "A", "l", "u", "lam")

# Small shapes: one intra-op thread keeps the CPU free for the other
# test workers.
torch.set_num_threads(1)


def _equal(tqp, jqp):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tqp, f).numpy(),
                                      np.asarray(getattr(jqp, f)), err_msg=f)
    assert tqp.cone.m_box == jqp.cone.m_box


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_build_mpc_qp(dtype):
    s0 = np.array([1.0, -2.0, 0.5, 0.1, 0.0, -0.3])
    target = np.array([0.2, 0.0, 0.0, 0.0, 0.1, 0.0])
    jqp, jspec = jdi.build_mpc_qp(s0, target, N=7, dim=3,
                                  dtype=getattr(jnp, dtype))
    tqp, tspec = tdi.build_mpc_qp(s0, target, N=7, dim=3,
                                  dtype=getattr(torch, dtype))
    _equal(tqp, jqp)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert (tspec.n, tspec.block) == (jspec.n, jspec.block)


def test_monte_carlo_from_s0_matches_jax():
    jqp, _, s0s = jmc.monte_carlo_mpc(jax.random.key(11), batch=5, N=6,
                                      dim=2)
    tqp, _, t0s = tmc.monte_carlo_mpc_from_s0(np.asarray(s0s), N=6, dim=2)
    _equal(tqp, jqp)
    np.testing.assert_array_equal(t0s.numpy(), np.asarray(s0s))


@pytest.mark.parametrize("batch", [128, 1024])
def test_reference_dispersions_are_jax_draws(batch):
    """The committed s0 arrays are exactly what the JAX reference's
    config-5 batch draws (monte_carlo_mpc, PRNGKey(0), N=50, dim=3)."""
    _, _, s0s = jmc.monte_carlo_mpc(jax.random.PRNGKey(0), batch=batch,
                                    N=50, dim=3)
    ref = tmc.reference_s0(batch)
    assert ref.dtype == np.float32 and ref.shape == (batch, 6)
    np.testing.assert_array_equal(ref, np.asarray(s0s))


def test_bounds_and_rollout_match_jax():
    rng = np.random.default_rng(0)
    jqp, spec = jdi.build_mpc_qp(np.ones(4), np.zeros(4), N=5, dim=2,
                                 dtype=jnp.float64)
    tqp, tspec = tdi.build_mpc_qp(np.ones(4), np.zeros(4), N=5, dim=2,
                                  dtype=torch.float64)
    s0 = rng.standard_normal(4)
    jl, ju = jdi.mpc_bounds_for_s0(jqp, spec, s0)
    tl, tu = tdi.mpc_bounds_for_s0(tqp, tspec, torch.from_numpy(s0))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    x = rng.standard_normal(spec.n)
    np.testing.assert_allclose(
        tdi.rollout(tspec, torch.from_numpy(s0), torch.from_numpy(x)).numpy(),
        np.asarray(jdi.rollout(spec, s0, jnp.asarray(x))), rtol=1e-14)


def test_disperse_s0_generator():
    g = torch.Generator().manual_seed(3)
    a = tmc.disperse_s0(g, [1.0, 1.0, -0.5, -0.5], 0.1, 0.01, 4096)
    b = tmc.disperse_s0(torch.Generator().manual_seed(3),
                        [1.0, 1.0, -0.5, -0.5], 0.1, 0.01, 4096)
    assert a.shape == (4096, 4) and a.dtype == torch.float32
    assert torch.equal(a, b)
    # Per-axis spread: sigma_pos on positions, sigma_vel on velocities
    # (4096 draws: the sample std is within 5% of sigma).
    std = a.std(dim=0)
    torch.testing.assert_close(std, torch.tensor([0.1, 0.1, 0.01, 0.01]),
                               rtol=0.05, atol=0.0)
    qp, spec, s0s = tmc.monte_carlo_mpc(torch.Generator().manual_seed(3),
                                        batch=6, N=4, dim=2)
    assert qp.l.shape == (6, qp.m) and s0s.shape == (6, 4)


def test_oracle_matches_jax():
    jqp, jx, jy = jor.qp_known_solution(5, n=12, m=20, n_active=6)
    tqp, tx, ty = tor.qp_known_solution(5, n=12, m=20, n_active=6)
    _equal(tqp, jqp)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 12))
    z = rng.standard_normal((3, 20))
    y = rng.standard_normal((3, 20))
    got = tor.kkt_residuals(tqp, *map(torch.from_numpy, (x, z, y)))
    ref = jor.kkt_residuals(jqp, x, z, y)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)
    # The constructed pair is optimal.
    r_p, r_d, comp = tor.kkt_residuals(tqp, tx, tx @ tqp.A.mT, ty)
    assert max(float(r_p), float(r_d), float(comp)) < 1e-12


def test_settings_and_status_carry_across():
    js = J.Settings(eps_abs=1e-7, backend="inv", fused="off", history=8)
    ts = T.Settings(**dataclasses.asdict(js))
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert dataclasses.asdict(T.Settings()) == dataclasses.asdict(
        J.Settings())
    with pytest.raises(ValueError):
        T.Settings(alpha=2.5)
    with pytest.raises(ValueError):
        T.Settings(fused="maybe")
    assert {s.name: int(s) for s in T.Status} == {
        s.name: int(s) for s in J.Status}


def test_resolve_backend():
    assert T.resolve_backend(T.Settings(), "cpu") == "chol"
    assert T.resolve_backend(T.Settings(), "cuda") == "inv"
    assert T.resolve_backend(T.Settings(backend="inv"), "cpu") == "inv"


def test_reference_random_box_qp_is_the_jax_draw():
    """The committed config-1 instance is exactly what the JAX
    reference's random_box_qp(PRNGKey(0)) draws (f32, n=100, m=200)."""
    from admm_library_tpu.models.random_qp import random_box_qp
    from admm_library_torch.models.random_qp import reference_random_box_qp
    jqp = random_box_qp(jax.random.PRNGKey(0))
    tqp = reference_random_box_qp()
    _equal(tqp, jqp)
    assert tqp.dtype == torch.float32 and (tqp.n, tqp.m) == (100, 200)


@pytest.mark.parametrize("kind", ["box", "eq_ineq"])
def test_random_qp_generators(kind):
    """Seeded and device-explicit; P symmetric positive definite, the
    bounds nonempty around A x_feas, equality rows first (eq_ineq)."""
    from admm_library_torch.models import random_qp as trq
    if kind == "box":
        make = lambda g: trq.random_box_qp(g, n=12, m=20)  # noqa: E731
    else:
        make = lambda g: trq.random_eq_ineq_qp(  # noqa: E731
            g, n=12, m_eq=3, m_in=9)
    qp = make(torch.Generator().manual_seed(4))
    again = make(torch.Generator().manual_seed(4))
    for f in FIELDS:
        assert torch.equal(getattr(qp, f), getattr(again, f)), f
    assert qp.dtype == torch.float32 and qp.device.type == "cpu"
    assert torch.equal(qp.P, qp.P.T)
    assert float(torch.linalg.eigvalsh(qp.P.double()).min()) >= 0.09
    assert bool((qp.l <= qp.u).all())
    eq = (qp.l == qp.u)
    if kind == "box":
        assert not bool(eq.any()) and qp.cone.m_box == 20
    else:
        assert eq.tolist() == [True] * 3 + [False] * 9
