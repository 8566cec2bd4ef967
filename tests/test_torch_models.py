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
                                  dtype=getattr(torch, dtype), device="cpu")
    _equal(tqp, jqp)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert (tspec.n, tspec.block) == (jspec.n, jspec.block)


def test_monte_carlo_from_s0_matches_jax():
    jqp, _, s0s = jmc.monte_carlo_mpc(jax.random.key(11), batch=5, N=6,
                                      dim=2)
    tqp, _, t0s = tmc.monte_carlo_mpc_from_s0(np.asarray(s0s), N=6, dim=2,
                                                device="cpu")
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
                                  dtype=torch.float64, device="cpu")
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
    a = tmc.disperse_s0(g, [1.0, 1.0, -0.5, -0.5], 0.1, 0.01, 4096,
                        device="cpu")
    b = tmc.disperse_s0(torch.Generator().manual_seed(3),
                        [1.0, 1.0, -0.5, -0.5], 0.1, 0.01, 4096,
                        device="cpu")
    assert a.shape == (4096, 4) and a.dtype == torch.float32
    assert torch.equal(a, b)
    # Per-axis spread: sigma_pos on positions, sigma_vel on velocities
    # (4096 draws: the sample std is within 5% of sigma).
    std = a.std(dim=0)
    torch.testing.assert_close(std, torch.tensor([0.1, 0.1, 0.01, 0.01]),
                               rtol=0.05, atol=0.0)
    qp, spec, s0s = tmc.monte_carlo_mpc(torch.Generator().manual_seed(3),
                                        batch=6, N=4, dim=2, device="cpu")
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
    tqp = reference_random_box_qp("cpu")
    _equal(tqp, jqp)
    assert tqp.dtype == torch.float32 and (tqp.n, tqp.m) == (100, 200)


@pytest.mark.parametrize("kind", ["box", "eq_ineq"])
def test_random_qp_generators(kind):
    """Seeded and device-explicit; P symmetric positive definite, the
    bounds nonempty around A x_feas, equality rows first (eq_ineq)."""
    from admm_library_torch.models import random_qp as trq
    if kind == "box":
        make = lambda g: trq.random_box_qp(g, n=12, m=20, device="cpu")  # noqa: E731
    else:
        make = lambda g: trq.random_eq_ineq_qp(  # noqa: E731
            g, n=12, m_eq=3, m_in=9, device="cpu")
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


# ---- CW min-fuel (config 3) and low-thrust SOCP (config 4) models ----

def _cw_s0():
    return np.array([100.0, -800.0, 30.0, 0.1, 0.4, -0.02])


def _lt_s0():
    return np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1])


def _builders():
    from admm_library_tpu.models import clohessy_wiltshire as jcw
    from admm_library_tpu.models import low_thrust as jlt
    from admm_library_torch.models import clohessy_wiltshire as tcw
    from admm_library_torch.models import low_thrust as tlt
    return {
        "cw": (jcw.build_cw_rendezvous, tcw.build_cw_rendezvous, _cw_s0(),
               dict(N=7, dt=600.0, dv_max=2.0)),
        "cw_sparse": (jcw.build_cw_rendezvous_sparse,
                      tcw.build_cw_rendezvous_sparse, _cw_s0(), dict(N=5)),
        "low_thrust": (jlt.build_low_thrust_socp, tlt.build_low_thrust_socp,
                       _lt_s0(), dict(N=6)),
    }


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("model", ["cw", "cw_sparse", "low_thrust"])
def test_astro_builders_match_jax(model, dtype):
    """Both packages assemble the data in f64 numpy and convert once:
    bitwise equal data and equal specs."""
    jbuild, tbuild, s0, kw = _builders()[model]
    target = np.array([5.0, 0.0, -2.0, 0.0, 0.01, 0.0])
    jqp, jspec = jbuild(s0, target, dtype=getattr(jnp, dtype), **kw)
    tqp, tspec = tbuild(s0, target, dtype=getattr(torch, dtype),
                        device="cpu", **kw)
    _equal(tqp, jqp)
    assert tqp.cone == type(tqp.cone)(**dataclasses.asdict(jqp.cone))
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    assert tqp.dtype == getattr(torch, dtype) and tqp.device.type == "cpu"


def test_cw_stm_properties():
    from admm_library_tpu.models import clohessy_wiltshire as jcw
    from admm_library_torch.models import clohessy_wiltshire as tcw
    n = 1.2e-3
    # Phi(0) = I; Phi(a) Phi(b) = Phi(a + b) (a linear time-invariant
    # flow); the same closed form as the reference, bit for bit.
    np.testing.assert_allclose(tcw.cw_stm(n, 0.0), np.eye(6), atol=1e-14)
    a, b = 137.0, 402.0
    np.testing.assert_allclose(tcw.cw_stm(n, a) @ tcw.cw_stm(n, b),
                               tcw.cw_stm(n, a + b), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(tcw.cw_stm(n, a), jcw.cw_stm(n, a))


def test_astro_solution_helpers_match_jax():
    """propagate, dv_impulses, rollout and thrust_profile on one vector
    and the bounds of a batch of dispersed states, against JAX (f64;
    the products sum in another order, hence 1e-12 relative)."""
    from admm_library_tpu.models import clohessy_wiltshire as jcw
    from admm_library_tpu.models import low_thrust as jlt
    from admm_library_torch.models import clohessy_wiltshire as tcw
    from admm_library_torch.models import low_thrust as tlt
    rng = np.random.default_rng(2)
    f64 = dict(dtype=jnp.float64)
    t64 = dict(dtype=torch.float64, device="cpu")
    close = dict(rtol=1e-12, atol=1e-12)
    s0b = rng.standard_normal((3, 6)) * [50, 50, 50, 0.05, 0.05, 0.05]

    jqp, jspec = jcw.build_cw_rendezvous(_cw_s0(), N=7, **f64)
    tqp, tspec = tcw.build_cw_rendezvous(_cw_s0(), N=7, **t64)
    x = rng.standard_normal(tspec.n)
    np.testing.assert_allclose(
        tcw.propagate(tspec, torch.from_numpy(_cw_s0()),
                      torch.from_numpy(x)).numpy(),
        np.asarray(jcw.propagate(jspec, _cw_s0(), jnp.asarray(x))), **close)
    assert tcw.dv_impulses(tspec, torch.from_numpy(x)).shape == (7, 3)
    for got, ref in zip(
            tcw.cw_bounds_for_s0(tqp, tspec, torch.from_numpy(s0b)),
            jcw.cw_bounds_for_s0(jqp, jspec, s0b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **close)

    jqp, jspec = jcw.build_cw_rendezvous_sparse(_cw_s0(), N=5, **f64)
    tqp, tspec = tcw.build_cw_rendezvous_sparse(_cw_s0(), N=5, **t64)
    for got, ref in zip(
            tcw.cw_sparse_bounds_for_s0(tqp, tspec, torch.from_numpy(s0b)),
            jcw.cw_sparse_bounds_for_s0(jqp, jspec, s0b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **close)

    jqp, jspec = jlt.build_low_thrust_socp(_lt_s0(), N=6, **f64)
    tqp, tspec = tlt.build_low_thrust_socp(_lt_s0(), N=6, **t64)
    x = rng.standard_normal(tspec.n)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(
        tlt.rollout(tspec, torch.from_numpy(_lt_s0()), tx).numpy(),
        np.asarray(jlt.rollout(jspec, _lt_s0(), jx)), **close)
    for got, ref in zip(tlt.thrust_profile(tspec, tx),
                        jlt.thrust_profile(jspec, jx)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tspec.accel_from_nd(tx).numpy(), np.asarray(jspec.accel_from_nd(jx)))
    for got, ref in zip(
            tlt.lt_bounds_for_s0(tqp, tspec, torch.from_numpy(s0b)),
            jlt.lt_bounds_for_s0(jqp, jspec, s0b)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **close)


@pytest.mark.parametrize("model", ["cw", "low_thrust"])
def test_monte_carlo_astro_batches_share_matrices(model):
    """Seeded, device-explicit dispersions whose batch shares P, q and A
    with the nominal problem and differs only in the bounds of the s0
    rows."""
    from admm_library_torch.models import clohessy_wiltshire as tcw
    from admm_library_torch.models import low_thrust as tlt
    if model == "cw":
        make = lambda g: tmc.monte_carlo_cw(  # noqa: E731
            g, batch=8, N=6, dtype=torch.float64, device="cpu")
        build = tcw.build_cw_rendezvous
    else:
        make = lambda g: tmc.monte_carlo_low_thrust(  # noqa: E731
            g, batch=4, N=5, dtype=torch.float64, device="cpu")
        build = tlt.build_low_thrust_socp
    qp, spec, s0s = make(torch.Generator().manual_seed(0))
    again = make(torch.Generator().manual_seed(0))[0]
    B = s0s.shape[0]
    assert qp.P.dim() == 2 and qp.A.dim() == 2 and qp.q.dim() == 1
    assert qp.l.shape == (B, qp.m) and qp.u.shape == (B, qp.m)
    for f in FIELDS:
        assert torch.equal(getattr(qp, f), getattr(again, f)), f
    # P, q and A do not depend on s0 in either model.
    other, _ = build(s0s[0], N=spec.N, dtype=torch.float64, device="cpu")
    for f in ("P", "q", "A", "lam"):
        assert torch.equal(getattr(qp, f), getattr(other, f)), f
    assert torch.equal(qp.l[:, 6:], qp.l[:1, 6:].expand(B, -1))
    assert not torch.equal(qp.l[0, :6], qp.l[1, :6])


def test_reference_continuation_entry_fits_config4():
    """The stored point where the JAX package's solve entered its f64
    continuation on config 4: f64 fields of config 4's shape (N=200:
    n=2000, m=2206), STALLED after 4,525 iterations, and its stored
    objective is the objective of the port's own build of config 4 at
    that point (f32 data solved as f64, as the bench does)."""
    from admm_library_torch.models import low_thrust as tlt
    from admm_library_torch.problem import objective
    e = tlt.reference_continuation_entry("cpu")
    qp, _ = tlt.build_low_thrust_socp(_lt_s0(), N=200, device="cpu")
    qp = qp.astype(torch.float64)
    assert e.x.shape == (qp.n,) and e.z.shape == e.y.shape == (qp.m,)
    assert (qp.n, qp.m) == (2000, 2206)
    assert e.x.dtype == e.z.dtype == e.y.dtype == torch.float64
    assert int(e.status) == int(T.Status.STALLED) and int(e.iters) == 4525
    np.testing.assert_allclose(float(objective(qp, e.x, e.z)), float(e.obj),
                               rtol=1e-12)


def _default_builds():
    from admm_library_torch.models import clohessy_wiltshire as tcw
    from admm_library_torch.models import low_thrust as tlt
    from admm_library_torch.models import random_qp as trq
    return {
        "monte_carlo_mpc": lambda: tmc.monte_carlo_mpc(
            torch.Generator().manual_seed(0), batch=2, N=3, dim=2)[0],
        "build_mpc_qp": lambda: tdi.build_mpc_qp(np.ones(4), np.zeros(4),
                                                 N=3, dim=2)[0],
        "random_box_qp": lambda: trq.random_box_qp(
            torch.Generator().manual_seed(0), n=4, m=6),
        "build_cw_rendezvous": lambda: tcw.build_cw_rendezvous(
            _cw_s0(), N=3)[0],
        "build_low_thrust_socp": lambda: tlt.build_low_thrust_socp(
            _lt_s0(), N=3)[0],
    }


@pytest.mark.parametrize("name", sorted(_default_builds()))
def test_builders_default_to_the_card(name):
    """A builder called without a device builds on the CUDA card; with
    no card it raises, and nothing falls back to the CPU."""
    from admm_library_torch.models import model_device
    assert model_device() == torch.device("cuda")
    assert model_device("cpu") == torch.device("cpu")
    build = _default_builds()[name]
    if torch.cuda.is_available():
        assert build().A.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build()
