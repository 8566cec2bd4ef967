"""Port parity for the partitioned block-tridiagonal backend: ops/spike.py
of admm_library_torch against the JAX package's on the same seeded
numpy inputs, leaf by leaf and solve by solve (f64, atol 1e-10), and the
port's versions of the properties of tests/test_spike.py: exact against
a dense solve, on the real MPC condensed matrix, through ops/kkt, and
ADMM iterates equal to the unpartitioned solver's (at horizon 20 instead
of 50, so that it takes seconds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_library_tpu as J
from admm_library_tpu.models.monte_carlo import monte_carlo_mpc
from admm_library_tpu.ops import kkt as jkkt
from admm_library_tpu.ops import spike as jspike
from admm_library_tpu.parallel.batch import solve_batch_shared as j_sbs
import admm_library_torch as T
from admm_library_torch.models.double_integrator import build_mpc_qp
from admm_library_torch.ops import kkt
from admm_library_torch.ops.spike import spike_factor, spike_solve
from admm_library_torch.problem import ConeSpec

ATOL = 1e-10
LEAVES = ("Ainv", "V", "W", "Bl", "E", "Tld", "Tll")
FIELDS = ("P", "q", "A", "l", "u", "lam")

torch.set_num_threads(1)


def _random_block_tridiag(rng, N, b):
    """tests/test_spike.py's random SPD block-tridiagonal matrix."""
    diag = rng.standard_normal((N, b, b))
    diag = np.einsum("nij,nkj->nik", diag, diag) + 5 * np.eye(b)
    low = 0.3 * rng.standard_normal((N - 1, b, b))
    n = N * b
    M = np.zeros((n, n))
    for i in range(N):
        M[i * b:(i + 1) * b, i * b:(i + 1) * b] = diag[i]
    for i in range(N - 1):
        M[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = low[i]
        M[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = low[i].T
    return M


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=0.0)


def _to_torch(qpj):
    c = qpj.cone
    return T.qp_from_numpy(
        {f: np.asarray(getattr(qpj, f)) for f in FIELDS},
        ConeSpec(m_box=c.m_box, m_l1=c.m_l1, soc_dims=tuple(c.soc_dims)),
        device="cpu")


@pytest.mark.parametrize("parts", [2, 4, 10])
def test_spike_factor_and_solve_match_jax(parts):
    rng = np.random.default_rng(0)
    M = _random_block_tridiag(rng, N=20, b=6)
    rhs = rng.standard_normal((5, 120))
    jfac = jspike.spike_factor(jnp.asarray(M), 6, parts)
    tfac = spike_factor(_t(M), 6, parts)
    assert set(tfac) == set(jfac) == set(LEAVES)
    for key in LEAVES:
        assert tuple(tfac[key].shape) == jfac[key].shape, key
        _close(tfac[key], jfac[key])
    _close(spike_solve(tfac, _t(rhs)),
           jspike.spike_solve(jfac, jnp.asarray(rhs)))
    # One rhs and two leading dims.
    _close(spike_solve(tfac, _t(rhs[0])),
           jspike.spike_solve(jfac, jnp.asarray(rhs[0])))
    r3 = rhs[:4].reshape(2, 2, 120)
    _close(spike_solve(tfac, _t(r3)), jspike.spike_solve(jfac,
                                                         jnp.asarray(r3)))


@pytest.mark.parametrize("parts", [2, 4, 10])
def test_spike_matches_dense(parts):
    rng = np.random.default_rng(0)
    M = _random_block_tridiag(rng, N=20, b=6)
    rhs = _t(rng.standard_normal((5, 120)))
    x = spike_solve(spike_factor(_t(M), 6, parts), rhs)
    assert float((x @ _t(M).T - rhs).abs().max()) < 1e-10


def test_spike_one_factor_per_lane_matches_jax():
    """M (B, n, n) with rhs (B, n), as `solve_batch` holds them; the
    reference reaches this shape under vmap."""
    rng = np.random.default_rng(1)
    Ms = np.stack([_random_block_tridiag(rng, N=8, b=3) for _ in range(3)])
    rhs = rng.standard_normal((3, 24))

    def jref(M, r):
        fac = jspike.spike_factor(M, 3, 4)
        return fac, jspike.spike_solve(fac, r)

    jfac, jx = jax.vmap(jref)(jnp.asarray(Ms), jnp.asarray(rhs))
    tfac = spike_factor(_t(Ms), 3, 4)
    for key in LEAVES:
        assert tfac[key].shape[0] == 3, key
        _close(tfac[key], jfac[key])
    _close(spike_solve(tfac, _t(rhs)), jx)


def test_spike_raises_as_the_reference():
    M = _t(_random_block_tridiag(np.random.default_rng(2), N=6, b=2))
    for b, parts, msg in ((5, 2, "not divisible by block size"),
                          (2, 4, "not divisible by 4 parts"),
                          (2, 6, "need >=2 blocks per part")):
        with pytest.raises(ValueError, match=msg):
            spike_factor(M, b, parts)
        with pytest.raises(ValueError, match=msg):
            jspike.spike_factor(jnp.asarray(M.numpy()), b, parts)
    P, A = torch.eye(12, dtype=torch.float64), torch.eye(12,
                                                         dtype=torch.float64)
    rho = torch.ones(12, dtype=torch.float64)
    for bb, sp in ((0, 2), (2, 0)):
        with pytest.raises(ValueError, match="spike backend requires"):
            kkt.factor_condensed(P, A, 1e-6, rho, "spike", band_block=bb,
                                 spike_parts=sp)


def test_spike_on_mpc_condensed():
    """The real MPC condensed matrix (config 5's shape, N=50, dim 3)."""
    qpj, spec, _ = monte_carlo_mpc(jax.random.PRNGKey(0), batch=4, N=50,
                                   dim=3, dtype=jnp.float64)
    qp = _to_torch(qpj)
    rho = 0.1 * torch.ones(qp.m, dtype=torch.float64)
    M = kkt.condensed_matrix(qp.P, qp.A, 1e-6, rho)
    rhs = _t(np.random.default_rng(1).standard_normal((3, qp.n)))
    x = spike_solve(spike_factor(M, spec.block, 10), rhs)
    assert float((x @ M.T - rhs).abs().max()) < 1e-9
    # M carries only the 1e-8 state regularisation plus sigma, so two f64
    # implementations agree relative to the solution's scale (measured
    # 1.2e-10), not to 1e-10 absolute at |x| ~ 500.
    jM = jkkt.condensed_matrix(qpj.P, qpj.A, 1e-6,
                               0.1 * jnp.ones(qpj.m, jnp.float64))
    _close(x, jspike.spike_solve(jspike.spike_factor(jM, spec.block, 10),
                                 jnp.asarray(rhs.numpy())),
           atol=1e-9 * float(x.abs().max()))


def test_spike_backend_plumbing():
    """factor_condensed / solve_condensed with 'spike' agree with 'chol'
    and with the reference's 'spike', refinement included."""
    qpj, spec, _ = monte_carlo_mpc(jax.random.PRNGKey(2), batch=2, N=10,
                                   dim=2, dtype=jnp.float64)
    qp = _to_torch(qpj)
    rho = 0.3 * torch.ones(qp.m, dtype=torch.float64)
    fs = kkt.factor_condensed(qp.P, qp.A, 1e-6, rho, "spike",
                              band_block=spec.block, spike_parts=5)
    fc = kkt.factor_condensed(qp.P, qp.A, 1e-6, rho, "chol")
    rhs = _t(np.random.default_rng(3).standard_normal((4, qp.n)))
    xs = kkt.solve_condensed(fs, rhs, "spike", refine_steps=1)
    xc = kkt.solve_condensed(fc, rhs, "chol")
    assert float((xs - xc).abs().max()) < 1e-9
    jfs = jkkt.factor_condensed(qpj.P, qpj.A, 1e-6,
                                0.3 * jnp.ones(qpj.m, jnp.float64), "spike",
                                band_block=spec.block, spike_parts=5)
    _close(xs, jkkt.solve_condensed(jfs, jnp.asarray(rhs.numpy()), "spike",
                                    refine_steps=1))


def test_spike_admm_iterates_match_unpartitioned():
    """ADMM with the spike x-update takes the same iterations as the
    unpartitioned 'chol' solver on a Monte-Carlo batch and lands on the
    same solution, in the port and in the reference alike (horizon 20,
    10 parts of 2 blocks)."""
    qpj, spec, _ = monte_carlo_mpc(jax.random.PRNGKey(0), batch=8, N=20,
                                   dim=3, dtype=jnp.float64)
    qp = _to_torch(qpj)
    base = T.Settings(eps_abs=1e-6, eps_rel=1e-6, precision="double",
                      band_block=spec.block)
    ref = T.solve_batch_shared(qp, base.replace(backend="chol"))
    spk = T.solve_batch_shared(
        qp, base.replace(backend="spike", spike_parts=10))
    assert bool((ref.status == int(T.Status.SOLVED)).all())
    assert bool((spk.status == int(T.Status.SOLVED)).all())
    assert torch.equal(ref.iters, spk.iters)
    dx = float((ref.x - spk.x).abs().max())
    assert dx < 1e-6 * (1.0 + float(ref.x.abs().max()))
    jspk = j_sbs(
        qpj, J.Settings(eps_abs=1e-6, eps_rel=1e-6, precision="double",
                        band_block=spec.block, backend="spike",
                        spike_parts=10))
    np.testing.assert_array_equal(spk.iters.numpy(), np.asarray(jspk.iters))
    np.testing.assert_allclose(spk.x.numpy(), np.asarray(jspk.x),
                               atol=1e-6)


def test_spike_single_solve():
    """solve() takes backend='spike' for one banded QP."""
    s0 = np.array([1.0, -2.0, 0.5, 0.1, -0.1, 0.0])
    qp, spec = build_mpc_qp(s0, np.zeros(6), N=20, dim=3,
                            dtype=torch.float64, device="cpu")
    s = T.Settings(eps_abs=1e-6, eps_rel=1e-6, band_block=spec.block,
                   backend="spike", spike_parts=4, precision="double")
    sol = T.solve(qp, s)
    assert int(sol.status) == int(T.Status.SOLVED)
    assert float(sol.r_prim) < 1e-6 and float(sol.r_dual) < 1e-6
