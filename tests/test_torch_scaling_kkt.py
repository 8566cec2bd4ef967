"""Port parity: Ruiz equilibration and the condensed-KKT factor/solve
of admm_library_torch against the JAX package, in f64.

The problem is built by the JAX package and carried across with
qp_from_numpy (the port's data bridge). Ruiz is elementwise scaling
plus max/mean reductions: agreement to 1e-12 relative. The factor and
solves go through different LAPACK/BLAS call sequences: agreement to
1e-9 relative on a matrix of condition ~1e3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_library_tpu.core import admm as jadmm
from admm_library_tpu.core import scaling as jscal
from admm_library_tpu.ops import kkt as jkkt
from admm_library_tpu import Settings as JSettings
from admm_library_tpu.problem import ConeSpec as JCone, make_qp
from admm_library_torch.core import admm as tadmm
from admm_library_torch.core import scaling as tscal
from admm_library_torch.ops import kkt as tkkt
from admm_library_torch import Settings as TSettings
from admm_library_torch.problem import ConeSpec as TCone, qp_from_numpy

FIELDS = ("P", "q", "A", "l", "u", "lam")

# Small shapes: one intra-op thread keeps the CPU free for the other
# test workers.
torch.set_num_threads(1)


def _problem(batch=None, seed=0, soc_dims=(3, 3, 3)):
    """Box + L1 + SOC problem, optionally with (B, m) bounds."""
    rng = np.random.default_rng(seed)
    n, mb, ml = 12, 6, 4
    m = mb + ml + sum(soc_dims)
    R = rng.standard_normal((n, n))
    P = R @ R.T / n + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n)) * np.exp(rng.standard_normal((m, 1)))
    q = rng.standard_normal(n) * 5
    shape = (m,) if batch is None else (batch, m)
    l = np.full(shape, -np.inf)
    u = np.full(shape, np.inf)
    l[..., :mb] = -rng.random(shape[:-1] + (mb,))
    u[..., :mb] = rng.random(shape[:-1] + (mb,))
    u[..., 0] = l[..., 0]                      # an equality row
    u[..., 1] = np.inf
    jc = JCone(m_box=mb, m_l1=ml, soc_dims=soc_dims)
    jqp = make_qp(jnp.asarray(P), q, A, l, u, cone=jc,
                  lam=rng.random(ml) + 0.1)
    tqp = qp_from_numpy({f: np.asarray(getattr(jqp, f)) for f in FIELDS},
                        TCone(m_box=mb, m_l1=ml, soc_dims=soc_dims),
                        device="cpu")
    return jqp, tqp


def _close(t, j, rtol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=rtol * 1e-3)


def test_qp_from_numpy_roundtrip():
    jqp, tqp = _problem()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tqp, f).numpy(),
                                      np.asarray(getattr(jqp, f)))
    assert tqp.dtype == torch.float64 and (tqp.n, tqp.m) == (jqp.n, jqp.m)


@pytest.mark.parametrize("iters", [0, 1, 10])
def test_ruiz_equilibrate(iters):
    jqp, tqp = _problem()
    jqs, js = jscal.ruiz_equilibrate(jqp, iters)
    tqs, ts = tscal.ruiz_equilibrate(tqp, iters)
    for f in FIELDS:
        _close(getattr(tqs, f), getattr(jqs, f), 1e-12)
    for f in ("d", "e", "c"):
        _close(getattr(ts, f), getattr(js, f), 1e-12)
    # SOC blocks keep one factor per block.
    e_soc = ts.e[-9:].reshape(3, 3)
    torch.testing.assert_close(e_soc, e_soc[:, :1].expand(3, 3))


def test_scale_qp_batched_bounds():
    jqp, tqp = _problem(batch=3, seed=1)
    _, js = jscal.ruiz_equilibrate(
        jqp.__class__(P=jqp.P, q=jqp.q, A=jqp.A, l=jqp.l[0], u=jqp.u[0],
                      lam=jqp.lam, cone=jqp.cone), 10)
    ts = tscal.Scaling(*(torch.from_numpy(np.array(getattr(js, f)))
                         for f in ("d", "e", "c")))
    jqs = jscal.scale_qp(jqp, js)
    tqs = tscal.scale_qp(tqp, ts)
    for f in FIELDS:
        _close(getattr(tqs, f), getattr(jqs, f), 1e-14)
    x = np.random.default_rng(2).standard_normal((3, tqp.n))
    _close(ts.unscale_x(ts.scale_x(torch.from_numpy(x))), x, 1e-14)


@pytest.mark.parametrize("backend", ["inv", "chol"])
@pytest.mark.parametrize("refine", [0, 1, 2])
def test_factor_and_solve(backend, refine):
    jqp, tqp = _problem()
    rng = np.random.default_rng(3)
    rho = rng.random(tqp.m) + 0.05
    sigma = 1e-6
    jfac = jkkt.factor_condensed(jqp.P, jqp.A, sigma, jnp.asarray(rho),
                                 backend)
    tfac = tkkt.factor_condensed(tqp.P, tqp.A, sigma,
                                 torch.from_numpy(rho), backend)
    _close(tfac["M"], jfac["M"], 1e-12)
    key = "Minv" if backend == "inv" else "L"
    _close(tfac[key], jfac[key], 1e-9)
    rhs = rng.standard_normal((4, tqp.n))
    got = tkkt.solve_condensed(tfac, torch.from_numpy(rhs), backend,
                               refine_steps=refine)
    ref = jkkt.solve_condensed(jfac, jnp.asarray(rhs), backend,
                               refine_steps=refine)
    _close(got, ref, 1e-9)
    # And it solves the system.
    _close(got @ tfac["M"], rhs, 1e-9)


def test_factor_not_positive_definite_gives_nan():
    """torch.linalg.cholesky raises where JAX returns NaN; the port
    returns NaN so the solver's NaN tripwire sets NUMERICAL_ERROR."""
    P = -torch.eye(3, dtype=torch.float64)
    A = torch.zeros((2, 3), dtype=torch.float64)
    rho = torch.ones(2, dtype=torch.float64)
    for backend, key in (("inv", "Minv"), ("chol", "L")):
        fac = tkkt.factor_condensed(P, A, 1e-6, rho, backend)
        assert torch.isnan(fac[key]).all()


@pytest.mark.parametrize("soc_dims", [(3, 3, 3), (2, 4, 3)],
                         ids=["uniform", "ragged"])
def test_residuals_and_infeasibility(soc_dims):
    """Residual norms and the infeasibility certificates on scaled data,
    for random iterates and deltas (exact zeros and tiny steps included).
    Certificates that fire are covered by the batch solves in
    test_torch_batch."""
    jqp, tqp = _problem(batch=4, seed=5, soc_dims=soc_dims)
    jqs, js = jscal.ruiz_equilibrate(jqp.__class__(
        P=jqp.P, q=jqp.q, A=jqp.A, l=jqp.l[0], u=jqp.u[0], lam=jqp.lam,
        cone=jqp.cone), 10)
    jqs = jscal.scale_qp(jqp, js)
    ts = tscal.Scaling(*(torch.from_numpy(np.array(getattr(js, f)))
                         for f in ("d", "e", "c")))
    tqs = tscal.scale_qp(tqp, ts)
    rng = np.random.default_rng(6)
    x, dx = rng.standard_normal((2, 4, tqp.n))
    z, y, dy = rng.standard_normal((3, 4, tqp.m))
    dy[1] = 0.0                                # a lane with no dual move
    dx[2] *= 1e-9
    jres = jadmm.residuals(jqs, js, x, z, y)
    tres = tadmm.residuals(tqs, ts, *map(torch.from_numpy, (x, z, y)))
    for t, j in zip(tres, jres):
        _close(t, j, 1e-12)
    s = JSettings()
    for ddx, ddy in ((dx, dy), (dx, -np.abs(dy)), (np.zeros_like(dx), dy)):
        jp, jd = jadmm.infeasibility(jqs, js, ddx, ddy, s)
        tp, td = tadmm.infeasibility(tqs, ts, torch.from_numpy(ddx),
                                     torch.from_numpy(ddy), TSettings())
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
