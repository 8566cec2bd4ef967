"""Port parity for core/polish.py: `polish` of admm_library_torch against
the JAX package's on the same input point.

Each case builds its problem with the JAX package, gets an unconverged
point from a loose JAX solve and polishes that same point in both
packages (f64 on the CPU). Bar: the same accepted/rejected verdict and
status, and x, z, y within POINT_ATOL of JAX's (both sides factor the
same matrix in f64, but delta = 1e-7 makes that matrix ill-conditioned,
so LAPACK rounding differences show: measured ≤ 3e-9 apart).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_library_tpu as J
from admm_library_tpu.core.polish import polish as jpolish
from admm_library_tpu.models import clohessy_wiltshire as jcw
from admm_library_tpu.problem import ConeSpec as JCone
from admm_library_tpu.problem import QPData as JQP
import admm_library_torch as T
from admm_library_torch.core.polish import polish as tpolish
from admm_library_torch.ops.kkt import cholesky_or_nan
from admm_library_torch.problem import ConeSpec

FIELDS = ("P", "q", "A", "l", "u", "lam")
SOL_FIELDS = ("x", "z", "y", "status", "iters", "r_prim", "r_dual", "obj",
              "rho", "history")
POINT_ATOL = RTOL = 1e-8

# Small shapes: one intra-op thread keeps the CPU free for the other
# test workers.
torch.set_num_threads(1)


def _to_torch(qpj):
    c = qpj.cone
    return T.qp_from_numpy(
        {f: np.asarray(getattr(qpj, f)) for f in FIELDS},
        ConeSpec(m_box=c.m_box, m_l1=c.m_l1, soc_dims=tuple(c.soc_dims)),
        device="cpu")


def _sol_to_torch(sol):
    return T.Solution(**{f: torch.from_numpy(np.array(getattr(sol, f)))
                         for f in SOL_FIELDS})


def _loose_settings(**kw):
    # One f64 phase at a coarse tolerance: an unconverged start point.
    base = dict(eps_abs=1e-2, eps_rel=0.0, max_iter=2000,
                precision="double", polish=False, recenter_rounds=0,
                restart_every=0, stall_checks=0)
    return J.Settings(**{**base, **kw})


def _soc_projection():
    """min ½‖x − c‖² s.t. x ∈ SOC(3), c = (1, 2, 0) outside the cone:
    x* = (1.5, 1.5, 0)."""
    c = jnp.array([1.0, 2.0, 0.0])
    return JQP(P=jnp.eye(3), q=-c, A=jnp.eye(3), l=jnp.full(3, -jnp.inf),
               u=jnp.full(3, jnp.inf), lam=jnp.zeros(0),
               cone=JCone(soc_dims=(3,)))


def _soc_mixed():
    """Box rows and two SOC blocks, one active and one interior."""
    rng = np.random.default_rng(7)
    n, mb = 6, 4
    G = rng.normal(size=(n, n))
    q = rng.normal(size=n) * 5.0
    A = np.vstack([rng.normal(size=(mb, n)), rng.normal(size=(3, n)),
                   10.0 * np.abs(rng.normal(size=n)),
                   0.1 * rng.normal(size=(2, n))])
    return JQP(P=jnp.asarray(G @ G.T + n * np.eye(n)), q=jnp.asarray(q),
               A=jnp.asarray(A),
               l=jnp.concatenate([jnp.full(mb, -1.0), jnp.full(6, -jnp.inf)]),
               u=jnp.concatenate([jnp.full(mb, 1.0), jnp.full(6, jnp.inf)]),
               lam=jnp.zeros(0), cone=JCone(m_box=mb, soc_dims=(3, 3)))


def _soc_interior():
    """Unconstrained minimum (2, 0.3, 0) strictly inside SOC(3)."""
    xstar = jnp.array([2.0, 0.3, 0.0])
    return JQP(P=jnp.eye(3), q=-xstar, A=jnp.eye(3),
               l=jnp.full(3, -jnp.inf), u=jnp.full(3, jnp.inf),
               lam=jnp.zeros(0), cone=JCone(soc_dims=(3,)))


def _soc_non_uniform():
    """soc_dims (3, 4): the fallback that never activates SOC rows."""
    c = jnp.arange(1.0, 8.0)
    return JQP(P=jnp.eye(7), q=-c, A=jnp.eye(7), l=jnp.full(7, -jnp.inf),
               u=jnp.full(7, jnp.inf), lam=jnp.zeros(0),
               cone=JCone(soc_dims=(3, 4)))


def _cw_l1():
    """The CW min-fuel LP at N=10 (bounded L1 rows, equality rows)."""
    s0 = np.array([100.0, -800.0, 30.0, 0.1, 0.4, -0.02])
    return jcw.build_cw_rendezvous(s0, N=10, dt=600.0, dv_max=2.0,
                                   dtype=jnp.float64)[0]


# (problem, loose-solve settings, polish eps_abs, SOLVED after polish;
# None: not asserted)
_CASES = {
    "soc_projection": (_soc_projection, {}, 1e-6, True),
    "soc_mixed": (_soc_mixed, {}, 1e-6, True),
    "soc_interior": (_soc_interior, {}, 1e-6, True),
    "soc_non_uniform": (_soc_non_uniform, {}, 1e-6, None),
    "cw_l1": (_cw_l1, dict(eps_abs=1e-4, max_iter=20000), 1e-6, True),
}


def _polish_both(qpj, jsol0, eps_abs, **kw):
    jp = jpolish(qpj, jsol0, eps_abs=eps_abs, eps_rel=0.0, **kw)
    tp = tpolish(_to_torch(qpj), _sol_to_torch(jsol0), eps_abs=eps_abs,
                 eps_rel=0.0, **kw)
    return jp, tp


def _assert_same(jp, tp, atol=POINT_ATOL):
    assert int(tp.status) == int(jp.status)
    assert tp.status.dtype == torch.int32
    for f in ("x", "z", "y"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), atol=atol,
                                   rtol=RTOL, err_msg=f)
    np.testing.assert_allclose(float(tp.r_prim), float(jp.r_prim),
                               atol=atol, rtol=1e-6)
    np.testing.assert_allclose(float(tp.r_dual), float(jp.r_dual),
                               atol=atol, rtol=1e-6)
    np.testing.assert_allclose(float(tp.obj), float(jp.obj), rtol=1e-9,
                               atol=atol)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_polish_matches_jax(case):
    make, loose, eps_abs, solved = _CASES[case]
    qpj = make()
    jsol0 = J.solve(qpj, _loose_settings(**loose))
    jp, tp = _polish_both(qpj, jsol0, eps_abs)
    _assert_same(jp, tp)
    # The same accepted/rejected verdict: the input point comes back
    # unchanged exactly when it was rejected.
    x0 = np.asarray(jsol0.x)
    assert (np.array_equal(tp.x.numpy(), x0)
            == np.array_equal(np.asarray(jp.x), x0))
    if solved is not None:
        assert (int(tp.status) == int(T.Status.SOLVED)) == solved
    if case == "soc_projection":
        np.testing.assert_allclose(tp.x.numpy(), [1.5, 1.5, 0.0], atol=1e-6)
    if case == "soc_non_uniform":
        # The fallback keeps a point no worse than the input.
        assert float(torch.maximum(tp.r_prim, tp.r_dual)) <= float(
            max(jsol0.r_prim, jsol0.r_dual)) + 1e-12


def test_polish_keeps_infeasibility_status():
    """Only infeasibility and numerical-error verdicts pass through an
    unaccepted polish; anything else unconverged reports MAX_ITER."""
    qpj = _soc_non_uniform()
    jsol0 = J.solve(qpj, _loose_settings(max_iter=25))
    for st in (J.Status.PRIMAL_INFEASIBLE, J.Status.STALLED):
        js = dataclasses.replace(jsol0, status=jnp.int32(int(st)))
        jp, tp = _polish_both(qpj, js, 1e-12)
        assert int(jp.status) != int(J.Status.SOLVED)
        _assert_same(jp, tp)


def _non_pd():
    """A concave objective with no active row: P + delta I is negative
    definite, so the factor fails in both packages."""
    return JQP(P=-jnp.eye(3), q=jnp.ones(3), A=jnp.eye(3),
               l=jnp.full(3, -10.0), u=jnp.full(3, 10.0), lam=jnp.zeros(0),
               cone=JCone(m_box=3))


@pytest.mark.parametrize("force_accept", [False, True])
def test_non_pd_system_is_rejected(force_accept):
    """jnp.linalg.cholesky returns NaN on a matrix that is not positive
    definite; the port's factor is poisoned with NaN to match, so the
    finiteness veto rejects the candidate (even under force_accept) and
    the input point comes back."""
    qpj = _non_pd()
    zeros = jnp.zeros(3)
    jsol0 = J.Solution(x=zeros, z=zeros, y=zeros,
                       status=jnp.int32(int(J.Status.MAX_ITER)),
                       iters=jnp.int32(7), r_prim=jnp.float64(1.0),
                       r_dual=jnp.float64(1.0), obj=jnp.float64(0.0),
                       rho=jnp.float64(0.1), history=jnp.zeros((0, 3)))
    jp, tp = _polish_both(qpj, jsol0, 1e-6, force_accept=force_accept)
    jl = np.asarray(jnp.linalg.cholesky(-jnp.eye(3)))
    assert np.isnan(jl[np.tril_indices(3)]).all()
    _assert_same(jp, tp)
    assert torch.equal(tp.x, torch.zeros(3, dtype=torch.float64))
    assert int(tp.status) == int(T.Status.MAX_ITER)
    assert int(tp.iters) == 7


def test_cholesky_or_nan():
    M = torch.tensor([[4.0, 2.0], [2.0, 3.0]], dtype=torch.float64)
    torch.testing.assert_close(cholesky_or_nan(M), torch.linalg.cholesky(M),
                               rtol=0.0, atol=0.0)
    bad = torch.stack([M, -M])
    L = cholesky_or_nan(bad)
    assert bool(torch.isfinite(L[0]).all()) and bool(torch.isnan(L[1]).all())


def test_force_accept_returns_the_candidate():
    """A candidate that misses the criterion (eps 1e-14 is below what
    the AL passes reach) is rejected unless force_accept; forced, the
    port returns the same candidate as JAX."""
    qpj = _soc_mixed()
    jsol0 = J.solve(qpj, _loose_settings())
    jp, tp = _polish_both(qpj, jsol0, 1e-14)
    _assert_same(jp, tp)
    assert np.array_equal(tp.x.numpy(), np.asarray(jsol0.x))
    jf, tf = _polish_both(qpj, jsol0, 1e-14, force_accept=True)
    _assert_same(jf, tf)
    assert not np.array_equal(tf.x.numpy(), np.asarray(jsol0.x))
    assert int(tf.status) != int(T.Status.SOLVED)
