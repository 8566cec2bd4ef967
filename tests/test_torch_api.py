"""Port parity for the single-problem entry point: `solve` and
`core.admm.run_admm` of admm_library_torch against the JAX package.

Problems are built by the JAX package and carried across with
qp_from_numpy; `backend` is pinned on both sides. The bar is the
repo's parity bar: the same status, an iteration count within one
check interval (25), and solutions within X_ATOL (each side meets the
1e-6 criterion of a strongly convex problem; measured ≤ 6e-7 apart).
run_admm on one scaled f64 problem follows the same trajectory in both
packages: the same checks, restarts and rho updates, iterates within
1e-7 (measured ≤ 2e-8; the CG solves stop at a 1e-9 relative residual).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_library_tpu as J
from admm_library_tpu import api as japi
from admm_library_tpu.core import admm as jadmm
from admm_library_tpu.core.scaling import ruiz_equilibrate as jruiz
from admm_library_tpu.models import double_integrator as jdi
from admm_library_tpu.models.random_qp import random_box_qp
from admm_library_tpu.models.random_qp import random_eq_ineq_qp
from admm_library_tpu.problem import ConeSpec as JCone
from admm_library_tpu.problem import make_qp as jmake_qp
import admm_library_torch as T
from admm_library_torch import api as tapi
from admm_library_torch.core import admm as tadmm
from admm_library_torch.core.scaling import Scaling
from admm_library_torch.problem import ConeSpec, QPData

FIELDS = ("P", "q", "A", "l", "u", "lam")
CHECK = 25
X_ATOL = 1e-5

# Small shapes: one intra-op thread keeps the CPU free for the other
# test workers.
torch.set_num_threads(1)


def _to_torch(qpj):
    c = qpj.cone
    return T.qp_from_numpy(
        {f: np.asarray(getattr(qpj, f)) for f in FIELDS},
        ConeSpec(m_box=c.m_box, m_l1=c.m_l1, soc_dims=tuple(c.soc_dims)),
        device="cpu")


def _settings(**kw):
    js = J.Settings(**kw)
    return js, T.Settings(**dataclasses.asdict(js))


def _compare(jsol, tsol, x_atol=X_ATOL):
    assert int(tsol.status) == int(jsol.status)
    assert abs(int(tsol.iters) - int(jsol.iters)) <= CHECK, (
        int(jsol.iters), int(tsol.iters))
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x),
                               atol=x_atol)


@pytest.mark.parametrize("backend", ["pallas_cg", "cg", "inv", "chol"])
def test_random_box_qp_matches_jax(backend):
    qpj = random_box_qp(jax.random.key(13), n=30, m=60)
    js, ts = _settings(backend=backend)
    jsol = J.solve(qpj, js)
    tsol = T.solve(_to_torch(qpj), ts)
    _compare(jsol, tsol)
    assert int(tsol.status) == int(T.Status.SOLVED)
    assert tsol.x.shape == (30,) and tsol.x.dtype == torch.float32


@pytest.mark.parametrize("backend", ["pallas_cg", "inv"])
def test_small_mpc_matches_jax(backend):
    """Config 2's rendezvous MPC at horizon 8, band_block set as the
    reference's bench sets it."""
    rng = np.random.default_rng(0)
    s0 = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(-0.2, 0.2, 3)])
    qpj, spec = jdi.build_mpc_qp(s0, np.zeros(6), N=8, dim=3)
    js, ts = _settings(backend=backend, band_block=spec.block)
    _compare(J.solve(qpj, js), T.solve(_to_torch(qpj), ts))


def _soc_problem(seed=0):
    """Box rows and two uniform SOC blocks; at the default max_iter the
    shared pass solves it, so the f64 continuation never runs."""
    rng = np.random.default_rng(seed)
    n, mb, d, nb = 8, 4, 3, 2
    m = mb + d * nb
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    l = np.full(m, -np.inf)
    u = np.full(m, np.inf)
    l[:mb], u[:mb] = -0.3, 0.3
    return jmake_qp(jnp.asarray(R @ R.T + 0.5 * np.eye(n)),
                    rng.standard_normal(n),
                    rng.standard_normal((m, n)) / np.sqrt(n), l, u,
                    cone=JCone(m_box=mb, soc_dims=(d,) * nb))


@pytest.mark.parametrize("backend", ["pallas_cg", "inv"])
def test_soc_problem_through_the_batch_matches_jax(backend, monkeypatch):
    calls = []
    monkeypatch.setattr(japi, "_f64_continuation",
                        lambda *a, **k: calls.append(1))
    qpj = _soc_problem()
    js, ts = _settings(backend=backend)
    jsol = J.solve(qpj, js)
    assert not calls
    _compare(jsol, T.solve(_to_torch(qpj), ts))


def _eq_ineq():
    return random_eq_ineq_qp(jax.random.key(3), n=30, m_eq=5, m_in=40)


@pytest.mark.parametrize("backend,precision", [
    ("cg", "single"), ("cg", "double"), ("pallas_cg", "single"),
    ("pallas_cg", "double"), ("chol", "double")])
def test_single_and_double_precision_match_jax(backend, precision):
    """One run_admm phase in the problem's dtype (f32) or in f64. The
    start rho of 10 is far off, so the adaptive rho moves (for 'cg'
    without a refactorisation). rho_eq_scale=10 keeps M well enough
    conditioned that every CG solve converges: unconverged CG steps
    amplify rounding, and the two packages' trajectories would part.
    f32 runs at eps 1e-3, above its floor; its rho differs in the f32
    rounding of the residual ratios."""
    single = precision == "single"
    eps = 1e-3 if single else 1e-6
    js, ts = _settings(backend=backend, precision=precision, rho=10.0,
                       rho_eq_scale=10.0, eps_abs=eps, eps_rel=eps)
    qpj = _eq_ineq()
    jsol = J.solve(qpj, js)
    tsol = T.solve(_to_torch(qpj), ts)
    _compare(jsol, tsol, x_atol=1e-4 if single else X_ATOL)
    assert int(tsol.status) == int(T.Status.SOLVED)
    assert float(tsol.rho) != 10.0
    np.testing.assert_allclose(float(tsol.rho), float(jsol.rho),
                               rtol=5e-2 if single else 1e-5)
    assert tsol.x.dtype == (torch.float32 if single else torch.float64)


def test_solve_core_hybrid_matches_jax():
    qpj = random_box_qp(jax.random.key(5), n=20, m=40)
    js, ts = _settings(backend="chol")
    z = lambda k: jnp.zeros(k, jnp.float32)  # noqa: E731
    jsol = japi._solve_core(qpj, z(20), z(40), z(40), js, "chol")
    tz = lambda k: torch.zeros(k)  # noqa: E731
    tsol = tapi._solve_core(_to_torch(qpj), tz(20), tz(40), tz(40), ts,
                            "chol")
    _compare(jsol, tsol)
    assert tsol.x.dtype == torch.float32


_RUN_CASES = {
    # Restart boundary every 2 checks, adaptive rho every check from a
    # poor warm rho, a 4-slot history ring that wraps.
    "restart_rho": (dict(backend="chol", restart_every=50,
                         adaptive_rho_interval=25, history=4), 2.0),
    # Matrix-free CG: rho adapts in the operator, no refactorisation
    # (rho_eq_scale=10 lets every CG solve converge; see above).
    "cg_rho": (dict(backend="cg", adaptive_rho_interval=25, history=4,
                    rho_eq_scale=10.0), 2.0),
    # A large fixed rho: the scaled ratio stops improving for one check,
    # and stall_checks=1 ends the run there.
    "stall": (dict(backend="chol", stall_checks=1, adaptive_rho=False),
              50.0),
}


@pytest.mark.parametrize("case", sorted(_RUN_CASES))
def test_run_admm_matches_jax(case):
    kw, rho0 = _RUN_CASES[case]
    kw = dict(kw)
    backend = kw.pop("backend")
    js, ts = _settings(precision="double", **kw)
    qpj = _eq_ineq().astype(jnp.float64)
    jqs, jsc = jruiz(qpj, js.scaling_iters)
    tqs = _to_torch(jqs)
    tsc = Scaling(*(torch.from_numpy(np.array(getattr(jsc, f)))
                    for f in ("d", "e", "c")))
    n, m = tqs.n, tqs.m
    jc = jadmm.run_admm(jqs, jsc, js, jnp.zeros(n), jnp.zeros(m),
                        jnp.zeros(m), backend, rho0=rho0)
    tc = tadmm.run_admm(tqs, tsc, ts, torch.zeros(n, dtype=torch.float64),
                        torch.zeros(m, dtype=torch.float64),
                        torch.zeros(m, dtype=torch.float64), backend,
                        rho0=rho0)
    assert tc.it == int(jc.it)
    assert int(tc.status) == int(jc.status)
    np.testing.assert_allclose(float(tc.rho_bar), float(jc.rho_bar),
                               rtol=1e-6)
    for f in ("x", "z", "y"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   np.asarray(getattr(jc, f)), atol=1e-7)
    np.testing.assert_allclose(tc.hist.numpy(), np.asarray(jc.hist),
                               rtol=1e-6, atol=1e-8)
    if case == "stall":
        assert int(tc.status) == int(T.Status.STALLED)
    else:
        assert int(tc.status) == int(T.Status.SOLVED)
        assert float(tc.rho_bar) != rho0
    if backend == "cg":
        assert sorted(tc.fac) == ["A", "P", "rho", "sigma"]


def test_run_admm_reports_max_iter():
    qpj = _eq_ineq().astype(jnp.float64)
    jqs, jsc = jruiz(qpj, 10)
    tqs = _to_torch(jqs)
    tsc = Scaling(*(torch.from_numpy(np.array(getattr(jsc, f)))
                    for f in ("d", "e", "c")))
    z = lambda k: torch.zeros(k, dtype=torch.float64)  # noqa: E731
    c = tadmm.run_admm(tqs, tsc, T.Settings(max_iter=50), z(tqs.n),
                       z(tqs.m), z(tqs.m), "chol")
    assert c.it == 50 and int(c.status) == int(T.Status.MAX_ITER)


def _equality_qp():
    """min ½|x|² s.t. Ax = b, b ≠ 0: r_prim = r_dual = 0 at
    x = z = y = 0, which is not a solution (z = 0 violates l = u = b)."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((2, 3))
    b = np.array([1.0, -0.5])
    return T.make_qp(np.eye(3), np.zeros(3), A, b, b, device="cpu")


def test_warm_start_outside_the_constraints_is_not_solved():
    qp = _equality_qp()
    zeros = lambda k: torch.zeros(k, dtype=torch.float64)  # noqa: E731
    sol = T.solve(qp, T.Settings(), x0=zeros(3), z0=zeros(2), y0=zeros(2))
    assert int(sol.iters) > 0
    assert int(sol.status) == int(T.Status.SOLVED)
    torch.testing.assert_close(qp.A @ sol.x, qp.u, atol=1e-5, rtol=0.0)


@pytest.mark.parametrize("problem", ["box", "soc"])
def test_warm_start_from_a_solution_returns_at_once(problem):
    qpj = (random_box_qp(jax.random.key(2), n=12, m=24)
           if problem == "box" else _soc_problem())
    qp = _to_torch(qpj).astype(torch.float64)
    s = T.Settings(backend="inv")
    sol = T.solve(qp, s)
    assert int(sol.status) == int(T.Status.SOLVED)
    warm = T.solve(qp, s, x0=sol.x, z0=sol.z, y0=sol.y)
    assert int(warm.status) == int(T.Status.SOLVED)
    assert int(warm.iters) == 0
    assert torch.equal(warm.x, sol.x)


def test_batched_problem_is_rejected():
    qp = _to_torch(random_box_qp(jax.random.key(2), n=6, m=8))
    qpb = QPData(P=qp.P, q=qp.q, A=qp.A, l=qp.l[None].expand(2, 8),
                 u=qp.u[None].expand(2, 8), lam=qp.lam, cone=qp.cone)
    with pytest.raises(ValueError, match="solve_batch_shared"):
        T.solve(qpb)


@pytest.mark.parametrize("case", ["l1", "no_rounds"])
def test_staged_path_takes_l1_and_no_rounds(case, monkeypatch):
    """Hybrid L1 problems and recenter_rounds=0 take the staged path,
    never the batch delegation, and finish as in JAX."""
    import admm_library_torch.parallel.batch as tbatch
    taken = []
    staged = tapi._solve_staged
    monkeypatch.setattr(tapi, "_solve_staged",
                        lambda *a, **k: taken.append(1) or staged(*a, **k))
    monkeypatch.setattr(tbatch, "solve_batch_shared", None)
    if case == "l1":
        qpj = jmake_qp(np.eye(2), np.ones(2), np.eye(2), -np.ones(2),
                       np.ones(2), cone=JCone(m_box=1, m_l1=1), lam=[0.5])
        js, ts = _settings(backend="chol")
    else:
        qpj = random_box_qp(jax.random.key(2), n=6, m=8)
        js, ts = _settings(backend="chol", recenter_rounds=0)
    _compare(J.solve(qpj, js), T.solve(_to_torch(qpj), ts))
    assert taken == [1]


def test_unsolved_soc_problem_continues_in_f64(monkeypatch):
    """An SOC problem that the shared pass leaves unsolved (max_iter 25)
    continues in `_f64_continuation`, in both packages."""
    calls = []
    cont = japi._f64_continuation
    monkeypatch.setattr(japi, "_f64_continuation",
                        lambda *a, **k: calls.append(1) or cont(*a, **k))
    qpj = _soc_problem()
    js, ts = _settings(max_iter=25, backend="chol")
    jsol = J.solve(qpj, js)
    assert calls == [1]
    tsol = T.solve(_to_torch(qpj), ts)
    _compare(jsol, tsol)
    assert int(tsol.status) == int(T.Status.SOLVED)


def test_make_qp_device_default():
    """Numpy input builds on the CUDA card, as the model builders do (with
    no card that raises) unless device='cpu'; tensor input keeps its
    device."""
    arrays = (np.eye(2), np.zeros(2), np.eye(2), -np.ones(2), np.ones(2))
    if torch.cuda.is_available():
        assert T.make_qp(*arrays).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            T.make_qp(*arrays)
    assert T.make_qp(*arrays, device="cpu").device.type == "cpu"
    tensors = [torch.as_tensor(a) for a in arrays]
    assert T.make_qp(*tensors).device == tensors[0].device
