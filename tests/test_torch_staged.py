"""Port parity for the single-problem endgame of the hybrid pipeline:
the staged path of `solve` (f32 phase → polish → re-centred rounds →
f64 phase → polish), `_recentered_rounds` and `_f64_continuation`,
against the JAX package on the same inputs (CPU, problems built by the
JAX builders and carried across with qp_from_numpy).

Bars: the same status; iterations within one check interval (25);
solutions within X_ATOL (each side polishes to machine-level residuals
at the same vertex of the min-fuel LP: measured ≤ 1e-9 apart);
objectives within 1e-4 relative on the degenerate low-thrust SOCP,
whose solutions differ along flat directions of the objective.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_library_tpu as J
from admm_library_tpu import api as japi
from admm_library_tpu.models import clohessy_wiltshire as jcw
from admm_library_tpu.models import low_thrust as jlt
from admm_library_tpu.models.random_qp import random_box_qp
import admm_library_torch as T
from admm_library_torch import api as tapi
from admm_library_torch.problem import ConeSpec

FIELDS = ("P", "q", "A", "l", "u", "lam")
SOL_FIELDS = ("x", "z", "y", "status", "iters", "r_prim", "r_dual", "obj",
              "rho", "history")
CHECK = 25
X_ATOL = 1e-6
OBJ_RTOL = 1e-4

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


def _settings(**kw):
    js = J.Settings(**kw)
    return js, T.Settings(**dataclasses.asdict(js))


def _config3():
    """BASELINE config 3 as the reference bench builds it (bench_cw,
    seed 0): N=20, n=60, m=66, f32 data."""
    rng = np.random.default_rng(0)
    s0 = np.array([100.0, -1000.0, 20.0, 0.1, 0.5, -0.05])
    s0[:3] += rng.uniform(-20, 20, 3)
    return jcw.build_cw_rendezvous(s0, N=20)[0]


def _small_cw():
    s0 = np.array([100.0, -800.0, 30.0, 0.1, 0.4, -0.02])
    return jcw.build_cw_rendezvous(s0, N=10, dt=600.0, dv_max=2.0)[0]


def _compare(jsol, tsol, x_atol=X_ATOL, iters=True):
    assert int(tsol.status) == int(jsol.status)
    if iters:
        assert abs(int(tsol.iters) - int(jsol.iters)) <= CHECK, (
            int(jsol.iters), int(tsol.iters))
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x),
                               atol=x_atol, rtol=0.0)


class _Spy:
    """Counts the calls of module.name and forwards them."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        inner = getattr(module, name)

        def wrapped(*a, **k):
            self.calls += 1
            return inner(*a, **k)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("backend", ["chol", "pallas_cg"])
def test_config3_full_size_matches_jax(backend, monkeypatch):
    """The L1 min-fuel LP goes through the staged path in both packages
    (never through the batch delegation) and lands SOLVED by polish, at
    the same point. With 'pallas_cg' the iteration counts are not
    compared: in the f32 phase no 200-step CG solve reaches its 1e-9
    tolerance, the two packages' unconverged solves round differently,
    and the chattering LP phase ends at another check (measured: JAX
    600, the port 400); polish then lands on the same vertex."""
    import admm_library_torch.parallel.batch as tbatch
    spy = _Spy(monkeypatch, tbatch, "solve_batch_shared")
    qpj = _config3()
    js, ts = _settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=50000,
                       backend=backend)
    jsol = J.solve(qpj, js)
    tsol = T.solve(_to_torch(qpj).astype(torch.float64), ts)
    _compare(jsol, tsol, iters=backend == "chol")
    assert int(tsol.status) == int(T.Status.SOLVED)
    assert spy.calls == 0
    assert (tsol.x.dtype, tsol.history.dtype) == (torch.float64,) * 2


@pytest.mark.parametrize("problem", ["l1", "box"])
def test_recenter_rounds_zero_matches_jax(problem):
    """recenter_rounds=0 sends every cone layout down the staged path
    without rounds: f32 phase, polish, f64 phase, polish."""
    qpj = (_small_cw() if problem == "l1"
           else random_box_qp(jax.random.key(4), n=20, m=40))
    js, ts = _settings(recenter_rounds=0, backend="chol")
    jsol = J.solve(qpj, js)
    tsol = T.solve(_to_torch(qpj), ts)
    _compare(jsol, tsol)
    assert int(tsol.status) == int(T.Status.SOLVED)
    assert tsol.x.dtype == torch.float32


def _f32_point(qpj, js, backend):
    """The staged path's f32 phase in JAX, as the f64 Solution that the
    rounds start from."""
    f64 = jnp.float64
    sol32 = japi._phase_jit(qpj.astype(jnp.float32),
                            jnp.zeros(qpj.n, jnp.float32),
                            jnp.zeros(qpj.m, jnp.float32),
                            jnp.zeros(qpj.m, jnp.float32), japi._s32_of(js),
                            backend)
    return J.Solution(
        x=sol32.x.astype(f64), z=sol32.z.astype(f64), y=sol32.y.astype(f64),
        status=sol32.status, iters=jnp.int32(0),
        r_prim=sol32.r_prim.astype(f64), r_dual=sol32.r_dual.astype(f64),
        obj=sol32.obj.astype(f64), rho=sol32.rho.astype(f64),
        history=sol32.history.astype(f64))


def _l1_qp():
    """A strongly convex QP with box and bounded L1 rows (n=20): its
    re-centred round converges, so the rounds' iterates are comparable."""
    rng = np.random.default_rng(5)
    n, mb, ml = 20, 12, 10
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    A = rng.standard_normal((mb + ml, n)) / np.sqrt(n)
    l = np.concatenate([np.full(mb, -0.5), np.full(ml, -1.0)])
    u = np.concatenate([np.full(mb, 0.5), np.full(ml, 1.0)])
    return J.make_qp(jnp.asarray(R @ R.T + 0.1 * np.eye(n), jnp.float32),
                     3 * rng.standard_normal(n), A, l, u,
                     cone=J.ConeSpec(m_box=mb, m_l1=ml),
                     lam=np.full(ml, 0.7))


@pytest.mark.parametrize("case", ["l1_qp", "cw_polish"])
def test_one_recentered_round_matches_jax(case):
    """One re-centred round from the same f64 point (JAX's f32 phase):
    the same shifted problem, f64 offset and eps quantisation give the
    same correction solve. l1_qp: the round converges; iterations equal
    and iterates within 1e-5 (the f32 rounds round differently in the
    two packages; measured 1.2e-6). cw_polish: the min-fuel LP's round
    chatters, but the polish attempt after it lands at the same vertex
    (within 1e-8)."""
    backend = "chol"
    polish = case == "cw_polish"
    qpj = _small_cw() if polish else _l1_qp()
    js, ts = _settings(recenter_rounds=1, backend=backend)
    sol0 = _f32_point(qpj, js, backend)
    qp64j = qpj.astype(jnp.float64)

    def jphase_off(qp_p, x_p, z_p, y_p, off_p, s_p):
        return japi._phase_off_jit(qp_p, x_p, z_p, y_p, off_p, s_p, backend)

    jtp = ((lambda c: japi._polish_jit(qp64j, c, js.eps_abs, js.eps_rel,
                                       1e-4)) if polish else None)
    jsol, jsolved = japi._recentered_rounds(qpj, qp64j, sol0, js, backend,
                                            phase_off=jphase_off,
                                            try_polish=jtp)
    qpt = _to_torch(qpj)
    qp64t = qpt.astype(torch.float64)
    ttp = ((lambda c: tapi.polish(qp64t, c, ts.eps_abs, ts.eps_rel,
                                  act_tol=1e-4)) if polish else None)
    tsol, tsolved = tapi._recentered_rounds(qpt, qp64t, _sol_to_torch(sol0),
                                            ts, backend, try_polish=ttp)
    assert tsolved == jsolved is True
    assert int(tsol.iters) == int(jsol.iters) > 0
    assert int(tsol.status) == int(jsol.status) == int(T.Status.SOLVED)
    atol = 1e-8 if polish else 1e-5
    for f in ("x", "z", "y"):
        np.testing.assert_allclose(getattr(tsol, f).numpy(),
                                   np.asarray(getattr(jsol, f)), atol=atol,
                                   rtol=0.0, err_msg=f)
    assert tsol.x.dtype == torch.float64


def _small_low_thrust():
    """Config 4 with the horizon cut from 200 to 25 nodes (n=250,
    m=281), the reference bench's other arguments unchanged."""
    s0 = np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1])
    qp, spec = jlt.build_low_thrust_socp(s0, N=25)
    js, ts = _settings(eps_abs=1e-6, eps_rel=5e-8, band_block=spec.block,
                       max_iter=50000, rho_soc_scale=100.0, stall_checks=16,
                       backend="inv")
    return qp, js, ts


def test_small_low_thrust_enters_the_continuation(monkeypatch):
    """The shared pass leaves the degenerate SOCP unsolved in both
    packages; both continue in `_f64_continuation` and land SOLVED."""
    qpj, js, ts = _small_low_thrust()
    jspy = _Spy(monkeypatch, japi, "_f64_continuation")
    tspy = _Spy(monkeypatch, tapi, "_f64_continuation")
    jsol = J.solve(qpj, js)
    tsol = T.solve(_to_torch(qpj), ts)
    assert jspy.calls == tspy.calls == 1
    assert int(tsol.status) == int(jsol.status) == int(T.Status.SOLVED)
    np.testing.assert_allclose(float(tsol.obj), float(jsol.obj),
                               rtol=OBJ_RTOL)
    assert tsol.x.dtype == torch.float32
    assert tsol.history.dtype == torch.float32


def test_continuation_runs_past_chunks_without_a_new_best(monkeypatch):
    """A reference fault the port does not copy: the JAX continuation
    stops after two chunks whose end residual is no new best, so a run
    whose residuals chatter while it converges ends MAX_ITER. Scripted
    chunks (end residuals 1e-3, 2e-3, 3e-3, ...) and polish attempts
    (the fourth lands): JAX gives up after three chunks; the port runs
    on and returns the polished point."""
    chunk, scores = 2000, [1e-3, 2e-3, 3e-3, 4e-3, 5e-3]
    qpj = J.make_qp(np.eye(2), np.ones(2), np.eye(2), -np.ones(2),
                    np.ones(2))

    def script(make_sol, status_max_iter, status_solved):
        calls = {"phase": 0, "polish": 0}

        def phase(qp, x, z, y, *a, **k):
            calls["phase"] += 1
            return make_sol(x, z, y, status_max_iter, chunk,
                            scores[calls["phase"] - 1])

        def pol(qp, sol, *a, **k):
            calls["polish"] += 1
            st = status_solved if calls["polish"] == 4 else status_max_iter
            return make_sol(sol.x, sol.z, sol.y, st, int(sol.iters), 1e-9)
        return calls, phase, pol

    def jsol(x, z, y, st, it, r):
        f = jnp.float64
        return J.Solution(x=x, z=z, y=y, status=jnp.int32(st),
                          iters=jnp.int32(it), r_prim=f(r), r_dual=f(0.0),
                          obj=f(0.0), rho=f(0.1), history=jnp.zeros((0, 3)))

    def tsol(x, z, y, st, it, r):
        f = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
        return T.Solution(x=x, z=z, y=y, status=torch.tensor(
            st, dtype=torch.int32), iters=torch.tensor(it, dtype=torch.int32),
            r_prim=f(r), r_dual=f(0.0), obj=f(0.0), rho=f(0.1),
            history=torch.zeros((0, 3), dtype=torch.float64))

    MAX, OK = int(J.Status.MAX_ITER), int(J.Status.SOLVED)
    jcalls, jphase, jpol = script(jsol, MAX, OK)
    monkeypatch.setattr(japi, "_phase_rho_jit", jphase)
    monkeypatch.setattr(japi, "_polish_jit", jpol)
    tcalls, tphase, tpol = script(tsol, MAX, OK)
    monkeypatch.setattr(tapi, "_solve_one_phase", tphase)
    monkeypatch.setattr(tapi, "polish", tpol)
    js, ts = _settings(max_iter=50000)
    z2 = np.zeros(2)
    jout = japi._f64_continuation(qpj, jsol(jnp.asarray(z2), jnp.asarray(z2),
                                            jnp.asarray(z2), MAX, 100, 1.0),
                                  js, "chol")
    tz = torch.zeros(2, dtype=torch.float64)
    tout = tapi._f64_continuation(_to_torch(qpj), tsol(tz, tz, tz, MAX, 100,
                                                       1.0), ts, "chol")
    assert jcalls["phase"] == 3 and int(jout.status) == MAX
    assert int(jout.iters) == 100 + 3 * chunk
    assert tcalls["phase"] == 4 and int(tout.status) == OK
    assert int(tout.iters) == 100 + 4 * chunk


def test_f64_continuation_matches_jax(monkeypatch):
    """From the same unsolved point (the JAX shared pass's), both
    packages' continuations run the same f64 chunks and polish attempts
    and land at the same iteration count; unlike the reference, the
    port returns every leaf, history included, in the problem's dtype."""
    qpj, js, ts = _small_low_thrust()
    seen = {}

    def capture(qp, sol, settings, backend, chunk=2000):
        seen["sol"] = sol
        return sol

    monkeypatch.setattr(japi, "_f64_continuation", capture)
    J.solve(qpj, js)
    monkeypatch.undo()
    sol0 = seen["sol"]
    assert int(sol0.status) != int(J.Status.SOLVED)
    jsol = japi._f64_continuation(qpj, sol0, js, "inv")
    tsol = tapi._f64_continuation(_to_torch(qpj), _sol_to_torch(sol0), ts,
                                  "inv")
    assert int(tsol.status) == int(jsol.status) == int(T.Status.SOLVED)
    assert int(tsol.iters) == int(jsol.iters) > int(sol0.iters)
    np.testing.assert_allclose(float(tsol.obj), float(jsol.obj),
                               rtol=OBJ_RTOL)
    assert np.asarray(jsol.history).dtype == np.float64
    for f in SOL_FIELDS:
        if f not in ("status", "iters"):
            assert getattr(tsol, f).dtype == torch.float32, f
