"""Port parity for `solve_batch`, a batch of independent problems solved
in one lockstep loop (core.admm.run_admm_lanes).

Against the JAX package's `solve_batch` (vmap of `_solve_core`) on the
same problems built once by the reference: per lane the same status,
iterations within one check interval (25) and x within 1e-6 (the
reference test's bar against `solve`). Against the port's own
`_solve_core` on each lane alone: the same status and iterations, and x
within X_LANE: the same arithmetic with batched products, whose rounding
differs from the single problem's (measured in f64 ≤ 5e-13; under
'hybrid' the f32 phase hands over a point 1.3e-7 apart on a nearly-LP
lane, so the bar is the repo's 1e-6 there).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_library_tpu as J
from admm_library_tpu.models import double_integrator as jdi
from admm_library_tpu.models.random_qp import random_box_qp
import admm_library_torch as T
from admm_library_torch import api as tapi
from admm_library_torch.core import admm as tadmm
from admm_library_torch.problem import ConeSpec, QPData

FIELDS = ("P", "q", "A", "l", "u", "lam")
CHECK = 25
TOL = dict(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000)
X_LANE = {"double": 1e-9, "hybrid": 1e-6}

torch.set_num_threads(1)


def _stack(qps):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *qps)


def _to_torch(qpj):
    c = qpj.cone
    return T.qp_from_numpy(
        {f: np.asarray(getattr(qpj, f)) for f in FIELDS},
        ConeSpec(m_box=c.m_box, m_l1=c.m_l1, soc_dims=tuple(c.soc_dims)),
        device="cpu")


def _settings(**kw):
    js = J.Settings(**kw)
    return js, T.Settings(**dataclasses.asdict(js))


def _lane(qp, i):
    return QPData(P=qp.P[i], q=qp.q[i], A=qp.A[i], l=qp.l[i], u=qp.u[i],
                  lam=qp.lam[i], cone=qp.cone)


def _compare_to_jax(jsol, tsol):
    np.testing.assert_array_equal(tsol.status.numpy(),
                                  np.asarray(jsol.status))
    np.testing.assert_array_less(
        np.abs(tsol.iters.numpy() - np.asarray(jsol.iters)), CHECK + 1)
    np.testing.assert_allclose(tsol.x.numpy(), np.asarray(jsol.x),
                               atol=1e-6)


def test_solve_batch_matches_jax():
    """tests/test_solver.py::test_solve_batch_vmap's four problems."""
    keys = jax.random.split(jax.random.key(7), 4)
    batch = _stack([random_box_qp(k, n=20, m=40, dtype=jnp.float64)
                    for k in keys])
    js, ts = _settings(**TOL)
    jsol = J.solve_batch(batch, js)
    tsol = T.solve_batch(_to_torch(batch), ts)
    assert tsol.x.shape == (4, 20) and tsol.x.dtype == torch.float64
    assert bool((tsol.status == int(T.Status.SOLVED)).all())
    _compare_to_jax(jsol, tsol)
    for f in ("iters", "r_prim", "r_dual", "obj", "rho"):
        assert getattr(tsol, f).shape == (4,), f


def _mixed_batch():
    """Three box QPs of one shape (n=12, m=16): a fast lane, a slow lane
    (P ≈ 1e-3 I: nearly an LP) and a primal-infeasible lane (rows 0 and
    1 are the same row a with a·x ≤ −1 and a·x ≥ 1)."""
    rng = np.random.default_rng(5)
    n, m = 12, 16
    lanes = []
    for scale, reg in ((1.0, 0.1), (1e-3, 1e-3), (1.0, 0.1)):
        R = rng.standard_normal((n, n)) / np.sqrt(n)
        A = rng.standard_normal((m, n)) / np.sqrt(n)
        Ax = A @ rng.standard_normal(n)
        spread = np.abs(rng.standard_normal(m)) + 0.1
        lanes.append(dict(P=scale * R @ R.T + reg * np.eye(n),
                          q=rng.standard_normal(n), A=A, l=Ax - spread,
                          u=Ax + spread))
    bad = lanes[2]
    bad["A"][1] = bad["A"][0]
    bad["l"][0], bad["u"][0] = -np.inf, -1.0
    bad["l"][1], bad["u"][1] = 1.0, np.inf
    arrays = {k: np.stack([ln[k] for ln in lanes]) for k in lanes[0]}
    arrays["lam"] = np.zeros((3, 0))
    return T.qp_from_numpy(arrays, ConeSpec(m_box=m), device="cpu")


@pytest.mark.parametrize("precision", ["hybrid", "double"])
def test_mixed_batch_lanes_equal_their_own_solve(precision):
    """Each lane of a batch whose lanes stop at different checks, one of
    them infeasible, equals the port's `_solve_core` on that lane alone:
    a lane that exits freezes, and the others go on unchanged."""
    qp = _mixed_batch()
    s = T.Settings(precision=precision, history=6)
    sol = T.solve_batch(qp, s)
    want = [int(T.Status.SOLVED), int(T.Status.SOLVED),
            int(T.Status.PRIMAL_INFEASIBLE)]
    assert sol.status.tolist() == want
    assert len(set(sol.iters.tolist())) == 3      # three exits
    assert sol.history.shape == (3, 6, 3)
    for i in range(3):
        one = _lane(qp, i)
        zeros = [torch.zeros(w, dtype=torch.float64) for w in
                 (one.n, one.m, one.m)]
        ref = tapi._solve_core(one, *zeros, s, "chol")
        assert int(sol.status[i]) == int(ref.status), i
        assert int(sol.iters[i]) == int(ref.iters), i
        np.testing.assert_allclose(sol.x[i].numpy(), ref.x.numpy(),
                                   atol=X_LANE[precision], err_msg=str(i))
        # The residual ring of the last phase: the same checks, residuals
        # to the rounding that the f32 phase hands over.
        h, hr = sol.history[i].numpy(), ref.history.numpy()
        np.testing.assert_array_equal(h[:, 0], hr[:, 0])
        np.testing.assert_allclose(h[:, 1:], hr[:, 1:], rtol=1e-6,
                                   atol=X_LANE[precision])
        assert float(sol.rho[i]) == pytest.approx(float(ref.rho), rel=1e-9)


def test_solve_batch_is_one_lockstep_loop(monkeypatch):
    """The batch runs through the lanes loop (core.admm.run_phase, kind
    run_admm_lanes), once per precision phase, and never through the
    single-problem loop."""
    from admm_library_torch.core import graph
    calls = []
    real = graph.CheckLoop

    def spy(kind, step, state, *a, **k):
        calls.append((kind, state["x0"].shape[0]))
        return real(kind, step, state, *a, **k)

    monkeypatch.setattr(graph, "CheckLoop", spy)
    sol = T.solve_batch(_mixed_batch(), T.Settings())
    assert calls == [("run_admm_lanes", 3)] * 2
    assert sol.iters.shape == (3,)


def _mpc_batch():
    """Three independent MPC problems at horizon 8 (config 2's model):
    their own initial states and cost scales, so every lane has its own
    P, bounds and block-tridiagonal factor."""
    rng = np.random.default_rng(2)
    qps = []
    for scale in (1.0, 3.0, 0.5):
        s0 = np.concatenate([rng.uniform(-2, 2, 3),
                             rng.uniform(-0.2, 0.2, 3)])
        qp, spec = jdi.build_mpc_qp(s0, np.zeros(6), N=8, dim=3,
                                    dtype=jnp.float64)
        qps.append(dataclasses.replace(qp, P=scale * qp.P, q=scale * qp.q))
    return _stack(qps), spec


@pytest.mark.parametrize("backend", ["chol", "inv", "banded", "spike", "cg"])
def test_solve_batch_backends_match_jax(backend):
    batch, spec = _mpc_batch()
    js, ts = _settings(backend=backend, band_block=spec.block,
                       spike_parts=4 if backend == "spike" else 0)
    tsol = T.solve_batch(_to_torch(batch), ts)
    assert bool((tsol.status == int(T.Status.SOLVED)).all())
    _compare_to_jax(J.solve_batch(batch, js), tsol)


def test_solve_batch_auto_takes_banded_off_the_card(monkeypatch):
    seen = []
    factor = tadmm.kkt.factor_condensed
    monkeypatch.setattr(tadmm.kkt, "factor_condensed",
                        lambda *a, **k: seen.append(a[4]) or factor(*a, **k))
    batch, spec = _mpc_batch()
    sol = T.solve_batch(_to_torch(batch), T.Settings(band_block=spec.block))
    assert set(seen) == {"banded"}
    assert bool((sol.status == int(T.Status.SOLVED)).all())


def test_solve_batch_rejects_pallas_cg_and_unbatched_problems():
    qp = _mixed_batch()
    with pytest.raises(ValueError, match="solve_batch_shared"):
        T.solve_batch(qp, T.Settings(backend="pallas_cg"))
    with pytest.raises(ValueError, match="use solve"):
        T.solve_batch(_lane(qp, 0), T.Settings())
    with pytest.raises(ValueError, match="q has shape"):
        T.solve_batch(dataclasses.replace(qp, q=qp.q[0]), T.Settings())
