"""The plain reference accepts the port's CPU solves (the plain twin path)
and rejects an answer made in lower precision or with a dual that does
not belong to its z."""
import json
from pathlib import Path

import numpy as np
import torch

import admm_library_torch as port
from benchmark import reference, traffic
from benchmark.families import clohessy_wiltshire as fcw
from benchmark.families import double_integrator as fdi

HERE = Path(__file__).resolve().parent
EPS = 1e-6


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _batch(lanes=4, seed=3):
    cfg = _config("rendezvous_h50")
    prob = cfg["problem"]
    base = fdi.build(prob)
    wl = dict(pool_calls=1, warm_calls=0, lanes=lanes,
              draw=dict(kind="gaussian", center=prob["s0_nominal"],
                        scale=[0.1] * 3 + [0.01] * 3))
    _, pool = traffic.draws(wl, seed, "cpu")
    l, u = fdi.bounds_for_s0(base, prob, pool[0])
    qp = port.QPData(P=base["P"], q=base["q"], A=base["A"], l=l, u=u,
                     lam=base["lam"], cone=port.ConeSpec(m_box=base["m_box"]))
    return cfg, dict(base, l=l, u=u), qp


def test_accepts_the_ports_batch_solve():
    cfg, data, qp = _batch()
    sol = port.solve_batch_shared(qp, port.Settings(**cfg["settings"]))
    assert bool((sol.status == 1).all())
    ratio, parts = reference.kkt_ratio(data, sol.x, sol.z, sol.y, EPS, EPS)
    assert ratio.shape == (4,)
    assert float(ratio.max()) <= cfg["limits"]["kkt_ratio"]
    assert parts["comp"] < 1e-3


def test_rejects_lower_precision_answers():
    """The port's single-precision path (the benchmark's control), and the
    sound answer rounded to bfloat16, both fail the limit."""
    cfg, data, qp = _batch()
    lim = cfg["limits"]["kkt_ratio"]
    single = port.solve_batch_shared(
        qp, port.Settings(**cfg["settings"]).replace(precision="single"))
    ratio, _ = reference.kkt_ratio(data, single.x, single.z, single.y, EPS,
                                   EPS)
    assert float(ratio.max()) > lim
    sol = port.solve_batch_shared(qp, port.Settings(**cfg["settings"]))
    low = [t.to(torch.bfloat16) for t in (sol.x, sol.z, sol.y)]
    ratio, _ = reference.kkt_ratio(data, *low, EPS, EPS)
    assert float(ratio.min()) > lim


def test_accepts_the_ports_l1_solve():
    cfg = _config("cw_minfuel_n20")
    prob = cfg["problem"]
    base = fcw.build(prob)
    qp = port.QPData(P=base["P"], q=base["q"], A=base["A"], l=base["l"],
                     u=base["u"], lam=base["lam"],
                     cone=port.ConeSpec(m_box=base["m_box"],
                                        m_l1=base["m_l1"]))
    sol = port.solve(qp, port.Settings(**cfg["settings"]))
    assert int(sol.status) == 1
    ratio, parts = reference.kkt_ratio(base, sol.x, sol.z, sol.y, EPS, EPS)
    assert float(ratio.max()) <= cfg["limits"]["kkt_ratio"]


def _known_box_qp(seed=0, n=12, m=20, active=6):
    """A box QP with a constructed optimal pair (x*, y*)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    R = rng.standard_normal((n, n))
    P = R @ R.T + np.eye(n)
    x = rng.standard_normal(n)
    z = A @ x
    y = np.zeros(m)
    l, u = z - 1.0, z + 1.0
    for i in range(active):
        if i % 2:
            l[i], y[i] = z[i], -0.5
        else:
            u[i], y[i] = z[i], 0.5
    q = -P @ x - A.T @ y
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    data = dict(P=t(P), q=t(q), A=t(A), l=t(l), u=t(u),
                lam=torch.zeros(0, dtype=torch.float64), m_box=m, m_l1=0)
    return data, t(x), t(z), t(y)


def test_exact_pair_reads_zero_and_a_wrong_dual_fails():
    data, x, z, y = _known_box_qp()
    r = reference.ratios(data, x[None], z[None], y[None], EPS, EPS)
    assert max(float(v.max()) for v in r.values()) < 1e-6
    # A multiplier on a slack row, with q moved so that the dual residual
    # still vanishes: only complementary slackness sees it.
    y2 = y.clone()
    y2[-1] = 0.3
    data2 = dict(data, q=data["q"] - data["A"][-1] * 0.3)
    r = reference.ratios(data2, x[None], z[None], y2[None], EPS, EPS)
    assert float(r["dual"].max()) < 1e-6
    assert float(r["comp"].max()) > 1e3


def test_l1_subgradient_and_soc_projection():
    # |y| <= lam at z = 0 is consistent; |y| > lam is not.
    lam = torch.tensor([1.0], dtype=torch.float64)
    lo, hi = torch.tensor([-2.0]), torch.tensor([2.0])
    z0 = torch.zeros(1, dtype=torch.float64)
    for y, ok in ((0.5, True), (-1.0, True), (1.5, False)):
        p = reference.prox(z0 + y, lo, hi, lam, 0, 1)
        assert (float((p - z0).abs().max()) == 0.0) == ok
    # SOC: a point inside stays, one outside goes to the boundary.
    v = torch.tensor([[2.0, 1.0, 0.0], [0.0, 3.0, 4.0]], dtype=torch.float64)
    p = reference.prox(v, torch.zeros(0), torch.zeros(0), torch.zeros(0), 0,
                       0, (3,))
    assert torch.allclose(p[0], v[0])
    assert torch.allclose(p[1], torch.tensor([2.5, 1.5, 2.0],
                                             dtype=torch.float64))
