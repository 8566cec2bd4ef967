"""The benchmark's frozen problem builders and draws give, on the CPU at
seed 0, bitwise the tensors that admm_library_torch.models gives for the
same initial states."""
import json
from pathlib import Path

import torch

from admm_library_torch.models import clohessy_wiltshire as cw
from admm_library_torch.models import double_integrator as di
from admm_library_torch.models import monte_carlo as mc
from benchmark import traffic
from benchmark.families import clohessy_wiltshire as fcw
from benchmark.families import double_integrator as fdi

HERE = Path(__file__).resolve().parent


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _same(ours: dict, qp):
    for key in ("P", "q", "A", "l", "u", "lam"):
        a, b = ours[key], getattr(qp, key)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert torch.equal(a, b), key
    assert (ours["m_box"], ours["m_l1"]) == (qp.cone.m_box, qp.cone.m_l1)


def test_double_integrator_builder_bitwise():
    prob = _config("rendezvous_h50")["problem"]
    ours = fdi.build(prob)
    qp, spec = di.build_mpc_qp(torch.tensor(prob["s0_nominal"]),
                               torch.tensor(prob["s_target"]), N=prob["N"],
                               dim=prob["dim"], dt=prob["dt"],
                               u_max=prob["u_max"],
                               state_reg=prob["state_reg"], device="cpu")
    _same(ours, qp)
    assert (qp.n, qp.m) == (450, 456)


def test_campaign_draw_and_bounds_bitwise():
    """The campaign's Gaussian draw at seed 0 is monte_carlo.disperse_s0's
    from the same generator, and its bounds mpc_bounds_for_s0's."""
    cfg = _config("rendezvous_h50")
    prob = cfg["problem"]
    wl = json.loads((HERE / "workloads" / "campaign1024.json").read_text())
    wl = dict(wl, pool_calls=1, warm_calls=0,
              draw=dict(wl["draw"], center=prob["s0_nominal"]))
    _, pool = traffic.draws(wl, 0, "cpu")
    s0s = mc.disperse_s0(torch.Generator().manual_seed(0),
                         torch.tensor(prob["s0_nominal"]), 0.1, 0.01, 1024,
                         device="cpu")
    assert torch.equal(pool[0], s0s)
    qp, spec, _ = mc.monte_carlo_mpc_from_s0(s0s, device="cpu")
    ours = fdi.build(prob)
    l, u = fdi.bounds_for_s0(ours, prob, pool[0])
    _same(dict(ours, l=l, u=u), qp)


def test_clohessy_wiltshire_builder_and_bounds_bitwise():
    prob = _config("cw_minfuel_n20")["problem"]
    ours = fcw.build(prob)
    qp, spec = cw.build_cw_rendezvous(
        torch.tensor(prob["s0_nominal"], dtype=torch.float64), N=prob["N"],
        dt=prob["dt"], n_mean=prob["n_mean"], dv_max=prob["dv_max"],
        lam=prob["lam"], reg=prob["reg"], device="cpu")
    _same(ours, qp)
    s0s = mc.disperse_s0(torch.Generator().manual_seed(0),
                         torch.tensor(prob["s0_nominal"]), 50.0, 0.05, 64,
                         device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        fcw.bounds_for_s0(ours, prob, s0s), cw.cw_bounds_for_s0(qp, spec,
                                                                 s0s)))


def test_uniform_draw_is_seeded_and_bounded():
    wl = json.loads((HERE / "workloads" / "mpc_replan.json").read_text())
    wl = dict(wl, pool_calls=64)
    warm, pool = traffic.draws(wl, 2**31 + 7, "cpu")
    again = traffic.draws(wl, 2**31 + 7, "cpu")
    other = traffic.draws(wl, 2**31 + 8, "cpu")
    assert torch.equal(pool, again[1]) and torch.equal(warm, again[0])
    assert not torch.equal(pool, other[1])
    half = torch.tensor(wl["draw"]["half_width"])
    assert pool.shape == (64, 1, 6) and warm.shape == (4, 1, 6)
    assert bool((pool.abs() <= half).all())
