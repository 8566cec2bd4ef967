"""The loop over checks of every driver, `graph.CheckLoop.run_checks`
(the counterpart of the JAX package's `lax.while_loop` over checks), on
the CPU.

- The device's predicates: the variant that `graph.variant_at` picks
  from the iteration counter (a 0-d tensor, as on the card) and the
  WHILE node's condition (it < max_iter and the live flag, in either
  polarity) run the same checks in the same variants as the host loop's
  `admm.check_variant` and `alive and it < max_iter`, for restart
  cadences 0, 75 and 200, adaptive rho on and off at intervals 25 and
  100, and a max_iter that is a multiple of check_every and one that is
  not; a toy loop through the plain form and through the node form
  (`graph.phase_nodes` run by `HostNodes`, each reachable variant an IF
  node) against the host loop of `torch_loops_reference`.
- The six loops (`run_admm` and its lanes form, `_run_batch`, the
  consensus drivers, `_run_horizon`, `solve_rowsharded`): the plain
  form, and the node form through static buffers, bitwise the host loops
  of `torch_loops_reference.HOST_LOOPS` in place of `run_checks`, over a
  run with rho refactors, one with restarts and one cut by max_iter.
- The partitioned drivers' REFACTOR segment is bitwise the refactor
  their host loops made with `loop.set`.

Small shapes; no JAX.
"""
import types

import pytest
import torch

from admm_library_torch import Settings
from admm_library_torch.core import admm, graph
from admm_library_torch.parallel import (batch, consensus, consensus_mc,
                                         horizon, rowshard)

import torch_loops_reference as ref
from test_torch_graph import (F64, HostNodes, _Recorder, _assert_bitwise,
                              _lanes, _shared, _single, _zeros,
                              install_nodes)
from test_torch_graph_partitioned import (_horizon_args, _horizon_mpc,
                                          _local, _mesh, _mpc_blocks,
                                          _scaled_args, _scenarios)
from test_torch_graph_rowshard import _box
from test_torch_graph_rowshard import _mesh as _row_mesh
from test_torch_graph_solve import _buffered

torch.set_num_threads(1)

K = 25
# (restart_every, adaptive_rho, adaptive_rho_interval, max_iter)
CADENCES = [(r, a, i, m) for r in (0, 75, 200) for a in (True, False)
            for i in (25, 100) for m in (250, 110)]


def _toy_step(record, stop: int, done: bool):
    """A check that records its variant, counts K iterations and stops
    at `stop` ('done' or 'live' in flags[0], int32), asking for a
    refactor in its rho-test variant; the refactor counts."""
    def step(state, variant):
        if variant == graph.REFACTOR:
            record.append("refactor")
            return dict(r=state["r"] + 1)
        record.append(tuple(variant))
        it = state["it"] + K
        live = it < stop
        return dict(it=it, flags=torch.stack(
            [~live if done else live,
             torch.tensor(bool(variant[-1]))]).to(torch.int32))
    return step


def _toy_state():
    zero = torch.zeros((), dtype=torch.int64)
    return dict(it=zero, r=zero.clone(),
                flags=torch.ones(2, dtype=torch.int32))


def _toy_run(s, rc, stop, done, form, monkeypatch):
    """(the segments run, in order; refactors; iterations) of the toy
    loop through the host loop before `run_checks` ('host', live in
    flags[0]), `run_checks`' plain form ('plain') or its node form run
    by HostNodes through static buffers ('nodes')."""
    record = []
    step = _toy_step(record, stop, done)
    with monkeypatch.context() as m:
        if form == "nodes":
            _buffered(m)
            install_nodes(m, HostNodes())
        loop = graph.CheckLoop("toy", step, _toy_state(), None, "chol")
        if form == "host":
            ref._host_phase_loop(loop, s, rc)
        else:
            loop.run_checks(s, rc, done=done)
    return record, int(loop.state["r"]), int(loop.state["it"])


@pytest.mark.parametrize("restart_every,adaptive_rho,interval,max_iter",
                         CADENCES)
def test_device_predicates_are_the_host_loops(restart_every, adaptive_rho,
                                              interval, max_iter,
                                              monkeypatch):
    s = Settings(check_every=K, restart_every=restart_every,
                 adaptive_rho=adaptive_rho,
                 adaptive_rho_interval=interval, max_iter=max_iter)
    rc = admm.restart_cadence_checks(s)
    ic = graph.interval_checks(s)
    # The host loop's checks, and the device's from the counter.
    host, it = [], 0
    while it < s.max_iter:
        host.append(admm.check_variant(it // K, s, rc))
        it += K
    dev, it_t = [], torch.zeros((), dtype=torch.int64)
    bound = torch.tensor(s.max_iter)
    flags = torch.ones(2, dtype=torch.bool)
    while bool((it_t < bound) & ((it_t == 0) | graph._live(flags, False))):
        parts = graph.variant_at(it_t // K, rc, ic)
        dev.append(tuple(bool(p) for p in parts))
        it_t = it_t + K
    assert dev == host
    # The toy loop, live to max_iter and stopped early, in both
    # polarities: the plain and the node form meet the host loop's
    # checks and refactors in order.
    for stop in (10 ** 6, 3 * K):
        want = _toy_run(s, rc, stop, False, "host", monkeypatch)
        assert len([v for v in want[0] if v != "refactor"]) == (
            len(host) if stop > s.max_iter else min(3, len(host)))
        for done in (False, True):
            for form in ("plain", "nodes"):
                assert _toy_run(s, rc, stop, done, form,
                                monkeypatch) == want, (done, form)


# ---------------------------------------------------------------- drivers

LOOP = Settings(check_every=5, adaptive_rho_interval=10, history=3,
                eps_abs=1e-7, eps_rel=1e-7, stall_checks=0, max_iter=400)
# A run with rho refactors (rho far off, no restart), one with restarts
# every 3 checks (no rho test), one cut by max_iter at a bound that is
# not a multiple of check_every (22: five checks, 25 iterations).
CASES = {"refactor": dict(restart_every=0, rho=0.01),
         "restart": dict(restart_every=15, adaptive_rho=False),
         "max_iter": dict(restart_every=15, rho=10.0, max_iter=22)}
# The horizon driver (no Ruiz scaling) refactors from a rho 10x high.
REFACTOR_RHO = {"run_horizon": 10.0}
DRIVERS = ("run_admm", "run_admm_lanes", "run_admm_batch_shared",
           "run_consensus", "run_consensus_mc", "run_horizon",
           "solve_rowsharded")


def _drive(driver, s):
    """The driver's loop on a small problem: (its result, its rho-bar,
    its iterations)."""
    if driver == "run_admm":
        qp, sc = _single("box", F64)
        out = admm.run_admm(qp, sc, s, *_zeros(qp), "chol")
        return out, out.rho_bar, out.it
    if driver == "run_admm_lanes":
        qp, sc = _lanes("box", F64)
        out = admm.run_admm_lanes(qp, sc, s, *_zeros(qp, 3), "chol")
        return out, out.rho_bar, out.it.max()
    if driver == "run_admm_batch_shared":
        qp, sc = _shared("box", F64)
        out = batch.run_admm_batch_shared(qp, sc, s, *_zeros(qp, 4), "chol")
        return out, out.rho_bar, out.iters_lane.max()
    if driver in ("run_consensus", "run_consensus_mc"):
        qp, spec = _mpc_blocks(F64)
        lanes = None if driver == "run_consensus" else 3
        if lanes:
            qp = _scenarios(qp, lanes)
        qp_s, vecs, zeros = _scaled_args(qp, spec, lanes)
        run = getattr(consensus if lanes is None else consensus_mc, driver)
        out = run(qp_s, spec, s, _local(_mesh(), spec.n_blocks), *zeros,
                  "chol", vecs)
        return out, out.rho_bar, out.iters.max()
    if driver == "run_horizon":
        hp, hs, loc, zeros = _horizon_args(*_horizon_mpc(F64), _mesh())
        out = horizon._run_horizon(hp, hs, s, loc, *zeros)
        return out, out[-1], out[4].max()
    out = rowshard.solve_rowsharded(_box(F64), _row_mesh(), s)
    return out, out.rho, out.iters


def _host_run_checks(loop, settings, restart_checks, **kw):
    ref.HOST_LOOPS[loop.kind](loop, settings, restart_checks)


def _same(new, old):
    if isinstance(old, tuple) and not hasattr(old, "_fields"):
        assert len(new) == len(old)
        for a, b in zip(new, old):
            assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        _assert_bitwise(new, old)


@pytest.mark.parametrize("form", ["plain", "nodes"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("driver", DRIVERS)
def test_the_loop_over_checks_is_the_host_loop(driver, case, form,
                                               monkeypatch):
    s = LOOP.replace(**CASES[case])
    if case == "refactor" and driver in REFACTOR_RHO:
        s = s.replace(rho=REFACTOR_RHO[driver])
    with monkeypatch.context() as m:
        m.setattr(graph.CheckLoop, "run_checks", _host_run_checks)
        want, _, _ = _drive(driver, s)
    nodes = None
    if form == "nodes":
        cache = _buffered(monkeypatch)
        nodes = install_nodes(monkeypatch, HostNodes())
    got, rho_bar, iters = _drive(driver, s)
    _same(got, want)
    if case == "max_iter":
        assert int(iters) == 25
    elif case == "refactor":
        assert float(rho_bar.reshape(-1)[0]) != s.rho
    elif driver != "run_horizon":                  # no restart there
        assert int(iters) >= 3 * s.check_every
    if nodes is not None:
        assert cache.stats["replays"] > 0 and nodes.kinds[0] == "phase"
        if case == "refactor" and driver != "solve_rowsharded":
            assert graph.REFACTOR in nodes.segments
        if case == "restart" and driver != "run_horizon":
            assert any(v[-2] for v in nodes.segments)


# ---------------------------------------------------------------- refactor

@pytest.mark.parametrize("driver", ["run_consensus", "run_consensus_mc",
                                    "run_horizon"])
def test_the_refactor_segment_is_the_host_refactor(driver, monkeypatch):
    """Each partitioned driver's REFACTOR from the state its first check
    meets, rho-bar proposed 30x higher: the segment's rho-bar and factor
    are bitwise those the host loop built and wrote with `loop.set`."""
    rec = _Recorder(monkeypatch)
    _drive(driver, LOOP.replace(max_iter=0))
    (kind, step, state, _), = rec.loops
    assert kind == driver
    state = dict(state, new_rho=state["rho_bar"] * 30.0)
    new = step(state, graph.REFACTOR)
    host = types.SimpleNamespace(step=step, state=state)
    if driver == "run_horizon":
        fac = ref._host_horizon_factor(host, state["new_rho"])
    else:
        fac = ref._host_rho(host).refresh(state["fac"], state["new_rho"])
    assert torch.equal(new["rho_bar"], state["new_rho"])
    assert sorted(new["fac"]) == sorted(fac)
    for key, t in fac.items():
        assert new["fac"][key].dtype == t.dtype
        assert torch.equal(new["fac"][key], t), key
