"""The whole-solve programs (core/graph.py `program`) on the CPU:
`parallel.batch._solve_shared_core` (the counterpart of the JAX
package's `_solve_shared_jit`) and `api._solve_core` (`_solve_jit`).

- The program's node form, run on the CPU by `test_torch_graph.HostNodes`
  (each conditional node run as the card would, its flag read on the
  host) over the entry's buffers (`test_torch_graph_solve._buffered`),
  is bitwise its plain form and the frozen host code of
  tests/torch_loops_reference.py: rounds that stop after round 0, a
  second round, a lane the safeguard freezes, the f64 fallback taken
  and not, SOC at 4 rounds, L1 with its shifted-prox offset, 'single',
  'double', recenter_rounds=0, on 'inv', 'chol' and 'cg' (a CG's node
  four deep: rounds, phase, check variant, CG), and `solve_batch` and
  `solve` through `_solve_core`. The node form calls no host branch.
- Built under FakeTensorMode, where a host read raises, the node form
  reads nothing, and every entry a branch writes exists before it
  (a fallback the warm-up did not take made its entries).
- The key: each CHECK_FIELDS value of each settings the solve derives,
  and hybrid_eps and scaling_iters, give a new entry.
- A program whose branch would add a state entry raises.

Parity with JAX stays with tests/test_torch_batch.py and
test_torch_api.py; the card's side is in tests/test_torch_gpu.py and
chip_smoke.py.
"""
import functools
import types

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import admm_library_torch as T
from admm_library_torch import api
from admm_library_torch.core import graph
from admm_library_torch.parallel import batch

import test_torch_graph_api as gapi
import torch_loops_reference as ref
from test_torch_graph import HostNodes, TraceNodes, install_nodes
from test_torch_graph_solve import SETTINGS, _buffered, _mc_batch, _raw_batch

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
TIGHT = dict(eps_abs=1e-9, eps_rel=1e-9)


def _assert_bitwise(new, old):
    for f in ("x", "z", "y", "status", "iters", "r_prim", "r_dual", "obj",
              "rho", "history"):
        a, b = getattr(new, f), getattr(old, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


class _Driver:
    """Records the driver segments of the re-centred solve
    (`batch.recentered_step`): how many rounds ran, whether the
    safeguard froze a lane and whether the fallback joined."""

    def __init__(self, monkeypatch):
        self.variants, self.frozen = [], False
        real = batch.recentered_step

        def spy(state, variant, **kw):
            out = real(state, variant, **kw)
            self.variants.append(variant)
            if variant == batch.SAFEGUARD:
                self.frozen |= bool(out["carry"]["frozen"].any())
            return out
        monkeypatch.setattr(batch, "recentered_step", spy)

    def rounds(self):
        return self.variants.count(batch.SETUP)


# (problem, settings, rounds run, a lane frozen, the fallback taken).
_SHARED = {
    "rounds_stop_after_round0": (lambda: _mc_batch(),
                                 T.Settings(backend="inv"), 1, False,
                                 False),
    "second_round_no_fallback": (lambda: _raw_batch("box", lane_q=True),
                                 SETTINGS, 2, False, False),
    "frozen_lane_f64_fallback": (lambda: _mc_batch(),
                                 T.Settings(backend="inv", **TIGHT), 2,
                                 True, True),
    "soc_4_rounds": (lambda: _raw_batch("soc"), SETTINGS.replace(
        recenter_rounds=4, eps_abs=1e-8, eps_rel=1e-8), None, None, None),
    "l1_offset_lane_q_fallback": (lambda: _raw_batch("l1", lane_q=True),
                                  SETTINGS, 2, False, True),
    "chol_second_round": (lambda: _raw_batch("box"),
                          SETTINGS.replace(backend="chol"), 2, False,
                          False),
    "cg_second_round": (lambda: _raw_batch("box"),
                        SETTINGS.replace(backend="cg", max_iter=100), 2,
                        False, False),
    "single": (lambda: _raw_batch("soc", F32),
               SETTINGS.replace(precision="single"), 0, False, False),
    "double": (lambda: _raw_batch("l1"),
               SETTINGS.replace(precision="double"), 0, False, False),
    "two_phase": (lambda: _mc_batch(),
                  T.Settings(backend="inv", recenter_rounds=0), 0, False,
                  False),
}


def _node_runs(monkeypatch, fn, *args, **kw):
    """fn(*args, **kw) three times on one buffered cache: the warm-up
    into the entry, then twice in node form (HostNodes). Returns the
    three results and the node builder of the last run."""
    cache = _buffered(monkeypatch)
    modes = []
    buffered = graph._Entry.run_program

    def run_program(entry, variant, driver):
        modes.append(entry.warm)
        return buffered(entry, variant, driver)
    monkeypatch.setattr(graph._Entry, "run_program", run_program)
    out = [fn(*args, **kw)]
    for _ in range(2):
        nodes = install_nodes(monkeypatch, HostNodes())
        out.append(fn(*args, **kw))
    assert modes == [False, True, True] and len(cache.entries) >= 1
    return out, nodes


@pytest.mark.parametrize("case", sorted(_SHARED))
def test_shared_program_nodes_are_the_plain_form(case, monkeypatch):
    make, s, rounds, frozen, fallback = _SHARED[case]
    qp = make()
    old = ref._ref_solve_batch_shared(qp, s)
    reads = []
    real_agreed = batch._agreed

    def agreed(flags, mesh):
        reads.append(None if graph._program is None
                     else graph._program.mode)
        return real_agreed(flags, mesh)
    monkeypatch.setattr(batch, "_agreed", agreed)
    with monkeypatch.context() as m:
        drv = _Driver(m)
        plain = batch.solve_batch_shared(qp, s)
    _assert_bitwise(plain, old)
    if rounds is not None:
        assert drv.rounds() == rounds
        assert drv.frozen == frozen
        assert (batch.JOIN in drv.variants) == fallback
        # The plain form's host branches: before each later round and
        # before the fallback.
        assert len(reads) == (min(rounds + 1, s.recenter_rounds)
                              if rounds else 0)
    reads.clear()
    runs, nodes = _node_runs(monkeypatch, batch.solve_batch_shared, qp, s)
    for sol in runs:
        _assert_bitwise(sol, old)
    # The warm-up reads its branches; no branch of the node form does.
    assert "nodes" not in reads and (not rounds or "warm" in reads)
    kinds = list(zip(nodes.kinds, nodes.depths, nodes.nodes))
    if s.precision == "hybrid" and s.recenter_rounds:
        # The rounds' WHILE node and the fallback's IF node, both on top.
        assert [(k, d, c) for k, d, c in kinds if k == "program"] == [
            ("program", 1, s.recenter_rounds), ("program", 1, 1)]
    if s.backend == "cg":
        # rounds WHILE > phase WHILE > variant IF > CG WHILE.
        assert max(d for k, d, _ in kinds if k == "cg") == graph.NODE_DEPTH


_CORE = ["batch_hybrid", "batch_single_inv", "batch_double_warm",
         "batch_hybrid_cg", "single_soc_f32", "double_l1_inv",
         "double_box_cg", "box_hybrid"]


@pytest.mark.parametrize("case", _CORE)
def test_core_program_nodes_are_the_plain_form(case, monkeypatch):
    """`solve_batch` and `solve` (`_solve_core`, or at 'hybrid' the
    shared pass at B=1): plain, warm-up and node form bitwise the frozen
    solve."""
    fn, qp, s, kw = gapi._case(case)
    old = gapi._ref_of(fn)(qp, s, **kw)
    _assert_bitwise(fn(qp, s, **kw), old)
    runs, nodes = _node_runs(monkeypatch, fn, qp, s, **kw)
    for sol in runs:
        _assert_bitwise(sol, old)
    assert nodes.kinds and nodes.kinds[0] in ("phase", "program")
    if case == "batch_hybrid_cg":
        assert "cg" in nodes.kinds


def _warm_entry(monkeypatch, fn, *args):
    """fn(*args) once on a buffered cache: (result, the program's entry
    after its warm-up, its driver)."""
    _buffered(monkeypatch)
    seen = []
    buffered = graph._Entry.run_program

    def run_program(entry, variant, driver):
        seen.append((entry, driver))
        return buffered(entry, variant, driver)
    monkeypatch.setattr(graph._Entry, "run_program", run_program)
    out = fn(*args)
    (entry, driver), = seen
    return out, entry, driver


_FAKE = {
    "hybrid_no_fallback": (batch.solve_batch_shared, _mc_batch,
                           T.Settings(backend="inv")),
    "hybrid_fallback": (batch.solve_batch_shared, _mc_batch,
                        T.Settings(backend="inv", **TIGHT)),
    "mixed_soc": (batch.solve_batch_shared, lambda: _raw_batch("soc"),
                  SETTINGS),
    "cg": (batch.solve_batch_shared, lambda: _raw_batch("box"),
           SETTINGS.replace(backend="cg", max_iter=100)),
    "two_phase": (batch.solve_batch_shared, _mc_batch,
                  T.Settings(backend="inv", recenter_rounds=0)),
    "solve_batch_hybrid": (T.solve_batch, lambda: gapi._lanes("soc"),
                           gapi.LOOPS.replace(backend="chol")),
}


@pytest.mark.parametrize("case", sorted(_FAKE))
def test_node_form_makes_no_host_read(case, monkeypatch):
    """The node form built from the entry its warm-up made, every tensor
    fake (a read raises) and every branch's body traced once, taken or
    not (`TraceNodes`, as a capture does): no read, no new entry, and
    outputs of the warm-up's shapes and dtypes."""
    fn, make, s = _FAKE[case]
    sol, entry, driver = _warm_entry(monkeypatch, fn, make(), s)
    mode = FakeTensorMode()
    fake = types.SimpleNamespace(
        buffers=graph._map(mode.from_tensor, entry.buffers),
        loops=graph._map(mode.from_tensor, entry.loops),
        device=entry.device)
    names = set(fake.loops)
    nodes = install_nodes(monkeypatch, TraceNodes())
    with mode:
        out = graph._drive(fake, driver, "nodes")
    assert set(fake.loops) == names
    for f, t in out.items():
        want = getattr(sol, f)
        assert tuple(t.shape) == tuple(want.shape), f
        assert t.dtype == want.dtype, f
    if case.startswith("hybrid") or case in ("mixed_soc", "cg"):
        assert s.recenter_rounds in nodes.nodes
    if case == "hybrid_no_fallback":
        # The fallback's loop: made by the warm-up without its checks.
        assert any(name.startswith("node1/") for name in names)


def _bump(value):
    """Another valid value of a settings field."""
    return value + 1 if isinstance(value, int) else value * 0.5 + 0.125


_DERIVED = {
    "shared_s1": (batch, "_s32_of_shared"),
    "shared_rounds": (batch, "_round_settings"),
    "shared_f64": (batch, "_f64_settings"),
    "core_f32": (api, "_s32_of"),
}


@pytest.mark.parametrize("field", graph.CHECK_FIELDS)
@pytest.mark.parametrize("derived", sorted(_DERIVED))
def test_each_derived_setting_keys_the_program(derived, field,
                                               monkeypatch):
    """A derived settings that differs in one CHECK_FIELDS value gives
    another key: no graph of one is replayed for the other."""
    module, name = _DERIVED[derived]
    key = module._program_key
    s = T.Settings()
    cone = T.ConeSpec(m_box=4)
    base = key(s, cone)
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda st: real(st).replace(
        **{field: _bump(getattr(real(st), field))}))
    assert key(s, cone) != base


@pytest.mark.parametrize("field", ["hybrid_eps", "scaling_iters",
                                   "recenter_rounds", "max_iter"])
def test_a_driver_setting_gives_a_new_entry(field, monkeypatch):
    cache = _buffered(monkeypatch)
    qp = _mc_batch()
    s = T.Settings(backend="inv", max_iter=200)
    batch.solve_batch_shared(qp, s)
    batch.solve_batch_shared(qp, s.replace(**{field: _bump(getattr(s,
                                                                   field))}))
    batch.solve_batch_shared(qp, s)
    assert len(cache.entries) == 2


def _toy_step(state, variant):
    return dict(x=state["x"] + 1.0, flag=torch.ones(1, dtype=torch.bool))


def _toy_driver(inputs, extra):
    loop = graph.CheckLoop("toy", _toy_step, dict(x=inputs["x"]), None,
                           "inv")
    loop(("step",))

    def body():
        loop.set(dict(new=loop.state["x"] * 2.0) if extra else
                 dict(x=loop.state["x"] * 2.0))
    graph.cond(loop.state["flag"], body, lambda f: bool(f[0]))
    return dict(x=loop.state["x"])


def test_a_branch_that_adds_an_entry_raises(monkeypatch):
    """Inside the node form no write may add an entry: its buffer would
    come from a body's pool."""
    cache = _buffered(monkeypatch)
    install_nodes(monkeypatch, HostNodes())
    inputs = dict(x=torch.arange(3.0))
    warm = graph.program("toy", functools.partial(_toy_driver, extra=False),
                         inputs, "inv")
    assert torch.equal(warm["x"], (torch.arange(3.0) + 1.0) * 2.0)
    again = graph.program("toy", functools.partial(_toy_driver,
                                                   extra=False),
                          inputs, "inv")
    assert torch.equal(again["x"], warm["x"]) and len(cache.entries) == 1
    with pytest.raises(RuntimeError, match="added the state entry"):
        graph.program("toy", functools.partial(_toy_driver, extra=True),
                      inputs, "inv")
