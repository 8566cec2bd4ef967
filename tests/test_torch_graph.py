"""Captured residual checks (admm_library_torch/core/graph.py) on the CPU.

- Each loop's check (`admm.admm_check`, `admm.lanes_check`,
  `batch.batch_check`) in every variant makes no host read: it runs
  under FakeTensorMode, where `.item()`, `float(t)`, `bool(t)` and
  `.tolist()` raise. f32 and f64, box, L1 and SOC rows, with and without
  a shifted-prox offset, the batch's plain and fused-tail forms, on the
  dense backends and on the block sweeps of 'banded' and 'spike'; and
  `parallel.rowshard.solve_rowsharded`'s check, its CGs traced as
  conditional nodes (`TraceNodes`).
- `run_admm`, `run_admm_lanes` and `run_admm_batch_shared` are bitwise
  the plain loops of tests/torch_loops_reference.py (host counters,
  rebinding), over restarts, rho refactors, stalls and every backend
  whose check they run.
- The capture rule over backend x mesh shape x device (the loop kinds
  on 'cg': tests/test_torch_graph_cg.py).
- The cache key and the cache: the chunks of `_f64_continuation` map to
  one entry, max_iter splits none, a reused entry takes the new data.

No JAX here: the loops' JAX parity stays with tests/test_torch_api.py,
test_torch_batch.py and test_torch_solve_batch.py.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           FakeTensorMode)

import admm_library_torch as T
from admm_library_torch import api
from admm_library_torch.core import admm, graph
from admm_library_torch.core.scaling import ruiz_equilibrate
from admm_library_torch.parallel import batch, rowshard
from admm_library_torch.parallel.batch import make_data_mesh
from admm_library_torch.parallel.runtime import Mesh

import torch_loops_reference as ref

torch.set_num_threads(1)

VARIANTS = [(False, False), (False, True), (True, False), (True, True)]
F32, F64 = torch.float32, torch.float64
N, M_BOX, M_L1, SOC = 8, 10, 4, (3, 3)

# Restart every 3 checks, rho test every 2: all four variants occur.
LOOP_SETTINGS = T.Settings(check_every=5, adaptive_rho_interval=10,
                           restart_every=15, history=3, max_iter=400,
                           eps_abs=1e-7, eps_rel=1e-7, stall_checks=0)


def _arrays(rows, seed):
    """One problem of N variables: M_BOX box rows (the first two
    equalities), then M_L1 bounded L1 rows and two SOC(3) blocks where
    `rows` names them."""
    rng = np.random.default_rng(seed)
    ml = M_L1 if "l1" in rows else 0
    soc = SOC if "soc" in rows else ()
    m = M_BOX + ml + sum(soc)
    R = rng.standard_normal((N, N)) / np.sqrt(N)
    A = rng.standard_normal((m, N))
    l = np.full(m, -np.inf)
    u = np.full(m, np.inf)
    l[:M_BOX] = -1.0 - rng.random(M_BOX)
    u[:M_BOX] = 1.0 + rng.random(M_BOX)
    l[:2] = u[:2] = 0.3 * rng.standard_normal(2)
    l[M_BOX:M_BOX + ml] = -2.0
    u[M_BOX:M_BOX + ml] = 2.0
    return dict(P=R @ R.T + 0.1 * np.eye(N), q=rng.standard_normal(N),
                A=A, l=l, u=u, lam=0.1 + rng.random(ml)), \
        T.ConeSpec(m_box=M_BOX, m_l1=ml, soc_dims=soc)


def _qp(arrays, cone, dtype):
    return T.QPData(**{k: torch.as_tensor(v, dtype=dtype)
                       for k, v in arrays.items()}, cone=cone)


def _single(rows, dtype, seed=0):
    """A Ruiz-scaled single problem: (qp, scaling)."""
    return ruiz_equilibrate(_qp(*_arrays(rows, seed), dtype), 10)


def _lanes(rows, dtype, B=3):
    """B independent problems, every leaf with a lane axis, scaled."""
    qps = [_qp(*_arrays(rows, s), dtype) for s in range(B)]
    qp = T.QPData(**{f: torch.stack([getattr(q, f) for q in qps])
                     for f in ("P", "q", "A", "l", "u", "lam")},
                  cone=qps[0].cone)
    return ruiz_equilibrate(qp, 10)


def _shared(rows, dtype, B=4, lane_q=False):
    """B lanes sharing (P, A): box bounds shifted per lane, q shared or
    per lane; scaled as solve_batch_shared scales it."""
    arrays, cone = _arrays(rows, 0)
    qp = _qp(arrays, cone, dtype)
    rng = np.random.default_rng(7)
    shift = torch.zeros((B, qp.m), dtype=dtype)
    shift[:, 2:M_BOX] = torch.as_tensor(
        0.2 * rng.standard_normal((B, M_BOX - 2)), dtype=dtype)
    q = qp.q
    if lane_q:
        q = q + torch.as_tensor(0.1 * rng.standard_normal((B, N)),
                                dtype=dtype)
    qp = T.QPData(P=qp.P, q=q, A=qp.A, l=qp.l + shift, u=qp.u + shift,
                  lam=qp.lam, cone=cone)
    return batch._ruiz(qp, LOOP_SETTINGS, None)


def _zeros(qp, B=None):
    lead = () if B is None else (B,)
    return [torch.zeros(lead + (w,), dtype=qp.dtype)
            for w in (qp.n, qp.m, qp.m)]


def _offset(qp, B=None, seed=3):
    """A shifted-prox offset on the L1 and SOC rows (f64, as the
    re-centred rounds pass it); zero on box rows."""
    rng = np.random.default_rng(seed)
    shape = ((B,) if B else ()) + (qp.m,)
    off = torch.as_tensor(0.1 * rng.standard_normal(shape), dtype=F64)
    off[..., :qp.cone.m_box] = 0.0
    return off


class _Recorder:
    """Records (kind, step, state, key) of every CheckLoop built while
    it is installed, and builds the loop as before."""

    def __init__(self, monkeypatch):
        self.loops = []
        real = graph.CheckLoop

        def spy(kind, step, state, settings, backend, mesh=None, pre=None,
                capture=None, cache=None, **static):
            key = graph.check_key(kind, backend, settings, state, **static)
            loop = real(kind, step, state, settings, backend, mesh=mesh,
                        pre=pre, capture=capture, cache=cache, **static)
            # The loop's own step, which runs the pre inside each check.
            self.loops.append((kind, loop.step, dict(state), key))
            return loop
        monkeypatch.setattr(graph, "CheckLoop", spy)


class TraceNodes:
    """A stand-in for the node builder of a capture (`graph._Capture`)
    that traces each conditional body once and reads nothing, as a
    capture does: under FakeTensorMode `graph.while_blocks` then shows
    whether the loop around the bodies reads the host."""

    def __init__(self):
        self.nodes = []

    def node(self, live, count, block):
        assert live.dtype == torch.bool and live.dim() == 0
        self.nodes.append(count)
        block()


def node_kind(block):
    """What a conditional node's body is: 'cg' (a block of
    `graph.while_blocks`), 'phase' (the WHILE body of `graph.phase_nodes`),
    'segment' (a check variant's or the refactor's IF body there) or
    'program' (a program's branch, `graph.cond` or `graph.repeat`)."""
    fn = getattr(block, "func", block)
    name = fn.__qualname__
    if name.startswith("while_blocks"):
        return "cg"
    if name.startswith("_Program.body"):
        return "program"
    if name.startswith("phase_nodes") and block is not fn:
        return "segment"
    return "phase"


class HostNodes:
    """A stand-in for the node builder of a capture that runs each node
    as the card would, reading its flag on the host: the body while the
    flag holds, at most `count` passes. `graph.while_blocks`' and
    `graph.phase_nodes`' captured forms (the state written in place) then
    run on the CPU. Counts the nodes and the passes of their bodies,
    with each node's kind (`node_kind`) and depth (1 for a node of the
    graph itself, one more for each body it sits in), the passes of the
    CGs' bodies and the segments whose IF bodies ran."""

    def __init__(self):
        self.nodes = []
        self.kinds = []
        self.depths = []
        self.depth = 0
        self.passes = 0
        self.cg_passes = 0
        self.segments = []

    def node(self, live, count, block):
        kind = node_kind(block)
        self.nodes.append(count)
        self.kinds.append(kind)
        self.depths.append(self.depth + 1)
        for _ in range(count):
            if not bool(live):
                break
            self.depth += 1
            try:
                block()
            finally:
                self.depth -= 1
            self.passes += 1
            if kind == "cg":
                self.cg_passes += 1
            elif kind == "segment":
                self.segments.append(block.args[0])

    def cg_nodes(self):
        """The counts of the CGs' nodes, in the order they were built."""
        return [c for c, k in zip(self.nodes, self.kinds) if k == "cg"]


def install_nodes(monkeypatch, builder):
    """Every `graph.while_blocks` outside a capture builds its nodes with
    `builder`; returns it."""
    monkeypatch.setattr(graph, "_node_runner", lambda: builder)
    return builder


# ---------------------------------------------------------------- (a)

def _run_without_host_read(step, state, variants=VARIANTS):
    """Every variant of `step` from `state` under FakeTensorMode; each
    update keeps its entry's shape and dtype."""
    mode = FakeTensorMode()
    fake = graph._map(mode.from_tensor, state)
    with mode:
        for variant in variants:
            for key, t in step(fake, variant).items():
                assert tuple(t.shape) == tuple(fake[key].shape), key
                assert t.dtype == fake[key].dtype, key


def _loop_state(monkeypatch, run, *args, **kw):
    """(step, state at its first check) of the loop that `run` builds,
    from a run of max_iter 0: the initial state, after the prologue for
    the loops that start from their raw data."""
    rec = _Recorder(monkeypatch)
    run(*args, **kw)
    (kind, step, state, _), = rec.loops
    if kind in ("run_admm", "run_admm_lanes", "run_admm_batch_shared"):
        state = dict(state, **step(state, batch.PROLOGUE))
    return step, state


# The fused tail exists in f32 only: the kernel's gate admits no f64.
# "loop/backend" runs the loop on a block backend: N = 8 variables in
# blocks of 2 ('banded'), in 2 parts ('spike').
_FAKE_CASES = [(loop, dtype) for loop in ("run_admm", "run_admm_lanes",
                                          "batch_plain")
               for dtype in ("f32", "f64")] + [("batch_fused", "f32")] + [
    (f"{loop}/{backend}", dtype)
    for loop in ("run_admm", "run_admm_lanes", "batch_plain")
    for backend in ("banded", "spike") for dtype in ("f32", "f64")] + [
    ("solve_rowsharded", dtype) for dtype in ("f32", "f64")]

# The row-sharded loop's check in its four forms.
ROWSHARD_VARIANTS = [("check",) + v for v in VARIANTS]


@pytest.mark.parametrize("rows", ["box", "l1", "soc"])
@pytest.mark.parametrize("loop,dtype", _FAKE_CASES)
def test_check_makes_no_host_read(loop, dtype, rows, monkeypatch):
    dtype = {"f32": F32, "f64": F64}[dtype]
    s = LOOP_SETTINGS.replace(max_iter=0, history=3, band_block=2,
                              spike_parts=2)
    loop, _, backend = loop.partition("/")
    if loop == "run_admm":
        qp, sc = _single(rows, dtype)
        z_off = None if rows == "box" else _offset(qp)
        step, state = _loop_state(monkeypatch, admm.run_admm, qp, sc, s,
                                  *_zeros(qp), backend or "chol",
                                  z_off=z_off)
    elif loop == "run_admm_lanes":
        qp, sc = _lanes(rows, dtype)
        step, state = _loop_state(monkeypatch, admm.run_admm_lanes, qp, sc,
                                  s, *_zeros(qp, 3), backend or "inv")
    elif loop == "batch_plain":
        qp, sc = _shared(rows, dtype, lane_q=True)
        z_off = None if rows == "box" else _offset(qp, 4)
        step, state = _loop_state(monkeypatch, batch.run_admm_batch_shared,
                                  qp, sc, s, *_zeros(qp, 4),
                                  backend or "inv", z_off=z_off)
    elif loop == "solve_rowsharded":
        step, state = _loop_state(monkeypatch, rowshard.solve_rowsharded,
                                  _qp(*_arrays(rows, 0), dtype),
                                  make_data_mesh(device="cpu"), s)
        assert step.keywords["use_cert"]
        # Its CGs as conditional nodes, traced: each iteration's a WHILE
        # node of at most 25 blocks of 8 steps (cg_max_iter 200).
        nodes = install_nodes(monkeypatch, TraceNodes())
        _run_without_host_read(step, state, ROWSHARD_VARIANTS)
        assert nodes.nodes == [25] * (len(ROWSHARD_VARIANTS)
                                      * s.check_every)
        return
    else:
        qp, sc = _shared(rows, dtype)
        step, state = _loop_state(monkeypatch, batch.run_admm_batch_shared,
                                  qp, sc, s, *_zeros(qp, 4), "inv")
        # The fused kernel runs inside the check.
        assert isinstance(step, graph._PreStep)
        assert step.step.keywords["fused"]
    _run_without_host_read(step, state)


@pytest.mark.parametrize("read", ["item", "float", "bool", "tolist"])
def test_fake_mode_catches_a_host_read(read, monkeypatch):
    """The harness of the test above fails a step that reads."""
    qp, sc = _single("box", F64)
    step, state = _loop_state(monkeypatch, admm.run_admm, qp, sc,
                              LOOP_SETTINGS.replace(max_iter=0),
                              *_zeros(qp), "chol")
    how = {"item": lambda t: t.item(), "float": float, "bool": bool,
           "tolist": lambda t: t.tolist()}[read]

    def reading(state, variant):
        out = step(state, variant)
        how(out["r_prim"])
        return out
    with pytest.raises(DataDependentOutputException):
        _run_without_host_read(reading, state)


# ---------------------------------------------------------------- (b)

def _equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor) and isinstance(b, int):
        # An iteration count the host loop kept as an int, now the
        # device's counter.
        return a.dim() == 0 and not a.is_floating_point() and int(a) == b
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _assert_bitwise(new, old):
    for field in old._fields:
        assert _equal(getattr(new, field), getattr(old, field)), field


_ADMM_CASES = {
    "box_chol_f64": ("box", F64, "chol", dict(rho=10.0)),
    "box_inv_f64": ("box", F64, "inv", {}),
    "box_cg_f64": ("box", F64, "cg", dict(rho=10.0)),
    "box_chol_f32_stall": ("box", F32, "chol", dict(stall_checks=3,
                                                     eps_abs=1e-12,
                                                     eps_rel=1e-12)),
    "l1_chol_offset": ("l1", F64, "chol", dict(z_off=True)),
    "soc_inv_offset_rho0": ("soc", F64, "inv", dict(z_off=True, rho0=0.5)),
    "soc_chol_f32": ("soc", F32, "chol", {}),
}


@pytest.mark.parametrize("case", sorted(_ADMM_CASES))
def test_run_admm_is_bitwise_the_plain_loop(case):
    rows, dtype, backend, kw = _ADMM_CASES[case]
    kw = dict(kw)
    qp, sc = _single(rows, dtype)
    z_off = _offset(qp) if kw.pop("z_off", False) else None
    rho0 = kw.pop("rho0", None)
    s = LOOP_SETTINGS.replace(**kw)
    args = (qp, sc, s, *_zeros(qp), backend)
    new = admm.run_admm(*args, z_off=z_off, rho0=rho0)
    old = ref._ref_run_admm(*args, z_off=z_off, rho0=rho0)
    _assert_bitwise(new, old)
    assert new.it >= 4 * s.check_every


_LANES_CASES = {
    "box_chol_f64": ("box", F64, "chol", dict(rho=10.0)),
    "soc_inv_f64": ("soc", F64, "inv", {}),
    "l1_cg_f64": ("l1", F64, "cg", dict(rho=10.0)),
    "box_inv_f32_stall": ("box", F32, "inv", dict(stall_checks=3,
                                                   eps_abs=1e-12,
                                                   eps_rel=1e-12)),
}


@pytest.mark.parametrize("case", sorted(_LANES_CASES))
def test_run_admm_lanes_is_bitwise_the_plain_loop(case):
    rows, dtype, backend, kw = _LANES_CASES[case]
    qp, sc = _lanes(rows, dtype)
    s = LOOP_SETTINGS.replace(**kw)
    args = (qp, sc, s, *_zeros(qp, 3), backend)
    new = admm.run_admm_lanes(*args)
    old = ref._ref_run_admm_lanes(*args)
    _assert_bitwise(new, old)
    assert int(new.it.max()) >= 4 * s.check_every


_BATCH_CASES = {
    "box_inv_f32_fused": ("box", F32, "inv", {}),
    "soc_inv_f32_fused": ("soc", F32, "inv", {}),
    "box_chol_f64_lane_q": ("box", F64, "chol", dict(lane_q=True,
                                                     rho=10.0)),
    "soc_inv_f32_offset": ("soc", F32, "inv", dict(lane_q=True,
                                                   z_off=True)),
    "l1_chol_f32_stall": ("l1", F32, "chol", dict(z_off=True,
                                                  stall_checks=3,
                                                  eps_abs=1e-12,
                                                  eps_rel=1e-12)),
    "box_cg_f64": ("box", F64, "cg", dict(rho0=30.0)),
}


@pytest.mark.parametrize("case", sorted(_BATCH_CASES))
def test_run_admm_batch_shared_is_bitwise_the_plain_loop(case):
    rows, dtype, backend, kw = _BATCH_CASES[case]
    kw = dict(kw)
    qp, sc = _shared(rows, dtype, lane_q=kw.pop("lane_q", False))
    z_off = _offset(qp, 4) if kw.pop("z_off", False) else None
    rho0 = kw.pop("rho0", None)
    if rho0 is not None:
        rho0 = torch.tensor(rho0, dtype=dtype)
    s = LOOP_SETTINGS.replace(**kw)
    args = (qp, sc, s, *_zeros(qp, 4), backend)
    new = batch.run_admm_batch_shared(*args, rho0=rho0, z_off=z_off)
    old = ref._ref_run_admm_batch_shared(*args, rho0=rho0, z_off=z_off)
    _assert_bitwise(new, old)
    assert int(new.iters_lane.max()) >= 4 * s.check_every


# ---------------------------------------------------------------- (c)

def _mesh(data, horizon):
    return Mesh(shape={"data": data, "horizon": horizon},
                coords={"data": 0, "horizon": 0},
                groups={"data": None, "horizon": None},
                ranks={"data": [0], "horizon": [0]},
                world=data * horizon, device=torch.device("cpu"))


_BACKENDS = ["chol", "inv", "banded", "spike", "cg", "pallas_cg",
             "rowshard_cg"]
_MESHES = {"none": None, "1x1": (1, 1), "data2": (2, 1),
           "horizon2": (1, 2), "2x2": (2, 2)}


@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("backend", _BACKENDS)
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_capture_rule(device, backend, mesh):
    shape = _MESHES[mesh]
    m = None if shape is None else _mesh(*shape)
    want = (device == "cuda"
            and backend in ("inv", "chol", "banded", "spike", "cg",
                            "pallas_cg", "rowshard_cg")
            and (shape is None or shape == (1, 1)))
    assert graph.capturable(torch.device(device), backend, m) == want


@pytest.mark.parametrize("backend", ["chol", "cg"])
def test_a_loop_on_the_cpu_is_never_captured(backend, monkeypatch):
    qp, sc = _single("box", F64)
    step, state = _loop_state(monkeypatch, admm.run_admm, qp, sc,
                              LOOP_SETTINGS.replace(max_iter=0),
                              *_zeros(qp), backend)
    loop = graph.CheckLoop("run_admm", step, state, LOOP_SETTINGS, backend)
    assert not loop.capture
    # The plain version holds the caller's tensors; nothing is cloned.
    assert loop.state["qp"]["A"] is state["qp"]["A"]
    with pytest.raises(ValueError, match="not captured"):
        graph.CheckLoop("run_admm", step, state, LOOP_SETTINGS, backend,
                        capture=True)


# ---------------------------------------------------------------- (d)

def _soc_solution(qp):
    z = lambda *s: torch.zeros(s, dtype=F64)  # noqa: E731
    return T.Solution(x=z(qp.n), z=z(qp.m), y=z(qp.m),
                      status=torch.tensor(0, dtype=torch.int32),
                      iters=torch.tensor(0, dtype=torch.int32),
                      r_prim=z(), r_dual=z(), obj=z(), rho=z() + 0.1,
                      history=z(0, 3))


def test_continuation_chunks_share_one_entry(monkeypatch):
    """Each chunk Ruiz-scales anew and rebuilds its loop: one key."""
    qp = _qp(*_arrays("soc", 0), F64)
    s = T.Settings(eps_abs=1e-14, eps_rel=1e-14, max_iter=75, polish=False,
                   backend="chol")
    rec = _Recorder(monkeypatch)
    api._f64_continuation(qp, _soc_solution(qp), s, "chol", chunk=25)
    keys = [key for kind, _, _, key in rec.loops if kind == "run_admm"]
    assert len(keys) == 3
    assert len(set(keys)) == 1


def test_max_iter_does_not_split_the_key(monkeypatch):
    qp, sc = _single("soc", F64)
    rec = _Recorder(monkeypatch)
    for s in (LOOP_SETTINGS.replace(max_iter=5),
              LOOP_SETTINGS.replace(max_iter=50),
              LOOP_SETTINGS.replace(max_iter=50, polish=False,
                                    precision="double"),
              LOOP_SETTINGS.replace(max_iter=5, eps_abs=1e-5)):
        admm.run_admm(qp, sc, s, *_zeros(qp), "chol")
    admm.run_admm(qp, sc, LOOP_SETTINGS.replace(max_iter=5),
                  *_zeros(qp), "inv")
    qp2, sc2 = _single("box", F64)
    admm.run_admm(qp2, sc2, LOOP_SETTINGS.replace(max_iter=5),
                  *_zeros(qp2), "chol")
    k = [key for _, _, _, key in rec.loops]
    assert k[0] == k[1] == k[2]
    # eps is read by the check, the backend and the shapes make it.
    assert len({k[0], k[3], k[4], k[5]}) == 4


def test_cache_reuses_an_entry_with_the_new_data():
    cache = graph.CheckCache(size=2)
    state = {"x": torch.arange(4.0), "qp": {"A": torch.ones(2, 2)}}
    e1 = cache.entry("k1", None, state)
    assert e1.buffers["x"] is not state["x"]          # owned buffers
    new = {"x": torch.full((4,), 7.0), "qp": {"A": torch.eye(2)}}
    assert cache.entry("k1", None, new) is e1
    assert torch.equal(e1.buffers["x"], new["x"])
    assert torch.equal(e1.buffers["qp"]["A"], new["qp"]["A"])
    cache.entry("k2", None, state)
    cache.entry("k3", None, state)
    assert list(cache.entries) == ["k2", "k3"]        # k1 was oldest
