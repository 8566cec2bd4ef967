"""The port's utilities against the JAX package's: checkpoints (the same
np.savez format, written atomically, loadable by either package, and a
resume through the warm start), the profiling hooks on the CPU, and the
active-set oracle (the same numbers to 1e-12 on the same seeded box
QPs).
"""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_library_tpu.utils import checkpoint as jcheckpoint
from admm_library_tpu.utils import oracle as joracle
from admm_library_torch import Settings, Status, solve_batch_shared
from admm_library_torch.models import monte_carlo as mc
from admm_library_torch.utils import checkpoint, oracle, profiling

torch.set_num_threads(1)

F64 = torch.float64


def _solved_batch():
    qp, _, _ = mc.monte_carlo_mpc(torch.Generator().manual_seed(0),
                                  batch=4, N=6, dim=2, dtype=F64,
                                  device="cpu")
    s = Settings(eps_abs=1e-7, eps_rel=1e-7, precision="double")
    return qp, s, solve_batch_shared(qp, s)


def test_checkpoint_round_trip_on_the_cpu(tmp_path):
    _, _, sol = _solved_batch()
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, sol, extra={"seed": np.int64(7)})
    st = checkpoint.load_state(path, device="cpu")
    assert set(st) == {"x", "z", "y", "rho", "iters", "seed"}
    for f in ("x", "z", "y", "rho", "iters"):
        assert torch.equal(st[f], getattr(sol, f)), f
    assert int(st["seed"]) == 7
    low = checkpoint.load_state(path, dtype=torch.float32, device="cpu")
    assert low["x"].dtype == torch.float32
    assert low["iters"].dtype == sol.iters.dtype       # not a float: kept


def test_checkpoint_overwrite_is_atomic(tmp_path, monkeypatch):
    """A write that fails midway leaves the last good checkpoint whole
    and no file in its place."""
    path = str(tmp_path / "state.npz")
    good = {"x": torch.arange(3, dtype=F64), "z": torch.zeros(2, dtype=F64),
            "y": torch.ones(2, dtype=F64)}
    checkpoint.save_state(path, good)
    checkpoint.save_state(path, {**good, "x": torch.full((3,), 2.0,
                                                         dtype=F64)})
    assert torch.equal(checkpoint.load_state(path, device="cpu")["x"],
                       torch.full((3,), 2.0, dtype=F64))
    assert not Path(path + ".tmp").exists()

    def broken(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.np, "savez", broken)
    with pytest.raises(OSError):
        checkpoint.save_state(path, good)
    monkeypatch.undo()
    assert torch.equal(checkpoint.load_state(path, device="cpu")["x"],
                       torch.full((3,), 2.0, dtype=F64))


def test_checkpoint_loads_across_packages(tmp_path):
    _, _, sol = _solved_batch()
    ours = str(tmp_path / "port.npz")
    theirs = str(tmp_path / "jax.npz")
    checkpoint.save_state(ours, sol)
    jst = jcheckpoint.load_state(ours)
    for f in ("x", "z", "y", "rho", "iters"):
        np.testing.assert_array_equal(np.asarray(jst[f]),
                                      getattr(sol, f).numpy())
    jcheckpoint.save_state(theirs, {"x": jnp.asarray(sol.x.numpy()),
                                    "z": jnp.asarray(sol.z.numpy()),
                                    "y": jnp.asarray(sol.y.numpy()),
                                    "rho": jnp.asarray(0.25)})
    x0, z0, y0 = checkpoint.resume_warm_start(theirs, device="cpu")
    for got, want in ((x0, sol.x), (z0, sol.z), (y0, sol.y)):
        assert torch.equal(got, want)


def test_resume_from_a_checkpoint_solves_within_one_check(tmp_path):
    qp, s, sol = _solved_batch()
    assert torch.all(sol.status == int(Status.SOLVED))
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, sol)
    x0, z0, y0 = checkpoint.resume_warm_start(path, device="cpu")
    warm = solve_batch_shared(qp, s, x0=x0, z0=z0, y0=y0)
    assert torch.all(warm.status == int(Status.SOLVED))
    assert int(warm.iters.max()) == s.check_every
    assert float((warm.x - sol.x).abs().max()) <= 1e-6


def test_load_state_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, {"x": torch.zeros(2)})
    if torch.cuda.is_available():
        assert checkpoint.load_state(path)["x"].is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            checkpoint.load_state(path)


def test_timed_and_phase_costs_on_the_cpu():
    calls = []

    def work(n):
        calls.append(n)
        return torch.ones(n).sum()

    out, best = profiling.timed(work, 10, warmup=2, iters=3)
    assert float(out) == 10.0 and len(calls) == 5 and best >= 0.0
    costs = profiling.phase_costs(work, work, 4)
    assert set(costs) == {"factor_s", "total_s", "iterate_s"}
    assert costs["iterate_s"] >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("seed,n,m,n_active",
                         [(0, 20, 40, 8), (1, 30, 60, 12), (3, 12, 30, 5)])
def test_activeset_oracle_matches_jax(seed, n, m, n_active):
    jqp, jx_star, _ = joracle.qp_known_solution(seed, n=n, m=m,
                                                n_active=n_active)
    qp, x_star, _ = oracle.qp_known_solution(seed, n=n, m=m,
                                             n_active=n_active)
    jx, jy = joracle.solve_box_qp_activeset(jqp)
    x, y = oracle.solve_box_qp_activeset(qp)
    assert x.dtype == F64 and x.device == qp.device
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-12)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-12)
    # And it finds the constructed optimum.
    np.testing.assert_allclose(x.numpy(), x_star.numpy(), rtol=0, atol=1e-8)
