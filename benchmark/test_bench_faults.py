"""The comparison that decides `correct` fails where it should: a whole
run, with the look for a card skipped, and the timed path broken
underneath (a fault), or with the control in the program's place, comes
out not correct; the sound run comes out correct. On the CPU, at a size
a test run holds (the campaign cut to 4 lanes)."""
import dataclasses
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.readings import CONTROL

HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    base = tmp_path_factory.mktemp("bench") / "benchmark"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*"))
    wl = json.loads((base / "workloads" / "campaign1024.json").read_text())
    wl.update(lanes=4, pool_calls=3, sample_calls=0)
    (base / "workloads" / "campaign1024.json").write_text(json.dumps(wl))
    return base, harness.load_spec()


def _run(small, cell, **kw):
    base, spec = small
    result, _ = harness.run(cell, 2**31 + 3, 0.3, False, device="cpu",
                            spec=spec, base=base, log=lambda *a: None, **kw)
    return result


def unchanged(entry):
    """The solve returns the state it was handed (the cold start, zeros)
    and says SOLVED."""
    def call(qp, settings):
        sol = entry(qp, settings)
        zero = {k: torch.zeros_like(getattr(sol, k)) for k in ("x", "z", "y")}
        return dataclasses.replace(sol, status=torch.ones_like(sol.status),
                                   **zero)
    return call


def half_batch(entry):
    """Half of the lanes left out: the first half is solved and its
    answers stand in for the second half's."""
    def call(qp, settings):
        B = qp.l.shape[0]
        h = B // 2
        part = dataclasses.replace(qp, l=qp.l[:h], u=qp.u[:h])
        sol = entry(part, settings)
        idx = torch.arange(B) % h
        return dataclasses.replace(
            sol, **{k: getattr(sol, k)[idx] for k in
                    ("x", "z", "y", "status", "iters", "r_prim", "r_dual",
                     "obj")})
    return call


def altered(entry):
    """Every answer altered where it is produced: one control of x moved
    by 1e-4."""
    def call(qp, settings):
        sol = entry(qp, settings)
        x = sol.x.clone()
        x[..., 0] += 1e-4
        return dataclasses.replace(sol, x=x)
    return call


@pytest.mark.parametrize("cell", ["rdv.mc1024", "rdv.replan"])
def test_sound_run_is_correct(small, cell):
    result = _run(small, cell)
    assert result["correct"] is True and result["failed"] == 0


@pytest.mark.parametrize("cell,fault", [
    ("rdv.mc1024", unchanged), ("rdv.mc1024", half_batch),
    ("rdv.mc1024", altered), ("rdv.replan", unchanged),
    ("rdv.replan", altered)])
def test_a_fault_is_not_correct(small, cell, fault):
    result = _run(small, cell, entry_wrap=fault)
    assert result["correct"] is False
    assert result["compared"]["kkt_ratio"]["value"] > \
        result["compared"]["kkt_ratio"]["limit"]


@pytest.mark.parametrize("cell", ["rdv.mc1024", "rdv.replan"])
def test_the_control_is_not_correct(small, cell):
    """The program's own single-precision path in its place fails one of
    the numbers compared."""
    result = _run(small, cell, settings_change=CONTROL)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"]
               for c in result["compared"].values())
