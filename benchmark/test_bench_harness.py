"""The harness's arithmetic, its discovery of cells and metrics by name,
the shape of its last line, and that nothing it runs loads JAX."""
import json
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from benchmark import arith, harness

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _reader(name):
    return harness._module(HERE / "metrics" / f"{name}.py")


def test_percentile_is_numpys_linear_over_every_call():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 200, 513):
        v = list(rng.exponential(40.0, n))
        for q in (50, 95):
            assert arith.percentile(v, q) == pytest.approx(
                float(np.percentile(v, q)), rel=1e-12)


def test_end_to_end_readers_take_every_call_of_the_window():
    calls = [90.0] * 180 + [100.0] * 19 + [250.0]
    run = types.SimpleNamespace(lanes=1024, calls_ms=calls, window_s=20.0,
                                setup_s=7.5)
    assert _reader("problems_per_s").read(run) == 1024 * 200 / 20.0
    p95 = float(np.percentile(calls, 95))
    assert _reader("batch_p95_ms").read(run) == pytest.approx(p95)
    assert _reader("solve_p95_ms").read(run) == pytest.approx(p95)
    assert _reader("setup_s").read(run) == 7.5


def test_per_layer_readers_and_their_silence():
    run = types.SimpleNamespace(
        lanes=1, calls_ms=[40.0, 42.0, 44.0], window_s=0.2,
        iters=[700, 750, 800], replays=[1, 1, 1], host_reads=[0, 0, 0],
        replay_ms=[38.0, 40.0, 42.0], captures=1, capture_ms=600.0,
        kernel1=dict(ms=0.9, bound_ms=0.00076))
    assert _reader("solve_p50_ms.replan").read(run) == 42.0
    assert _reader("iters.replan").read(run) == 750.0
    assert _reader("graph_launches_per_call.replan").read(run) == 1.0
    assert _reader("host_reads_per_call.replan").read(run) == 0.0
    assert _reader("capture_s").read(run) == 0.6
    assert _reader("device_us_per_iter.replan").read(run) == pytest.approx(
        1e3 * 120.0 / 2250)
    assert _reader("device_idle_pct.replan").read(run) == pytest.approx(
        100 * (1 - 0.120 / 0.2))
    assert _reader("kernel1_roofline.replan").read(run) == pytest.approx(
        100 * 0.00076 / 0.9)
    quiet = types.SimpleNamespace(
        lanes=1, calls_ms=[1.0], window_s=1.0, iters=[1], replays=None,
        host_reads=None, replay_ms=None, captures=0, capture_ms=0.0,
        kernel1=None)
    for name in ("graph_launches_per_call.replan",
                 "host_reads_per_call.replan", "capture_s",
                 "device_us_per_iter.mc", "device_idle_pct.mc",
                 "kernel1_roofline.mc"):
        assert _reader(name).read(quiet) is None, name


def test_fused_work_counts():
    """Kernel 1's k-block at the campaign's shapes: 2 FMA-flops for each
    of A's and Aᵀ's products and the 1 + 2 refine products with M^-1 and
    M, per lane and iteration; each input read and x, z, y written once in
    f32."""
    B, n, m, k, refine = 1024, 450, 456, 25, 1
    flops, nbytes = arith.fused_work(B, n, m, 0, k, refine)
    assert flops == 2 * B * k * (2 * m * n + 3 * n * n) == 52116480000
    assert nbytes == 4 * (m * n + 2 * n * n + n + m + 2 * B * m
                          + 2 * B * (n + 2 * m)) == 17337480
    ms, by = arith.bound(flops, nbytes)
    assert by == "operations" and ms == pytest.approx(
        1e3 * flops / 67e12)


def test_spec_meets_the_contract():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"][1].startswith(
        "benchmark/")
    configs = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    names = [w["name"] for w in spec["workloads"]]
    for w in spec["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert (HERE / "workloads" / f"{w['traffic']}.json").is_file()
        assert 0 < len(w["why"]) <= 200
        harness.Cell(w["name"], spec)     # every file of the cell found
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", names)) <= set(names)
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in moves and m["workloads"]
        e2e = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(e2e.get("workloads", names))
    # A full check of 24 cells fits its 43200 seconds.
    assert 1 <= spec["run_seconds"] <= 51
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 2 * 90 \
        + 1200 <= 43200


def _small_spec(tmp_path, lanes=4):
    """A copy of the benchmark's files under tmp_path with the campaign
    cut to `lanes` lanes and a short pool, and the spec."""
    base = tmp_path / "benchmark"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*"))
    wl = json.loads((base / "workloads" / "campaign1024.json").read_text())
    wl.update(lanes=lanes, pool_calls=4, sample_calls=2)
    (base / "workloads" / "campaign1024.json").write_text(json.dumps(wl))
    return base, harness.load_spec()


def test_last_line_keys(tmp_path):
    base, spec = _small_spec(tmp_path)
    for trace in (False, True):
        result, rec = harness.run("rdv.mc1024", 2**31 + 11, 0.3, trace,
                                  device="cpu", spec=spec, base=base,
                                  log=lambda *a: None)
        keys = list(result)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                            "device"] and keys[-1] == "compared"
        assert result["correct"] is True and result["failed"] == 0
        assert result["attempted"] == 4 * len(rec.calls_ms)
        assert set(result["compared"]) == {"unsolved", "kkt_ratio"}
        for c in result["compared"].values():
            assert set(c) == {"value", "limit"}
        want = {m["name"] for m in (spec["per_layer"] if trace
                                    else spec["end_to_end"])
                if "rdv.mc1024" in m.get("workloads", ["rdv.mc1024"])}
        assert set(result["metrics"]) <= want
        if not trace:
            assert set(result["metrics"]) == want
        else:
            assert {"busy_s", "window_s"} <= set(result["device"])
            assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_command_prints_compared_last(monkeypatch, capsys):
    from benchmark import run as cli
    canned = {"correct": True, "attempted": 2, "failed": 0,
              "metrics": {"setup_s": {"value": 1.0, "unit": "s"}},
              "device": {"platform": "gpu", "kind": "x", "count": 1,
                         "memory_peak_bytes": 1},
              "compared": {"unsolved": {"value": 0, "limit": 0},
                           "kkt_ratio": {"value": 0.5, "limit": 4.0}}}
    monkeypatch.setattr(harness, "run", lambda *a, **k: (canned, None))
    assert cli.main(["--workload", "rdv.mc1024", "--seed", "3",
                     "--seconds", "1"]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == canned
    assert err.strip().splitlines()[-2:] == [
        "compared unsolved 0 limit 0", "compared kkt_ratio 0.5 limit 4.0"]


def test_command_without_a_card_prints_no_result(capsys):
    from benchmark import run as cli
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert cli.main(["--workload", "rdv.mc1024", "--seed", "3",
                     "--seconds", "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no result" in err


def test_a_cell_and_a_metric_added_as_data_are_found(tmp_path):
    base, spec = _small_spec(tmp_path)
    traffic = {"entry": "solve_batch_shared", "lanes": 3,
               "draw": {"kind": "uniform", "center": "nominal",
                        "half_width": [0.05] * 6},
               "pool_calls": 2, "warm_calls": 1, "sample_calls": 0,
               "why": "a test mix"}
    (base / "workloads" / "test_mix.json").write_text(json.dumps(traffic))
    (base / "metrics" / "calls_seen.mc3.py").write_text(
        "def read(run):\n    return float(len(run.calls_ms))\n")
    spec = json.loads(json.dumps(spec))
    spec["workloads"].append({"name": "rdv.mc3", "config": "rendezvous_h50",
                              "traffic": "test_mix", "chips": 1,
                              "why": "added as data"})
    spec["per_layer"].append({"name": "calls_seen.mc3", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "device",
                              "moves": "problems_per_s",
                              "workloads": ["rdv.mc3"]})
    for m in spec["end_to_end"]:
        if m["name"] in ("problems_per_s", "batch_p95_ms"):
            m["workloads"].append("rdv.mc3")
    result, rec = harness.run("rdv.mc3", 5, 0.2, True, device="cpu",
                              spec=spec, base=base, log=lambda *a: None)
    assert result["metrics"]["calls_seen.mc3"]["value"] == len(rec.calls_ms)
    assert result["attempted"] == 3 * len(rec.calls_ms)
    result, _ = harness.run("rdv.mc3", 5, 0.2, False, device="cpu",
                            spec=spec, base=base, log=lambda *a: None)
    assert set(result["metrics"]) == {"problems_per_s", "batch_p95_ms",
                                      "setup_s"}


def test_forbidden_names_are_whole_top_level_names():
    assert harness.loaded_forbidden(
        ["jax", "jax.numpy", "jaxlib.xla", "flax", "admm_library_tpu.api",
         "admm_library_torch", "admm_library_torch.api", "jaxtyping",
         "flaxen", "numpy"]) == [
        "admm_library_tpu.api", "flax", "jax", "jax.numpy", "jaxlib.xla"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole run, in a fresh interpreter, leaves no module of JAX or of
    the JAX package in sys.modules."""
    base, _ = _small_spec(tmp_path)
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "res, _ = harness.run('rdv.replan', 9, 0.2, True, device='cpu', "
        "base=Path(%r), log=lambda *a: None)\n"
        "print(res['correct'], harness.loaded_forbidden(sys.modules))\n"
        % (str(ROOT), str(base)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"
