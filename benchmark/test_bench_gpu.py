"""On the card: every cell of BENCHMARK.json through the command, with a
short window, comes out correct and prints its result as its last line;
the control, at the campaign's own size, comes out not correct.

    python3 -m pytest benchmark/test_bench_gpu.py -m gpu -q
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.readings import CONTROL

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _cells():
    return [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_through_the_command(card, trace):
    for cell in _cells():
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell,
             "--seed", str(2**31 + 17), "--seconds", "2", "--trace",
             str(trace)], cwd=ROOT, capture_output=True, text=True,
            timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is True, result["compared"]
        assert result["device"]["platform"] == "gpu"
        assert out.stderr.strip().splitlines()[-1].startswith(
            "compared kkt_ratio")


@pytest.mark.gpu
def test_control_at_the_campaigns_size(card):
    result, _ = harness.run("rdv.mc1024", 2**31 + 19, 2.0, False,
                            settings_change=CONTROL, log=lambda *a: None)
    assert result["correct"] is False
    assert result["compared"]["kkt_ratio"]["value"] > \
        result["compared"]["kkt_ratio"]["limit"]
