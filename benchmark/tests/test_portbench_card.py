"""One short run of each cell on the card: a result line in the contract's
shape, with ``correct`` true. Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest

from benchmark.harness.cell import ROOT, load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell, trace):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        "3000000099", "--seconds", "4", "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["device"]["kind"] == card and result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in result["metrics"]
