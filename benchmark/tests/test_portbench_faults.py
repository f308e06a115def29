"""A whole run on the CPU at a small size (the harness's look for a card
skipped), with the timed path broken underneath: ``correct`` comes out
false for each fault a serving cell can have, and true without one."""

import json

import pytest
import torch

from benchmark import run


def half_batch(fn):
    """Half of each batch left out: its rows answered with the other half's."""
    def broken(x):
        y = fn(x[: max(1, len(x) // 2)])
        return torch.cat([y, y])[: len(x)]
    return broken


def nonfinite_answer(fn):
    """The first answer of every forward made NaN where it is produced."""
    def broken(x):
        y = fn(x).clone()
        y[0] = float("nan")
        return y
    return broken


def altered_answer(fn):
    """The first answer of every forward altered where it is produced."""
    def broken(x):
        y = fn(x).clone()
        y[0, 0] += 0.5 * y.abs().max()
        return y
    return broken


SMALL = {
    "offline": {"pool_images": 8, "batch_size": 4, "sample_images": 8,
                "trace_skip_s": 0.0, "trace_seconds": 0.2},
    "open_loop": {"pool_images": 16, "batch_size": 8, "buckets": [1, 4], "sample_requests": 64,
                  "drain_limit_s": 120.0, "trace_skip_s": 0.0, "trace_seconds": 0.2},
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", [None, half_batch, altered_answer, nonfinite_answer],
                         ids=["sound", "half_batch", "altered_answer", "nonfinite_answer"])
@pytest.mark.parametrize("cell,seconds", [("r18_int8.offline", "0.5"),
                                          ("b0_int8_fused.offline", "0.5"),
                                          ("r18_int8.online", "2")])
def test_fault_makes_the_run_incorrect(cell, seconds, fault, capsys):
    kind = "offline" if cell.endswith("offline") else "open_loop"
    rc = run.main(["--workload", cell, "--seed", "3000000001", "--seconds", seconds,
                   "--trace", "0"], device="cpu", wrap_apply=fault,
                  overrides={"traffic": SMALL[kind],
                             "config": {"online_capacity_images_per_s": 20.0}})
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert result["correct"] is (fault is None)
    assert (result["checks"]["nonfinite"]["value"] > 0) is (fault is nonfinite_answer)
