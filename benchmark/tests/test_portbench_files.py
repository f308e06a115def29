"""Every file a cell needs is found by its name, and the frozen artifacts
are the ones the configurations name."""

import hashlib
import importlib
import json
import os

import pytest

from benchmark.harness.cell import BENCH, find_cell, load_benchmark, metric_module
from benchmark.harness.trace import kernel_groups
from benchmark.traffic.generator import load_mix

BENCHMARK = load_benchmark()
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found(cell):
    c = find_cell(cell)
    assert os.path.isdir(c.config_dir)
    assert callable(c.reference().Reference)
    assert callable(c.roofline().layers)
    assert callable(c.driver().run)
    assert "setup_s" in [m["name"] for m in c.end_to_end]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCHMARK["per_layer"]])
def test_metric_readers_are_found(metric):
    assert callable(metric_module(metric).read)


@pytest.mark.parametrize("mix", sorted({w["traffic"] for w in BENCHMARK["workloads"]}))
def test_traffic_mixes_are_data(mix):
    assert os.path.exists(os.path.join(BENCH, "traffic", f"{mix}.json"))
    kind = load_mix(mix)["kind"]
    assert os.path.exists(os.path.join(BENCH, "drivers", f"{kind}.py"))


@pytest.mark.parametrize("config", [c["name"] for c in BENCHMARK["configs"]])
def test_frozen_artifact_is_the_named_one(config):
    cell = find_cell(next(w["name"] for w in BENCHMARK["workloads"] if w["config"] == config))
    with open(os.path.join(cell.config_dir, "model_static_int8.msgpack"), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == cell.config["artifact_sha256"]
    assert cell.config["name"] == config
    assert cell.config["online_capacity_images_per_s"] > 0
    assert 0 < cell.config["limits"]["logit_gap"] < 1


def test_kernel_groups_name_the_roofline_groups():
    groups = kernel_groups()
    assert {"conv_gemm", "mbconv"} <= set(groups)
    for c in {w["config"] for w in BENCHMARK["workloads"]}:
        cell = find_cell(next(w["name"] for w in BENCHMARK["workloads"] if w["config"] == c))
        with open(os.path.join(cell.config_dir, "spec.json")) as f:
            spec = json.load(f)
        assert {x["group"] for x in cell.roofline().layers(spec, 1)} <= set(groups)


def test_reference_modules_load():
    for name in ("resnet_int8", "effnet_int8_fused"):
        assert importlib.import_module(f"benchmark.reference.{name}").Reference


def test_a_probe_reads_the_program_around_the_stretch():
    """A metric's ``probe()`` is read as the profiled stretch starts and as
    it stops, and its reader gets both."""
    from types import SimpleNamespace

    from benchmark.harness.trace import Stretch

    count = [0]

    def probe():
        count[0] += 5
        return count[0]

    stretch = Stretch(False, {"launches_per_forward.offline": probe})
    stretch.start()
    stretch.stop()
    assert stretch.probed == {"launches_per_forward.offline": (5, 10)}
    ctx = SimpleNamespace(probe=stretch.probed["launches_per_forward.offline"],
                          stretch={"forwards": 2})
    assert metric_module("launches_per_forward.offline").read(ctx) == 2.5
    assert metric_module("launches_per_forward.offline").read(
        SimpleNamespace(probe=(7, 7), stretch={"forwards": 2})) is None
