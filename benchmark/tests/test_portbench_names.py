"""BENCHMARK.json keeps to the contract's shapes: names, units, texts and
the ties between per-layer and end-to-end metrics."""

import json
import os
import re

import pytest

from benchmark.harness.cell import ROOT, load_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return load_benchmark()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    files = [w for w in bench["command"] if "/" in w]
    assert all(any(f == p or f.startswith(p + "/") for p in bench["paths"]) for f in files)
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_allowed(bench, part):
    names = [e["name"] for e in bench[part]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    fours = sum(w["chips"] == 4 for w in bench["workloads"])
    assert fours <= max(1, len(bench["workloads"]) // 4)


def _cells_of(metric, bench):
    return metric.get("workloads", [w["name"] for w in bench["workloads"]])


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(_cells_of(m, bench)) <= cells
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in _cells_of(m, bench):
            assert cell in cells and cell in _cells_of(e2e[m["moves"]], bench)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer metric each
        assert sum(cell in _cells_of(m, bench) for m in bench["end_to_end"]) >= 2
        assert any(cell in _cells_of(m, bench) for m in bench["per_layer"])


def test_json_is_plain(bench):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        assert json.load(f) == bench
