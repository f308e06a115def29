"""A cell of ``BENCHMARK.json`` and the files that belong to it, found by
name: the configuration's file (its ``file`` entry), the traffic mix
(``traffic/<traffic>.json``) and the driver its ``"kind"`` names
(``drivers/<kind>.py``), the reference and roofline modules the
configuration names (``reference/<name>.py``, ``roofline/<name>.py``) and a
reader per per-layer metric (``metrics/<metric>.py``)."""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

from ..traffic.generator import load_mix

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_benchmark(root: str = ROOT) -> Dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics: List[Dict], cell: str) -> List[Dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict           # the configuration's file
    config_dir: str        # the directory of its frozen artifact
    traffic: Dict          # the mix's parameters
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)

    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(f"benchmark.reference.{self.config['reference']}")

    def roofline(self):
        return importlib.import_module(f"benchmark.roofline.{self.config['roofline']}")

    def driver(self):
        """The module that drives the system with the cell's mix: its
        ``run(cell, prog, pool, seconds, stretch, seed)`` sets up what the
        mix puts in front of the program, measures the window and returns its
        numbers, counters and sample."""
        return importlib.import_module(f"benchmark.drivers.{self.traffic['kind']}")


def find_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    path = os.path.join(root, conf["file"])
    with open(path) as f:
        config = json.load(f)
    config_dir = os.path.join(os.path.dirname(path), config["artifact"])
    return Cell(name, w, config, config_dir, load_mix(w["traffic"]),
                _for_cell(bench["end_to_end"], name), _for_cell(bench["per_layer"], name))


@functools.lru_cache(maxsize=None)
def metric_module(metric: str):
    """``metrics/<metric>.py``: its ``read(ctx)``, and where the metric reads
    a counter of the program around the profiled stretch, its ``probe()``."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
