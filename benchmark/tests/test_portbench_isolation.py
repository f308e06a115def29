"""The references import nothing of JAX, the JAX package or the program,
and the run's guard tells the JAX package from the port by whole names."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness.cell import BENCH, ROOT
from benchmark.harness.guard import FORBIDDEN, forbidden_loaded

PROGRAM = "inference_efficient_vision_models_tpu_torch"
REF_DIR = os.path.join(BENCH, "reference")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(REF_DIR) if f.endswith(".py")))
def test_reference_imports_nothing_of_jax_or_the_program(name):
    tops = {m.split(".")[0] for m in _imports(os.path.join(REF_DIR, name))}
    assert not tops & (set(FORBIDDEN) | {PROGRAM})
    assert tops <= {"__future__", "contextlib", "json", "os", "struct", "typing", "numpy", "torch"}


def test_guard_compares_whole_top_level_names():
    assert forbidden_loaded(["inference_efficient_vision_models_tpu.ops"]) == [
        "inference_efficient_vision_models_tpu.ops"]
    assert forbidden_loaded(["inference_efficient_vision_models_tpu_torch",
                             "inference_efficient_vision_models_tpu_torch.serving",
                             "jaxtyping", "flaxen"]) == []
    assert forbidden_loaded(["jax", "jaxlib.xla_client", "flax.core"]) == [
        "flax.core", "jax", "jaxlib.xla_client"]


def test_no_cuda_no_result():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "r18_int8.offline",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files:
    the program is missing, so a run fails and prints nothing."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.msgpack"))
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import run; "
            "sys.exit(run.main(['--workload', 'r18_int8.offline', '--seed', '1', '--seconds', "
            "'1', '--trace', '0'], device='cpu'))")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert PROGRAM in r.stderr
