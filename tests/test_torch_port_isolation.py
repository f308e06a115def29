"""The port and its GPU script import neither JAX, flax, msgpack nor the JAX
package, nor a package the GPU machine lacks (sklearn, pandas, tabulate,
matplotlib, PIL, tqdm, torchvision)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys

FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "inference_efficient_vision_models_tpu",
             "sklearn", "pandas", "tabulate", "matplotlib", "PIL", "tqdm", "torchvision")


class Absent:
    # as on the GPU machine: importing one of these fails (torch itself
    # imports tqdm when it is installed, and copes when it is not)
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"{name} is not installed on the GPU machine")
        return None


sys.meta_path.insert(0, Absent())
import inference_efficient_vision_models_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
print(len(mods), bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    n, bad = r.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) >= 60, r.stdout  # every module of the port was imported
    assert bad == "[]", bad
