"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
It sets the system up (kernels from the checkout's build cache, the
configuration's frozen artifact, the seeded traffic, the cell's own shapes
warmed), measures the window, checks what the window's calls returned
against the plain reference, and prints one JSON line last on standard
output: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``, from a profiled stretch of the window). Each number
compared, with its limit, is printed last on standard error and under the
result's last key, ``checks``.

It exits with another code than 0 and prints no result where the machine
has no usable CUDA card, where the program or a file of the cell is
missing, or where a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, Dict, List, Optional, Tuple  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness.cell import Cell, find_cell, metric_module  # noqa: E402
from benchmark.harness.guard import forbidden_loaded  # noqa: E402
from benchmark.harness.peaks import peaks_for  # noqa: E402
from benchmark.harness.trace import Stretch, kernel_groups, span  # noqa: E402
from benchmark.traffic import generator  # noqa: E402

REF_CHUNK = 32  # images per reference forward: float64 activations of a few GB


class RunError(Exception):
    """A run that cannot give a result; the message goes to standard error."""


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def check_devices(cell: Cell) -> str:
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the port on NVIDIA cards")
    if torch.cuda.device_count() < chips:
        raise RunError(f"{cell.name} needs {chips} CUDA devices, found "
                       f"{torch.cuda.device_count()}")
    return "cuda"


def guard(stage: str) -> None:
    bad = forbidden_loaded()
    if bad:
        raise RunError(f"JAX or the JAX package was loaded ({stage}): {', '.join(bad)}")


class Program:
    """The system under test for a cell: the port's served model behind a
    ``Predictor``. A mix's driver (``drivers/<kind>.py``) puts what stands in
    front of it, such as a ``MicroBatcher``, under the program with ``own``."""

    def __init__(self, cell: Cell, device: str, wrap_apply: Optional[Callable] = None):
        from inference_efficient_vision_models_tpu_torch import serving

        conf, mix = cell.config, cell.traffic
        if device == "cuda":
            from inference_efficient_vision_models_tpu_torch.ops import _lib

            _lib.build_all()
        _, self.model, fn, pre = serving.load_quantized(
            cell.config_dir, conf["method"], device=device,
            device_preprocess=bool(conf.get("device_preprocess", False)))
        if wrap_apply is not None:
            fn = wrap_apply(fn)
        self.pred = serving.Predictor(fn, host_preprocess=pre, batch_size=mix["batch_size"],
                                      bucket_sizes=tuple(mix.get("buckets", ())) or None,
                                      device=device)
        self.owned: List[Tuple[object, Tuple[str, ...]]] = [(self.pred, ("_stage_host", "_run"))]

    def own(self, obj, *spanned: str):
        """``obj`` is closed with the program, and a traced run spans the
        calls of its methods ``spanned``."""
        self.owned.append((obj, spanned))
        return obj

    def instrument(self) -> None:
        """Host spans around the calls into each layer, for a traced run."""
        for obj, names in self.owned:
            for name in names:
                f = getattr(obj, name)

                def wrapped(*a, _f=f, _n=f"bench.{name.strip('_')}", **k):
                    with span(_n, True):
                        return _f(*a, **k)

                setattr(obj, name, wrapped)

    def release(self) -> None:
        """Close what the drivers put under the program; the Predictor stays."""
        for obj, _ in reversed(self.owned[1:]):
            obj.close()
        del self.owned[1:]

    def close(self) -> None:
        self.release()
        self.owned = []
        self.pred = self.model = None


def logit_gap(prog: np.ndarray, ref: np.ndarray, scale: Optional[float] = None) -> float:
    """The largest |program - reference| logit, relative to ``scale``: by
    default the reference's largest |logit| over the compared rows."""
    scale = float(np.abs(ref).max() if scale is None else scale)
    return float(np.abs(prog.astype(np.float64) - ref).max() / scale) if scale else math.inf


def reference_logits(cell: Cell, device: str, images: np.ndarray) -> np.ndarray:
    ref = cell.reference().Reference(cell.config_dir, device)
    out = []
    for i in range(0, len(images), REF_CHUNK):
        x = torch.from_numpy(np.ascontiguousarray(images[i : i + REF_CHUNK])).to(device)
        out.append(ref(x).cpu().numpy())
    del ref
    return np.concatenate(out).astype(np.float64)


def probes(cell: Cell) -> Dict[str, Callable]:
    """The ``probe()`` of each of the cell's per-layer metrics that has one."""
    mods = {m["name"]: metric_module(m["name"]) for m in cell.per_layer}
    return {name: mod.probe for name, mod in mods.items() if hasattr(mod, "probe")}


def per_layer(cell: Cell, run: Dict, trace, probed: Dict, device_kind: str) -> Dict:
    batch = cell.traffic["batch_size"]
    with open(os.path.join(cell.config_dir, "spec.json")) as f:
        spec = json.load(f)
    hw = tuple(cell.config["image_hw"])
    roof = cell.roofline()
    ctx = SimpleNamespace(
        cell=cell, trace=trace, stretch=run.get("stretch", {}),
        counters=run["counters"], layers=roof.layers(spec, batch, hw),
        macs_per_image=sum(layer["macs"] for layer in roof.layers(spec, 1, hw)),
        peaks=peaks_for(device_kind), groups=kernel_groups())
    out = {}
    for m in cell.per_layer:
        ctx.probe = probed.get(m["name"])
        v = metric_module(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def main(argv: Optional[List[str]] = None, *, device: Optional[str] = None,
         wrap_apply: Optional[Callable] = None, overrides: Optional[Dict] = None) -> int:
    """One run. ``device``, ``wrap_apply`` and ``overrides`` ({"traffic":
    {...}, "config": {...}}) are for the benchmark's own tests (a CPU run at
    a small size, a fault planted under the timed path); the command line
    never sets them."""
    args = parse(argv)
    try:
        cell = find_cell(args.workload)
        for part, values in (overrides or {}).items():
            getattr(cell, part).update(values)
        if device is None:
            device = check_devices(cell)
        cuda = device == "cuda"
        guard("before set-up")
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        mix = cell.traffic
        prog = Program(cell, device, wrap_apply)
        pool = generator.frames(mix["pool_images"], cell.config["image_hw"], args.seed)
        stretch = Stretch(cuda, probes(cell)) if args.trace else None
        run = cell.driver().run(cell, prog, pool, args.seconds, stretch, args.seed)
        setup_s = run["t_window"] - PROCESS_T0
        dev_kind = torch.cuda.get_device_name(0) if cuda else "cpu"
        memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        prog.close()
        del prog
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        guard("after the window")

        t_ref = time.perf_counter()
        sample = run["sample"]
        ref = reference_logits(cell, device, sample["images"])
        t_ref = time.perf_counter() - t_ref
        present = [i for i, p in enumerate(sample["program"]) if p is not None]
        got = np.stack([sample["program"][i] for i in present]) if present else None
        nonfinite = int((~np.isfinite(got)).sum()) if present else 0
        gap = (logit_gap(got, ref[present], np.abs(ref).max())
               if present and not nonfinite else math.inf)
        checks = {"logit_gap": (gap, cell.config["limits"]["logit_gap"]),
                  "nonfinite": (nonfinite, 0),
                  "sample_missing": (len(ref) - len(present), 0), **run["checks"]}
        correct = all(v <= lim for v, lim in checks.values())

        result = {"correct": bool(correct), "attempted": int(run["attempted"]),
                  "failed": int(run["failed"])}
        devinfo = {"platform": "gpu" if cuda else "cpu", "kind": dev_kind, "count": 1,
                   "memory_peak_bytes": memory_peak}
        t_trace = time.perf_counter()
        if args.trace:
            trace = stretch.trace() if cuda else None
            result["metrics"] = per_layer(cell, run, trace, stretch.probed, dev_kind)
            if trace is not None:
                devinfo.update(busy_s=trace.busy_s(), window_s=trace.window_s)
                result["device"] = devinfo
                result["breakdown"] = trace.breakdown()
        else:
            e2e = dict(run["e2e"], setup_s=setup_s)
            result["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                                 for m in cell.end_to_end}
        result["device"] = devinfo
        print(f"seconds: set-up {setup_s:.3f}, window {run['window_s']:.3f}, reference "
              f"{t_ref:.3f} ({len(ref)} images), trace {time.perf_counter() - t_trace:.3f}",
              file=sys.stderr)
        result["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                            for k, (v, lim) in checks.items()}
        guard("at the end")
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
