"""Offline batches (mix kind ``"offline"``): ``Predictor.predict_logits``
over the whole pool, call after call. The window ends with the first call
that returns after ``seconds``, and its rate is every image returned over all
of the window's time.

With a ``Stretch`` the profiler covers whole calls from the first call
boundary past the mix's ``trace_skip_s``, for at least ``trace_seconds``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from benchmark.harness.trace import Stretch, span


def window(pred, pool: np.ndarray, seconds: float, stretch: Optional[Stretch] = None,
           trace_skip_s: float = 0.0, trace_s: float = 0.0) -> Dict:
    outs, raised = [], 0
    traced = {"calls": 0, "state": "wait"}
    t0 = time.perf_counter()
    now = t0
    while True:
        if stretch is not None and traced["state"] == "wait" and now - t0 >= trace_skip_s:
            stretch.start()
            traced.update(state="on", first=len(outs), t=time.perf_counter())
        try:
            with span("bench.predict_logits", stretch is not None):
                outs.append(pred.predict_logits(pool))
        except Exception:  # a failed call: counted, and the window ends
            raised += 1
            break
        now = time.perf_counter()
        if traced["state"] == "on" and (now - traced["t"] >= trace_s or now - t0 >= seconds):
            stretch.stop()
            traced.update(state="done", calls=len(outs) - traced["first"])
        if now - t0 >= seconds:
            break
    if traced["state"] == "on":
        stretch.stop()
        traced.update(state="done", calls=len(outs) - traced["first"])
    return {"outputs": outs, "window_s": now - t0, "raised": raised,
            "traced_calls": traced["calls"]}


def run(cell, prog, pool: np.ndarray, seconds: float, stretch: Optional[Stretch],
        seed: int) -> Dict:
    """Set-up's last step (the batch shape warmed, one whole call), the
    window, and the sample of its answers that the run compares: images
    drawn from the seed, each answered by a call of the window drawn too."""
    mix = cell.traffic
    prog.pred.warmup(pool.shape[1:])
    prog.pred.predict_logits(pool)
    if stretch is not None:
        prog.instrument()
    t_window = time.perf_counter()
    res = window(prog.pred, pool, seconds, stretch, mix["trace_skip_s"], mix["trace_seconds"])
    classes = cell.config["classes"]
    wrong = sum(o.shape != (len(pool), classes) for o in res["outputs"])
    rng = np.random.default_rng([seed, 2])
    n_ok = len(res["outputs"])
    idx = np.sort(rng.choice(len(pool), min(mix["sample_images"], len(pool)), replace=False))
    calls = rng.integers(0, max(n_ok, 1), len(idx))
    sample = {"images": pool[idx],
              "program": [res["outputs"][c][i] if n_ok and res["outputs"][c].shape[0] > i
                          else None for c, i in zip(calls, idx)]}
    out = {
        "t_window": t_window, "window_s": res["window_s"], "sample": sample,
        "attempted": (n_ok + res["raised"]) * len(pool), "failed": res["raised"] * len(pool),
        "checks": {"wrong_shape": (wrong, 0), "raised": (res["raised"], 0)},
        "e2e": {"images_per_s": n_ok * len(pool) / res["window_s"]},
        "counters": {},
    }
    if stretch is not None:
        k = res["traced_calls"]
        batches = k * -(-len(pool) // mix["batch_size"])
        out["stretch"] = {"calls": k, "images": k * len(pool), "forwards": batches,
                          "batches": batches}
    return out
