"""Open-loop serving (mix kind ``"open_loop"``): requests of a few frames
each, on a schedule made from the seed in advance (``traffic/generator.py``),
sent to a ``serving.MicroBatcher`` in front of the cell's ``Predictor``.

One generator thread submits each request at its due time, late or not;
latency runs from the due time to the moment the request's logits are set,
so a stall delays every request due during it. After the last due time the
harness waits for the answers up to the mix's drain limit. The offered rate
is the mix's ``load`` times the configuration's
``online_capacity_images_per_s``.

With a ``Stretch`` the profiler covers a fixed span of the schedule: from
the mix's ``trace_skip_s`` for ``trace_seconds``.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Dict, Optional

import numpy as np

from benchmark.harness.stats import percentile
from benchmark.harness.trace import Stretch
from benchmark.traffic import generator


def setup(cell, prog, pool: np.ndarray):
    """The cell's ``MicroBatcher`` over the program's ``Predictor``, every
    bucket warmed; the program closes it, and a traced run spans its
    dispatches."""
    from inference_efficient_vision_models_tpu_torch import serving

    batcher = serving.MicroBatcher(prog.pred, max_wait_ms=cell.traffic["max_wait_ms"])
    prog.own(batcher, "_dispatch")
    batcher.warmup(pool.shape[1:])
    return batcher


def window(batcher, pool: np.ndarray, sched, seconds: float, drain_limit_s: float,
           stretch: Optional[Stretch] = None, trace_skip_s: float = 0.0,
           trace_s: float = 0.0, keep: Optional[np.ndarray] = None) -> Dict:
    """``keep``: the requests whose logits the run compares afterwards
    (drawn before the window). Only those are kept; of the others the
    harness keeps times and flags in arrays, so that it holds no object per
    request for the interpreter's collector to walk during the window."""
    n = len(sched.due_s)
    due = sched.due_s
    keep = np.zeros(n, bool) if keep is None else keep
    submit_t = np.full(n, np.nan)
    done_t = np.full(n, np.nan)
    raised = np.zeros(n, bool)
    rows = np.zeros(n, np.int64)
    kept: Dict[int, np.ndarray] = {}
    lock = threading.Lock()
    left = [n]
    all_done = threading.Event()

    def finish(i):
        with lock:
            left[0] -= 1
            if left[0] == 0:
                all_done.set()

    def record(i, fut):
        done_t[i] = time.perf_counter()
        if fut.exception() is not None:
            raised[i] = True
        else:
            r = fut.result()
            rows[i] = r.shape[0] if r.ndim == 2 else -1
            if keep[i]:
                kept[i] = r
        finish(i)

    t0 = time.perf_counter() + 0.01

    def generate():
        for i in range(n):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            o, k = sched.offset[i], sched.size[i]
            try:
                fut = batcher.submit(pool[o : o + k])
            except Exception:  # refused: a failed request
                submit_t[i] = time.perf_counter()
                raised[i] = True
                finish(i)
                continue
            submit_t[i] = time.perf_counter()
            fut.add_done_callback(functools.partial(record, i))

    gen = threading.Thread(target=generate, name="bench-generator", daemon=True)
    gen.start()
    if stretch is not None:
        time.sleep(max(0.0, t0 + trace_skip_s - time.perf_counter()))
        stretch.start()
        time.sleep(max(0.0, min(trace_s, t0 + seconds - time.perf_counter())))
        stretch.stop()
    gen.join()
    all_done.wait(timeout=max(0.0, t0 + seconds + drain_limit_s - time.perf_counter()))
    with lock:
        answered = ~np.isnan(done_t)
        ok = answered & ~raised
        latency = np.where(ok, done_t - (t0 + due), np.inf)
        return {"latency_s": latency, "gen_lag_s": submit_t - (t0 + due),
                "raised": int(raised.sum()), "unanswered": int((~answered & ~raised).sum()),
                "wrong_rows": int((ok & (rows != sched.size)).sum()), "kept": dict(kept),
                "window_s": seconds, "ok": ok}


def run(cell, prog, pool: np.ndarray, seconds: float, stretch: Optional[Stretch],
        seed: int) -> Dict:
    """Set-up's last step (the batcher), the window, and the sample of its
    answers that the run compares: requests drawn from the seed before the
    window opens."""
    mix = cell.traffic
    rate = mix["load"] * cell.config["online_capacity_images_per_s"]
    sched = generator.open_loop(mix, seed, rate, seconds, len(pool))
    n = len(sched.due_s)
    picks = np.random.default_rng([seed, 2]).choice(n, min(mix["sample_requests"], n),
                                                    replace=False)
    keep = np.zeros(n, bool)
    keep[picks] = True
    batcher = setup(cell, prog, pool)
    if stretch is not None:
        prog.instrument()
    t_window = time.perf_counter()
    res = window(batcher, pool, sched, seconds, mix["drain_limit_s"], stretch,
                 mix["trace_skip_s"], mix["trace_seconds"], keep=keep)
    classes = cell.config["classes"]
    imgs, progs, wrong = [], [], res["wrong_rows"]
    for i in np.sort(picks):
        o, k = sched.offset[i], sched.size[i]
        imgs.append(pool[o : o + k])
        r = res["kept"].get(int(i))
        if r is not None and r.shape != (k, classes):
            wrong += 1
            r = None
        progs.extend(r[j] if r is not None else None for j in range(k))
    lat_ms = res["latency_s"] * 1e3
    out = {
        "t_window": t_window, "window_s": seconds,
        "sample": {"images": np.concatenate(imgs), "program": progs},
        "attempted": n, "failed": res["raised"] + res["unanswered"],
        "checks": {"unanswered": (res["unanswered"], 0), "raised": (res["raised"], 0),
                   "wrong_shape": (wrong, 0)},
        "e2e": {"latency_p50_ms": percentile(lat_ms, 50)},
        "counters": {"latency_s": res["latency_s"], "gen_lag_s": res["gen_lag_s"],
                     "batcher": batcher.stats(),
                     "offered_images_per_s": rate},
    }
    if stretch is not None:
        out["stretch"] = {}
    return out
