"""Profiling: params, serialized size, FLOPs, latency, throughput (the port
of the JAX package's ``metrics/profile.py``).

* latency and throughput synchronize the CUDA stream around each timed call
  (or round), so they time the device work, not its enqueue;
* FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``: the
  convolutions and matrix products only, 2 per multiply-add. XLA's cost
  analysis, which the JAX package reads, also counts elementwise work
  (BatchNorm, ReLU, adds, pools), so the port's count is the smaller;
* the serialized size is the length of the bytes the port's msgpack writer
  gives for ``{"params", "state"}``: the bytes ``flax.serialization.to_bytes``
  writes for the same trees.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from ..core.artifacts import tree_bytes


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(np.prod(params.shape))


def model_size_bytes(params, state=None) -> int:
    """Serialized checkpoint size (msgpack, dtype-faithful) of JAX-layout trees."""
    bundle = {"params": params}
    if state is not None:
        bundle["state"] = state
    return len(tree_bytes(bundle))


def flops_of(fn: Callable, *args) -> float:
    """FLOPs of one call: convolutions and matrix products (see above)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def _sync(args) -> None:
    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        torch.cuda.synchronize()


def _budgeted(fn, args, warmup: int, iters: int, budget_s: float):
    """Scale (warmup, iters) down so the measurement fits a wall budget (a
    slow path, such as the plain CPU versions in the tests, shrinks the loop
    instead of stalling); the first call is not part of the probe."""
    fn(*args)
    _sync(args)
    t0 = time.perf_counter()
    fn(*args)
    _sync(args)
    probe = time.perf_counter() - t0
    total = probe * (warmup + iters)
    if total > budget_s:
        scale = budget_s / total
        warmup = max(0, int(warmup * scale))
        iters = max(3, int(iters * scale))
    return warmup, iters


def latency_ms(fn: Callable, *args, warmup: int = 10, iters: int = 50,
               budget_s: float = 15.0) -> Dict[str, float]:
    """Per-call latency stats (ms), each call synchronized: dispatch plus
    execution, the serving-relevant number."""
    warmup, iters = _budgeted(fn, args, warmup, iters, budget_s)
    for _ in range(warmup):
        fn(*args)
    _sync(args)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(args)
        times.append((time.perf_counter() - t0) * 1e3)
    times = np.asarray(times)
    return {"p50": float(np.percentile(times, 50)), "p90": float(np.percentile(times, 90)),
            "mean": float(times.mean()), "min": float(times.min())}


def throughput_ips(fn: Callable, *args, batch_size: int, warmup: int = 5, iters: int = 30,
                   budget_s: float = 15.0) -> float:
    """Steady-state images/s: calls enqueued back to back, one sync per
    round, the median over 5 rounds."""
    warmup, iters = _budgeted(fn, args, warmup, iters, budget_s)
    rounds, iters_r = 5, max(3, iters // 5)
    for _ in range(warmup):
        fn(*args)
    _sync(args)
    ts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters_r):
            fn(*args)
        _sync(args)
        ts.append(time.perf_counter() - t0)
    return batch_size * iters_r / float(np.median(ts))
