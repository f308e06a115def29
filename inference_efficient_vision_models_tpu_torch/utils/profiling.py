"""Device tracing, the port of the JAX package's ``utils/profiling.py``, on
``torch.profiler``: wrap a region in ``trace(dir)`` and open the Chrome
trace it writes.

``annotate`` is the port's span. Every span adds its count and duration to
one table of the process, on every thread, whether or not a profiler runs;
``totals()`` reads the table, and a reader takes the difference of two
readings. While a profiler runs, the span is also a ``record_function``
range in its trace."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Tuple

import torch

_TOTALS: Dict[str, list] = {}  # name -> [count, seconds]
_LOCK = threading.Lock()


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace (host ops, and the GPU's kernels
    where there is one) into ``log_dir`` (no-op if None); yields the profiler."""
    if not log_dir:
        yield None
        return
    from torch.profiler import profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities(), on_trace_ready=tensorboard_trace_handler(log_dir)) as p:
        yield p


def totals() -> Dict[str, Tuple[int, float]]:
    """A snapshot of every span so far: name -> (count, seconds)."""
    with _LOCK:
        return {k: (c, s) for k, (c, s) in _TOTALS.items()}


@contextlib.contextmanager
def annotate(name: str):
    """The span ``name``: counted in ``totals()`` on exit, and while a
    profiler runs a ``record_function`` range. With no profiler running no
    range is opened: entering one costs ~12 µs of host time even then."""
    rng = (torch.profiler.record_function(name) if torch.autograd.profiler._is_profiler_enabled
           else contextlib.nullcontext())
    with rng:
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            seconds = (time.perf_counter_ns() - t0) / 1e9
            with _LOCK:
                t = _TOTALS.setdefault(name, [0, 0.0])
                t[0] += 1
                t[1] += seconds
