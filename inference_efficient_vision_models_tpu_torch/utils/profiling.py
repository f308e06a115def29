"""Device tracing, the port of the JAX package's ``utils/profiling.py``, on
``torch.profiler``: wrap a region in ``trace(dir)`` and open the Chrome
trace it writes; ``annotate`` names a region in it."""

from __future__ import annotations

import contextlib
import os

import torch


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


def annotate(name: str):
    """Named region that shows up in traces (``record_function``)."""
    return torch.profiler.record_function(name)
