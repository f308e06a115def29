"""Per-kernel device time from ``torch.profiler``, the port of the JAX
package's ``metrics/device_profile.py``.

``profile_device_ops`` runs a callable under the profiler and returns the
device rows (CUDA kernels, copies and sets) by self time; on a machine
without a GPU there are none and it returns ``[]``. ``device_rows`` reads
the same table from a profiler the caller ran (``chip_smoke.profile_window``).

Usage:
    rows = profile_device_ops(lambda: model(x), iters=10)
    for r in rows[:10]:
        print(r["avg_self_us"], r["category"], r["name"])
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


def _category(name: str) -> str:
    for kind in ("Memcpy", "Memset"):
        if name.startswith(kind):
            return kind.lower()
    return "kernel"


def device_rows(prof, iters: int = 1) -> List[Dict]:
    """The device events of a finished ``torch.profiler.profile``, one row
    per name: {"name", "category", "occurrences", "total_self_us",
    "avg_self_us" (per iteration), "self_percent"}, by self time."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = [{"name": e.key, "category": _category(e.key), "occurrences": e.count,
             "total_self_us": float(e.self_device_time_total),
             "avg_self_us": float(e.self_device_time_total) / max(iters, 1)} for e in events]
    total = sum(r["total_self_us"] for r in rows) or 1.0
    for r in rows:
        r["self_percent"] = 100.0 * r["total_self_us"] / total
    rows.sort(key=lambda r: -r["total_self_us"])
    return rows


def _profiled(run: Callable[[], None], iters: int, shapes: bool = False):
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts, record_shapes=shapes) as prof:
        for _ in range(iters):
            run()
        if cuda:
            torch.cuda.synchronize()
    return prof


def profile_device_ops(run: Callable[[], None], *, iters: int = 10) -> List[Dict]:
    """Run ``run()`` ``iters`` times under the profiler; the device rows
    (``device_rows``), or ``[]`` when no device work was recorded."""
    return device_rows(_profiled(run, iters), iters)


def profile_hlo_ops(run: Callable[[], None], *, iters: int = 10) -> List[Dict]:
    """The finer table: host ops (``aten::*``, ``ievm::*``) grouped by input
    shapes, with the device time of the kernels each launched. Each row has
    the op's name, its category, its input shapes (``expression``, cut to 200
    characters) and self time; ``[]`` without device time."""
    prof = _profiled(run, iters, shapes=True)
    rows = [{"name": e.key, "category": "op", "expression": str(e.input_shapes)[:200],
             "total_self_us": float(e.self_device_time_total),
             "avg_self_us": float(e.self_device_time_total) / max(iters, 1)}
            for e in prof.key_averages(group_by_input_shape=True)
            if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["total_self_us"])
    return rows
