"""What a profiled stretch of the window holds, read from ``torch.profiler``.

``Trace`` keeps the device intervals (kernels, copies and sets, by name) and
the host ops of every thread, all in microseconds on one clock, and reduces
them: device time by name or by kernel group, the union of the device
intervals (the card's busy time: copies on another stream overlap kernels,
so a sum of self times would count them twice), the idle gaps between them
labelled by the host op that ran across each, and the breakdown the result
line carries.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

KERNELS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "kernels")


def kernel_groups() -> Dict[str, List[str]]:
    """group name -> the substrings that name its hand-written kernels
    (``benchmark/kernels/<group>.json``)."""
    out = {}
    for f in sorted(os.listdir(KERNELS_DIR)):
        if f.endswith(".json"):
            with open(os.path.join(KERNELS_DIR, f)) as fh:
                out[f[:-5]] = list(json.load(fh)["kernels"])
    return out


def device_kind(name: str) -> str:
    for kind in ("Memcpy", "Memset"):
        if name.startswith(kind):
            return kind.lower()
    return "kernel"


def union_us(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


class Trace:
    """Device events ``(name, start_us, end_us)`` and host events ``(name,
    start_us, end_us, thread)`` of a stretch [t0_us, t1_us]."""

    def __init__(self, device: Sequence[Tuple[str, float, float]],
                 host: Sequence[Tuple[str, float, float, int]], t0_us: float, t1_us: float):
        self.device = [(n, max(a, t0_us), min(b, t1_us)) for n, a, b in device
                       if b > t0_us and a < t1_us]
        self.host = list(host)
        self.t0_us, self.t1_us = t0_us, t1_us

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) / 1e6

    def busy_s(self) -> float:
        return sum(b - a for a, b in union_us((a, b) for _, a, b in self.device)) / 1e6

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, a, b in self.device:
            out[n] += (b - a) / 1e6
        return dict(out)

    def seconds(self, kind: Optional[str] = None, match: Optional[Sequence[str]] = None,
                exclude: Optional[Sequence[str]] = None, prefix: Optional[str] = None) -> float:
        """Device seconds of the events of one ``kind`` ("kernel", "memcpy",
        "memset"), whose name starts with ``prefix``, contains one of
        ``match``, and contains none of ``exclude``."""
        total = 0.0
        for n, a, b in self.device:
            if kind is not None and device_kind(n) != kind:
                continue
            if prefix is not None and not n.startswith(prefix):
                continue
            if match is not None and not any(m in n for m in match):
                continue
            if exclude is not None and any(m in n for m in exclude):
                continue
            total += (b - a) / 1e6
        return total

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Each stretch of the window with nothing on the device, labelled by
        the host op across it: the shortest op that covers at least half of
        the gap, else the one that overlaps it most ("no host op" where none
        does) -> [(label, seconds)], one entry per gap."""
        busy = union_us((a, b) for _, a, b in self.device)
        edges = [self.t0_us] + [x for ab in busy for x in ab] + [self.t1_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        longest = max((e[2] - e[1] for e in host), default=0.0)
        out = []
        for a, b in gaps:
            lo = bisect.bisect_left(starts, a - longest)
            hi = bisect.bisect_right(starts, b)
            best, best_key = "no host op", None
            for name, s, e, _ in host[lo:hi]:
                ov = min(b, e) - max(a, s)
                if ov <= 0:
                    continue
                key = (0, e - s) if ov >= 0.5 * (b - a) else (1, -ov)
                if best_key is None or key < best_key:
                    best, best_key = name, key
            out.append((best, (b - a) / 1e6))
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device ops that took most time and the idle time by host op,
        each at most ``top`` entries of [name, seconds]."""
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])[:top]
        by_label: Dict[str, float] = defaultdict(float)
        for label, s in self.idle_gaps():
            by_label[label] += s
        gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}


def _events(prof) -> Tuple[list, list]:
    """(device, host) events of a finished profiler, in microseconds."""
    device, host = [], []
    for e in prof.events():
        a, b = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:  # a host span's shadow on the device timeline
                device.append((e.name, a, b))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((e.name, a, b, int(e.thread)))
    return device, host


class Stretch:
    """Profiles a stretch of the window: ``start()`` and ``stop()`` from the
    thread that drives it, each after the device has drained, then
    ``trace()``. ``probes`` (name -> a function of no arguments) read the
    program's counters as the stretch starts and as it stops: ``probed``
    holds name -> (start, stop)."""

    def __init__(self, cuda: bool, probes: Optional[Dict[str, Callable[[], object]]] = None):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.cuda = cuda
        # the profiler's first start initialises its tracer for seconds: done
        # here, in set-up, so that the stretch starts at once
        with profile(activities=acts):
            torch.ones(1, device="cuda" if cuda else "cpu").add_(1)
        self.prof = profile(activities=acts)
        self.wall_s = 0.0
        self.probes = dict(probes or {})
        self.probed: Dict[str, Tuple[object, object]] = {}

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self._before = {k: f() for k, f in self.probes.items()}
        self.prof.start()
        with torch.profiler.record_function("bench.stretch"):
            pass
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        with torch.profiler.record_function("bench.stretch"):
            pass
        self.prof.stop()
        self.probed = {k: (self._before[k], f()) for k, f in self.probes.items()}

    def trace(self) -> Trace:
        device, host = _events(self.prof)
        marks = sorted(a for n, a, _, _ in host if n == "bench.stretch")
        if len(marks) >= 2:
            t0, t1 = marks[0], marks[-1]
        else:  # the markers were not recorded: the span of all events
            ts = [a for _, a, _ in device] + [a for _, a, _, _ in host]
            te = [b for _, _, b in device] + [b for _, _, b, _ in host]
            t0, t1 = (min(ts), max(te)) if ts else (0.0, self.wall_s * 1e6)
        host = [h for h in host if h[0] != "bench.stretch"]
        return Trace(device, host, t0, t1)


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host span named ``name`` in the trace, where tracing is on."""
    if on:
        with torch.profiler.record_function(name):
            yield
    else:
        yield
