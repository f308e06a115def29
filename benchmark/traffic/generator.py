"""The one generator of the benchmark's traffic. A mix is a data file beside
this one (``<mix>.json``); its ``"kind"`` names the module that drives the
system with it, ``benchmark/drivers/<kind>.py``:

* ``"offline"``: a pool of stored frames sent as one batch job after another;
* ``"open_loop"``: requests of a few frames each, arriving on a schedule
  made in advance, whatever the system's state.

Everything is made from the seed, so one seed gives the same inputs and the
same schedule. Frames are greyscale, as an inspection camera's (the
configurations' source data, NEU-DET, is 200x200 grey steel surfaces): a
level per frame plus noise, replicated to three channels.

An open-loop schedule draws neither its request sizes nor its gaps freely:
every seed gets the same multiset of sizes (each size of the range equally
often) and the same multiset of gaps (the exponential distribution's
quantiles at the midpoints of N equal steps, scaled so that the last
request is due just before the window closes), in its own order. So the
seed moves the order of the work, never its amount, and two seeds load the
system alike.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVERS = os.path.join(os.path.dirname(HERE), "drivers")


def load_mix(name: str) -> Dict:
    """The parameters of the mix ``name`` (``traffic/<name>.json``)."""
    with open(os.path.join(HERE, f"{name}.json")) as f:
        mix = json.load(f)
    kind = mix.get("kind")
    if not isinstance(kind, str) or not os.path.exists(os.path.join(DRIVERS, f"{kind}.py")):
        raise ValueError(f"traffic mix {name!r}: no driver benchmark/drivers/{kind}.py")
    return mix


def frames(n: int, hw, seed: int) -> np.ndarray:
    """(n, H, W, 3) uint8 grey frames from the seed, made on the host in a
    few large draws."""
    rng = np.random.default_rng([seed, 0])
    h, w = hw
    level = rng.integers(40, 216, (n, 1, 1), dtype=np.int16)
    noise = rng.integers(-40, 41, (n, h, w), dtype=np.int16)
    grey = np.clip(level + noise, 0, 255).astype(np.uint8)
    return np.repeat(grey[..., None], 3, axis=3)


@dataclass
class Schedule:
    """Request i is due ``due_s[i]`` seconds after the window opens and
    carries the frames ``pool[offset[i] : offset[i] + size[i]]``."""

    due_s: np.ndarray
    size: np.ndarray
    offset: np.ndarray

    @property
    def images(self) -> int:
        return int(self.size.sum())


def open_loop(mix: Dict, seed: int, images_per_s: float, seconds: float, pool: int) -> Schedule:
    """The arrivals of an open-loop window of ``seconds`` at a mean of
    ``images_per_s`` (the mix's ``"sizes"`` range gives the frames per
    request), over a pool of ``pool`` frames."""
    lo, hi = mix["sizes"]
    sizes = np.arange(lo, hi + 1)
    per_request = float(sizes.mean())
    n = int(round(images_per_s * seconds / per_request / len(sizes))) * len(sizes)
    if n < len(sizes):
        raise ValueError("the window holds too few requests at this rate")
    rng = np.random.default_rng([seed, 1])
    size = rng.permutation(np.tile(sizes, n // len(sizes)))
    u = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-u))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    due *= seconds * (n - 1) / n / due[-1]
    offset = rng.integers(0, pool - hi + 1, n)
    return Schedule(due, size.astype(np.int64), offset.astype(np.int64))
