"""Channel-importance criteria: the port's copy of the JAX package's
``compress/prune/importance.py``.

The reference's menu (magnitude p=1 / p=2, random, group Taylor) plus two
activation-based criteria:

* ``bn_act``: expected post-ReLU response of a BN'd channel, modelled as
  N(bias, scale²): ``|scale|·(φ(z) + z·Φ(z))`` with ``z = bias/|scale|``;
* ``apoz``: P(activation > 0) = Φ(z) (Average Percentage of Zeros).

For a group with several producer convs, per-layer vectors are
mean-normalized and averaged, so layers of different magnitudes count
equally. Everything runs in numpy on the JAX-layout arrays, in float64 from
the float32 leaves as the JAX package does: a torch reduction sums in
another order and can swap two near-equal channels in the ranking.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from .graph import get_path

METHODS = ("l1", "l2", "random", "taylor", "group_norm", "bn_act", "apoz")

_erf = np.vectorize(math.erf)  # channel vectors are tiny; exactness > speed


def _gauss_relu_stats(scale: np.ndarray, bias: np.ndarray):
    """(E[ReLU(y)], P(y>0)) for y ~ N(bias, scale²) per channel."""
    s = np.abs(np.asarray(scale, dtype=np.float64)) + 1e-12
    mu = np.asarray(bias, dtype=np.float64)
    z = mu / s
    phi = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)  # standard normal pdf
    Phi = 0.5 * (1.0 + _erf(z / math.sqrt(2.0)))  # standard normal cdf
    return s * (phi + z * Phi), Phi


def _norm(w: np.ndarray, axis_keep: int, p: int) -> np.ndarray:
    """p-norm over all axes except ``axis_keep``."""
    w = np.moveaxis(np.asarray(w, dtype=np.float64), axis_keep, 0).reshape(w.shape[axis_keep], -1)
    if p == 1:
        return np.abs(w).sum(axis=1)
    return np.sqrt((w * w).sum(axis=1))


def channel_importance(group: Dict, params, method: str, *,
                       rng: Optional[np.random.Generator] = None, grads=None) -> np.ndarray:
    """Importance score per channel of ``group`` (higher = keep)."""
    if method not in METHODS:
        raise ValueError(f"unknown pruning_method {method!r} (have {METHODS})")
    width = group["width"]

    if method == "random":
        assert rng is not None, "random importance needs an rng"
        return rng.random(width)

    if method == "taylor":
        # |w · ∂L/∂w| summed over the group's producer weights
        assert grads is not None, "taylor importance needs a grads tree"
        score = np.zeros(width)
        for path, axis in group["producers"]:
            w = np.asarray(get_path(params, path))
            g = np.asarray(get_path(grads, path))
            contrib = np.abs(w * g)
            contrib = np.moveaxis(contrib, axis, 0).reshape(width, -1).sum(axis=1)
            score += contrib
        return score / max(len(group["producers"]), 1)

    if method in ("bn_act", "apoz"):
        per_layer = []
        for bn_path in group["bns"]:
            bn = get_path(params, bn_path)
            e_relu, p_nonzero = _gauss_relu_stats(bn["scale"], bn["bias"])
            v = e_relu if method == "bn_act" else p_nonzero
            per_layer.append(v / (v.mean() + 1e-12))
        if not per_layer:  # a BN-less group: weight L2
            for path, axis in group["producers"]:
                v = _norm(np.asarray(get_path(params, path)), axis, 2)
                per_layer.append(v / (v.mean() + 1e-12))
        return np.mean(per_layer, axis=0)

    p = 1 if method == "l1" else 2
    per_layer = []
    for path, axis in group["producers"]:
        w = np.asarray(get_path(params, path))
        v = _norm(w, axis, p)
        if method != "group_norm":
            v = v / (v.mean() + 1e-12)  # scale-normalize per layer
        per_layer.append(v)
    return np.mean(per_layer, axis=0)
