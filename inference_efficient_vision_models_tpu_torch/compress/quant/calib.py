"""Calibration observers: minmax-EMA, percentile, entropy (KL), the port of
the JAX package's ``compress/quant/calib.py``.

* ``minmax``: the reference's ``MovingAverageMinMaxObserver`` (the parity
  default): each batch's per-tap min and max, an EMA over batches;
* ``percentile``: clip each tail at the (100−pct)% mass quantile;
* ``entropy``: the KL(P‖Q)-minimizing asymmetric clip window over a
  quantile candidate grid, Q simulating 256-level quantization, compared
  over the full support (so clipping is never free).

All three run off one sweep over the model's activation taps
(``apply_folded(..., with_taps=True)``, the taps the conversion consumes).
Per-tap min and max are reduced on the device and fetched once per batch.
For the histogram observers a second sweep takes a strided subsample of
each tap (at most 2²⁰ values, in the NHWC order the JAX package flattens)
and histograms it in numpy on the host, as the JAX package does. The
batches are taken in order, padded rows included, until ``max_images``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ...data.pipeline import normalize_images
from ...utils.device import exact_fp32
from .observers import ObserverState, batch_min_max

__all__ = ["calibrate_taps", "percentile_range", "entropy_range"]


def percentile_range(hist: np.ndarray, lo: float, hi: float,
                     pct: float = 99.99) -> Tuple[float, float]:
    """Two-sided percentile clip: keep the [(100−pct)%, pct%] mass window."""
    hist = np.asarray(hist, np.float64)
    total = hist.sum()
    if total <= 0:
        return lo, hi
    edges = np.linspace(lo, hi, len(hist) + 1)
    c = np.cumsum(hist) / total
    f = max((100.0 - pct) / 100.0, 0.0)
    lo_idx = int(np.searchsorted(c, f, side="left"))
    hi_idx = int(np.searchsorted(c, 1.0 - f, side="left"))
    hi_idx = min(hi_idx + 1, len(hist))
    if hi_idx <= lo_idx:
        return lo, hi
    return float(edges[lo_idx]), float(edges[hi_idx])


def _kl(p: np.ndarray, q: np.ndarray) -> float:
    p = p / p.sum()
    q = q / max(q.sum(), 1e-12)
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] / np.maximum(q[mask], 1e-12))))


_Q_FLOOR = 1e-12  # q mass assigned to bins outside the clip window


def _quantize_expand(p: np.ndarray, nlevels: int) -> np.ndarray:
    """Simulate nlevels-bucket quantization of a distribution: block-sum,
    then spread each bucket's mass uniformly over its NONZERO source bins
    (TensorRT's expansion rule: empty bins stay empty)."""
    n = len(p)
    q = np.zeros_like(p)
    bounds = np.linspace(0, n, nlevels + 1).astype(int)
    for i in range(nlevels):
        s, e = bounds[i], bounds[i + 1]
        if e <= s:
            continue
        block = p[s:e]
        nz = block > 0
        cnt = int(nz.sum())
        if cnt:
            q[s:e][nz] = block.sum() / cnt
    return q


def entropy_range(hist: np.ndarray, lo: float, hi: float, *, nlevels: int = 256,
                  tail_fracs=(0.0, 1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2)) -> Tuple[float, float]:
    """KL-minimizing asymmetric clip window over a quantile candidate grid."""
    hist = np.asarray(hist, np.float64)
    total = hist.sum()
    nbins = len(hist)
    if total <= 0:
        return lo, hi
    edges = np.linspace(lo, hi, nbins + 1)
    c = np.cumsum(hist) / total

    lo_cands = sorted({int(np.searchsorted(c, f, side="left")) for f in tail_fracs})
    hi_cands = sorted(
        {min(int(np.searchsorted(c, 1.0 - f, side="left")) + 1, nbins) for f in tail_fracs})
    p_full = hist / total
    best = (lo, hi)
    best_kl = np.inf
    seen = set()
    for li in lo_cands:
        for hj in hi_cands:
            # a window narrower than the level count quantizes losslessly:
            # widen it to nlevels bins instead of discarding the candidate
            if hj - li < nlevels:
                hj = min(li + nlevels, nbins)
                if hj - li < nlevels:
                    li = max(hj - nlevels, 0)
            if (li, hj) in seen:
                continue
            seen.add((li, hj))
            inner = hist[li:hj].astype(np.float64).copy()
            if inner.sum() <= 0:
                continue
            # clipped values saturate to the window-edge quantization levels
            inner[0] += hist[:li].sum()
            inner[-1] += hist[hj:].sum()
            q_full = np.full(nbins, _Q_FLOOR)
            q_full[li:hj] = np.maximum(_quantize_expand(inner, nlevels), _Q_FLOOR)
            kl = _kl(p_full, q_full)
            if kl < best_kl:
                best_kl = kl
                best = (float(edges[li]), float(edges[hj]))
    return best


def _taps(apply_folded, spec, folded, imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The taps of one fp32 forward, TF32 off and cuDNN off: on an H100 the
    fp32 algorithms cuDNN picks put the taps' ranges 1.45e-6 (relative) from
    an fp64 forward's over the r2 calibration set, PyTorch's own GEMM convs
    3.2e-7, XLA on the CPU 5.2e-7 (``chip_smoke.py`` ``convert_r2``)."""
    with torch.no_grad(), exact_fp32(), torch.backends.cudnn.flags(enabled=False,
                                                                  allow_tf32=False):
        return apply_folded(spec, folded, normalize_images(imgs), with_taps=True)[1]


def _tap_minmax(apply_folded, spec, folded, imgs) -> Dict[str, Tuple[float, float]]:
    """Every tap's (min, max) of one batch, in one device-to-host copy."""
    taps = _taps(apply_folded, spec, folded, imgs)
    mm = torch.stack([torch.stack(batch_min_max(t)) for t in taps.values()]).cpu().numpy()
    return {name: (lo, hi) for name, (lo, hi) in zip(taps, mm)}


def calibrate_taps(apply_folded, spec, folded, batches, *, max_images: int = 256,
                   observer: str = "minmax", averaging_constant: float = 0.01,
                   percentile: float = 99.99, bins: int = 2048) -> Dict[str, ObserverState]:
    """Tap name -> ObserverState whose (min, max) is the chosen clip range.
    ``folded`` is the device tree ``apply_folded`` takes; ``batches`` yields
    (uint8 NHWC images, labels, mask) on its device."""
    calib = []
    seen = 0
    for batch in batches:
        imgs = batch[0] if isinstance(batch, tuple) else batch
        calib.append(imgs)
        seen += int(len(imgs))
        if seen >= max_images:
            break

    if observer == "minmax":
        obs: Dict[str, ObserverState] = {}
        for imgs in calib:
            for name, (lo, hi) in _tap_minmax(apply_folded, spec, folded, imgs).items():
                obs.setdefault(name, ObserverState.fresh())
                obs[name] = obs[name].update(lo, hi, averaging_constant)
        return obs
    if observer not in ("percentile", "entropy"):
        raise ValueError(f"unknown observer '{observer}'")

    # pass 1: global per-tap ranges (the histogram support must cover everything)
    ranges: Dict[str, Tuple[float, float]] = {}
    for imgs in calib:
        for name, (lo, hi) in _tap_minmax(apply_folded, spec, folded, imgs).items():
            cur = ranges.get(name, (np.inf, -np.inf))
            ranges[name] = (min(cur[0], float(lo)), max(cur[1], float(hi)))
    ranges = {k: (lo, hi if hi > lo else lo + 1e-6) for k, (lo, hi) in ranges.items()}

    # pass 2: strided tap subsamples -> host-side histograms
    cap = 1 << 20
    hists = {name: np.zeros(bins, np.int64) for name in ranges}
    for imgs in calib:
        for name, t in _taps(apply_folded, spec, folded, imgs).items():
            flat = t.float().reshape(-1)
            stride = max(1, flat.shape[0] // cap)
            h, _ = np.histogram(flat[::stride].cpu().numpy(), bins=bins, range=ranges[name])
            hists[name] += h.astype(np.int64)

    out: Dict[str, ObserverState] = {}
    for name, h in hists.items():
        lo, hi = ranges[name]
        if observer == "percentile":
            nlo, nhi = percentile_range(h, lo, hi, percentile)
        else:
            nlo, nhi = entropy_range(h, lo, hi)
        out[name] = ObserverState(float(nlo), float(nhi), True)
    return out
