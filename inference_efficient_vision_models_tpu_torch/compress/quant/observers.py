"""Quantization primitives of the static-int8 contract.

Weights are per-channel symmetric int8 (scale = max(-min, max) / 127.5,
zero point 0); activations are quint8 affine (scale = (max - min) / 255,
zp = -round(min / scale) clamped to [0, 255]) stored shifted by -128 as int8
(``q_s = q - 128``) so the convs run int8 x int8 -> int32. Rounding is half
to even throughout, as in torch and JAX.

Calibration keeps an ``ObserverState`` per activation tap: the reference's
``MovingAverageMinMaxObserver`` (averaging constant 0.01, the first batch
taken as it is), updated on the host in Python floats from each batch's
min and max, as the JAX package updates it. Weight quantization for a
conversion runs in numpy on the host (``quantize_weight_per_channel``), the
JAX package's arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

EPS = 1.1920928955078125e-07  # torch.finfo(float32).eps


class ObserverState(NamedTuple):
    """EMA min/max of one tap; ``initialized`` marks the first batch."""

    min: float
    max: float
    initialized: bool

    @staticmethod
    def fresh() -> "ObserverState":
        return ObserverState(min=0.0, max=0.0, initialized=False)

    def update(self, batch_min: float, batch_max: float, c: float = 0.01) -> "ObserverState":
        if not self.initialized:
            return ObserverState(float(batch_min), float(batch_max), True)
        return ObserverState(self.min + c * (float(batch_min) - self.min),
                             self.max + c * (float(batch_max) - self.max), True)


def batch_min_max(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.float()
    return x.min(), x.max()


def minmax_qparams_symmetric_per_channel(w: np.ndarray, channel_axis: int) -> np.ndarray:
    """qint8 symmetric per-channel scales (zero point 0), float32 numpy."""
    w = np.asarray(w, dtype=np.float32)
    moved = np.moveaxis(w, channel_axis, 0).reshape(w.shape[channel_axis], -1)
    min_val = np.minimum(moved.min(axis=1), 0.0)
    max_val = np.maximum(moved.max(axis=1), 0.0)
    scale = np.maximum(-min_val, max_val) / 127.5
    return np.maximum(scale, EPS).astype(np.float32)


def minmax_qparams_affine(min_val: float, max_val: float) -> Tuple[float, int]:
    """quint8 affine qparams from a range (torch MinMax semantics)."""
    min_val = min(float(min_val), 0.0)
    max_val = max(float(max_val), 0.0)
    scale = max((max_val - min_val) / 255.0, EPS)
    zp = 0 - round(min_val / scale)
    return scale, int(np.clip(zp, 0, 255))


def quantize_weight_per_channel(w: np.ndarray, channel_axis: int):
    """-> (w_q int8, scale f32[channels]) numpy, symmetric per channel."""
    scale = minmax_qparams_symmetric_per_channel(w, channel_axis)
    shape = [1] * w.ndim
    shape[channel_axis] = -1
    q = np.round(np.asarray(w, np.float32) / scale.reshape(shape))
    return np.clip(q, -128, 127).astype(np.int8), scale


def quantize_affine_shifted(x: torch.Tensor, scale, zp: int) -> torch.Tensor:
    """float -> shifted-int8 storage of quint8 affine values."""
    # a 0-d tensor divisor: CUDA divides by a Python scalar as x * (1/s)
    s = torch.full((), float(np.float32(scale)), dtype=torch.float32, device=x.device)
    q = torch.round(x.float() / s) + float(zp)
    return (torch.clamp(q, 0, 255) - 128).to(torch.int8)


def dequantize_affine_shifted(q_s: torch.Tensor, scale, zp: int) -> torch.Tensor:
    return (q_s.float() - float(int(zp) - 128)) * float(np.float32(scale))
