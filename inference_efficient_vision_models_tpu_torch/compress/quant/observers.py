"""Quantization primitives of the static-int8 contract.

Weights are per-channel symmetric int8 (scale = max(-min, max) / 127.5,
zero point 0); activations are quint8 affine (scale = (max - min) / 255,
zp = -round(min / scale) clamped to [0, 255]) stored shifted by -128 as int8
(``q_s = q - 128``) so the convs run int8 x int8 -> int32. Rounding is half
to even throughout, as in torch and JAX.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

EPS = 1.1920928955078125e-07  # torch.finfo(float32).eps


def minmax_qparams_affine(min_val: float, max_val: float) -> Tuple[float, int]:
    """quint8 affine qparams from a range (torch MinMax semantics)."""
    min_val = min(float(min_val), 0.0)
    max_val = max(float(max_val), 0.0)
    scale = max((max_val - min_val) / 255.0, EPS)
    zp = 0 - round(min_val / scale)
    return scale, int(np.clip(zp, 0, 255))


def quantize_weight_per_channel(w: torch.Tensor, channel_axis: int):
    """-> (w_q int8, scale f32[channels]), symmetric per channel."""
    w = w.float()
    moved = w.movedim(channel_axis, 0).reshape(w.shape[channel_axis], -1)
    min_val = torch.clamp_max(moved.min(dim=1).values, 0.0)
    max_val = torch.clamp_min(moved.max(dim=1).values, 0.0)
    scale = torch.clamp_min(torch.maximum(-min_val, max_val) / 127.5, EPS)
    shape = [1] * w.dim()
    shape[channel_axis] = -1
    q = torch.round(w / scale.reshape(shape))
    return torch.clamp(q, -128, 127).to(torch.int8), scale


def quantize_affine_shifted(x: torch.Tensor, scale, zp: int) -> torch.Tensor:
    """float -> shifted-int8 storage of quint8 affine values."""
    # a 0-d tensor divisor: CUDA divides by a Python scalar as x * (1/s)
    s = torch.full((), float(np.float32(scale)), dtype=torch.float32, device=x.device)
    q = torch.round(x.float() / s) + float(zp)
    return (torch.clamp(q, 0, 255) - 128).to(torch.int8)


def dequantize_affine_shifted(q_s: torch.Tensor, scale, zp: int) -> torch.Tensor:
    return (q_s.float() - float(int(zp) - 128)) * float(np.float32(scale))
