"""Pieces the plain references share: the quantization grid (int8, or the
int4 control), exact integer convolutions, and the ImageNet constants.

Every integer sum runs in float64: products of codes below 2^8 summed over
at most a few thousand terms stay integers below 2^53, so any summation
order gives the exact sum. Convolutions are patches times the kernel (a
GEMM), never a transform-based algorithm (FFT, Winograd), which would round.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Grid:
    """The integer grid a reference computes on. ``bits=8`` is the
    configuration's own (quint8 activations, int8 weights); ``bits=4`` is the
    control: every activation grid and every weight grid 17 times coarser
    (quint4 [0, 15], int4 [-8, 7]), each scale 17 times larger."""

    def __init__(self, bits: int = 8):
        if bits not in (8, 4):
            raise ValueError(f"bits must be 8 or 4, got {bits}")
        self.bits = bits
        self.qmax = float(2**bits - 1)
        self.step = 255.0 / self.qmax  # 1 at 8 bits, 17 at 4

    def act(self, scale, zp):
        """(scale, zero point) of an 8-bit activation grid -> this grid's."""
        s = np.float32(np.float32(scale) * np.float32(self.step))
        return s, float(np.round(float(zp) / self.step))

    def weight(self, w_q, w_scale):
        """int8 per-channel weights and scales -> this grid's, as float64
        integer values and float32 scales."""
        w = np.asarray(w_q, np.float64)
        s = np.asarray(w_scale, np.float32)
        if self.bits == 8:
            return w, s
        lim = 2.0 ** (self.bits - 1)
        return (np.clip(np.round(w / self.step), -lim, lim - 1),
                (s * np.float32(self.step)).astype(np.float32))


def f32(v) -> float:
    """A number rounded to float32, as a Python float."""
    return float(np.float32(v))


def inv32(scale) -> float:
    """1 / s rounded in float32."""
    return float(np.float32(1.0) / np.float32(scale))


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, pad=0, value: float = 0.0,
              groups: int = 1) -> torch.Tensor:
    """float64 NHWC x, HWIO w (the depthwise kind (kh, kw, 1, C) with
    ``groups`` = C) -> the exact float64 NHWC convolution, as patches times
    the kernel. ``pad`` is one number or (top, bottom, left, right), filled
    with ``value``."""
    if isinstance(pad, int):
        pad = (pad, pad, pad, pad)
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    t, b, l, r = pad
    xc = x.permute(0, 3, 1, 2)
    if any(pad):
        xc = F.pad(xc, (l, r, t, b), value=value)
    ho, wo = (h + t + b - kh) // stride + 1, (wd + l + r - kw) // stride + 1
    cols = F.unfold(xc, (kh, kw), stride=stride)  # (N, C*kh*kw, L), C slowest
    if groups == 1:
        wk = w.permute(2, 0, 1, 3).reshape(c * kh * kw, o)  # rows in (C, kh, kw) order
        y = cols.transpose(1, 2) @ wk
    elif groups == c == o:
        wk = w.reshape(kh * kw, c).t()  # (C, kh*kw)
        y = (cols.reshape(n, c, kh * kw, -1) * wk[None, :, :, None]).sum(dim=2).transpose(1, 2)
    else:
        raise NotImplementedError("dense or depthwise convolutions only")
    return y.reshape(n, ho, wo, o)


def requant_div(y: torch.Tensor, scale, zp, grid: Grid) -> torch.Tensor:
    """clip(round(y / s) + zp, 0, qmax) by true division (a 0-d float32 divisor)."""
    s = torch.full((), f32(scale), dtype=torch.float32, device=y.device)
    return torch.clamp(torch.round(y / s) + float(zp), 0.0, grid.qmax)


def requant_mul(y: torch.Tensor, inv: float, zp, grid: Grid) -> torch.Tensor:
    """clip(round(y * inv) + zp, 0, qmax), ``inv`` a float32 reciprocal."""
    return torch.clamp(torch.round(y * inv) + float(zp), 0.0, grid.qmax)


def read_spec(config_dir: str) -> dict:
    with open(os.path.join(config_dir, "spec.json")) as f:
        return json.load(f)


def to_dev(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)
