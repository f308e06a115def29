"""int8 x int8 -> int32 matmul with the fused affine-int8 epilogue.

Replaces the Pallas TPU kernel
``inference_efficient_vision_models_tpu/ops/int8_matmul.py:int8_matmul_requant``
with the hand-written CUDA kernel ``csrc/int8_matmul.cu`` (its header says
what bounds it on an H100 and what the design does about it). Same contract:

    acc   = X_s . W_q                 (int32)
    acc  -= zp_s * sum_k W_q[k, n]
    y     = acc * (s_x * s_w[n]) + b[n]
    y     = act(y)                    (none | relu | erf-GELU | tanh-GELU)
    out   = clip(round(y * (1/s_y)) + zp_y, 0, 255) - 128   or y as a float

A float ``x`` (fp32/bf16) is quantized per element first, as
``round(x / s_x) + zp``. ``int8_matmul_requant`` launches the kernel for a
CUDA tensor and runs ``int8_matmul_requant_plain`` for a CPU tensor only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..compress.quant.observers import quantize_affine_shifted
from . import _lib

_ACTS = {None: 0, "relu": 1, "gelu": 2, "gelu_tanh": 3}
_X_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_OUT_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class PackedInt8Weight:
    """An int8 weight in the kernels' layout: ``wt`` is (Np, Kp), K contiguous
    for each output column, zero-padded to the tile sizes. ``shape`` is the
    JAX-layout shape it came from, (K, N) or HWIO (kh, kw, C, O)."""

    wt: torch.Tensor
    shape: Tuple[int, ...]

    @property
    def k(self) -> int:
        return int(np.prod(self.shape[:-1]))

    @property
    def n(self) -> int:
        return self.shape[-1]

    def kn(self) -> torch.Tensor:
        """The weight as a (K, N) view of ``wt``."""
        return self.wt[: self.n, : self.k].t()

    def unpack(self) -> torch.Tensor:
        """The weight in its JAX layout."""
        return self.kn().reshape(self.shape)


def pack_weight(w_q: torch.Tensor) -> PackedInt8Weight:
    """(K, N) or (kh, kw, C, O) int8 -> PackedInt8Weight, once at load time."""
    if w_q.dtype != torch.int8:
        raise TypeError(f"weights must be int8, got {w_q.dtype}")
    w2 = w_q.reshape(-1, w_q.shape[-1])
    k, n = w2.shape
    wt = torch.zeros(_round_up(n, _lib.TILE_N), _round_up(k, _lib.TILE_K),
                     dtype=torch.int8, device=w_q.device)
    wt[:n, :k] = w2.t()
    return PackedInt8Weight(wt, tuple(w_q.shape))


WeightLike = Union[PackedInt8Weight, torch.Tensor]


def _packed(w: WeightLike) -> PackedInt8Weight:
    return w if isinstance(w, PackedInt8Weight) else pack_weight(w)


def _inv(out_scale) -> float:
    # 1/s_y in fp32, as the Pallas kernel takes it
    return float(np.float32(1.0) / np.float32(out_scale))


def _f32(v) -> float:
    return float(np.float32(v))


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 erf, the Pallas kernel's ``_erf``."""
    s = torch.sign(x)
    a = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )
    return s * (1.0 - poly * torch.exp(-a * a))


def epilogue_plain(acc: torch.Tensor, *, zp_s: int, w_sum, in_scale, w_scale, bias,
                   act=None, out_scale=None, out_zp=None, out_dtype=torch.float32):
    """The shared epilogue on an exact float64 accumulator ``acc`` (..., N)."""
    acc = acc - zp_s * w_sum.double()
    y = acc.float() * (w_scale * _f32(in_scale)) + bias
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "gelu":
        y = y * 0.5 * (1.0 + erf_as(y * 2.0**-0.5))
    elif act == "gelu_tanh":
        y = y * (0.5 * (1.0 + torch.tanh(0.7978845608028654 * (y + 0.044715 * (y * y * y)))))
    elif act is not None:
        raise ValueError(f"unknown act {act!r}")
    if out_scale is None:
        return y.to(out_dtype)
    q = torch.round(y * _inv(out_scale)) + float(out_zp)
    return (torch.clamp(q, 0.0, 255.0) - 128.0).to(torch.int8)


def int8_matmul_requant_plain(
    x_s: torch.Tensor, w: WeightLike, w_scale: torch.Tensor, bias: torch.Tensor,
    w_sum: torch.Tensor, *, in_scale, in_zp, relu: bool = False, act: Optional[str] = None,
    out_scale=None, out_zp=None, out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    The int32 accumulator reaches |acc| ~ 128*128*K (6.7e7 at K = 4104),
    above 2^24, so a float32 matmul would round it; float64 holds every
    partial sum of int8 products exactly (< 2^53), whatever the order."""
    if relu:
        act = "relu"
    w = _packed(w)
    if x_s.is_floating_point():
        x_s = quantize_affine_shifted(x_s, in_scale, in_zp)
    acc = x_s.double() @ w.kn().double()
    return epilogue_plain(acc, zp_s=int(in_zp) - 128, w_sum=w_sum, in_scale=in_scale,
                          w_scale=w_scale, bias=bias, act=act, out_scale=out_scale,
                          out_zp=out_zp, out_dtype=out_dtype)


def _check_vec(name: str, t: torch.Tensor, n: int, dtype, device) -> None:
    if t.shape != (n,) or t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) {dtype} tensor on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def int8_matmul_requant(
    x_s: torch.Tensor,        # (M, K) int8 shifted activations, or fp32/bf16
    w: WeightLike,            # (K, N) int8, or pack_weight() of it
    w_scale: torch.Tensor,    # (N,) f32
    bias: torch.Tensor,       # (N,) f32
    w_sum: torch.Tensor,      # (N,) i32, sum over K of w
    *,
    in_scale,
    in_zp,                    # unshifted quint8 zero point [0, 255]
    relu: bool = False,
    act: Optional[str] = None,  # None | 'relu' | 'gelu' | 'gelu_tanh'
    out_scale=None,           # None -> float output of out_dtype
    out_zp=None,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Fused quantized dense layer -> (M, N) int8 (requantized) or float."""
    if x_s.device.type == "cpu":
        return int8_matmul_requant_plain(
            x_s, w, w_scale, bias, w_sum, in_scale=in_scale, in_zp=in_zp, relu=relu,
            act=act, out_scale=out_scale, out_zp=out_zp, out_dtype=out_dtype)
    if x_s.device.type != "cuda":
        raise ValueError(f"int8_matmul_requant runs on cpu or cuda, not {x_s.device}")
    if relu:
        act = "relu"
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}")
    w = _packed(w)
    dev = x_s.device
    if x_s.dim() != 2 or x_s.dtype not in _X_KINDS or not x_s.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D int8/fp32/bf16 tensor, got "
                         f"{tuple(x_s.shape)} {x_s.dtype}")
    m, k = x_s.shape
    if m >= 2**31:
        raise ValueError(f"M = {m} rows exceed the kernel's int32 indexing")
    if k != w.k or w.wt.device != dev:
        raise ValueError(f"x (M, {k}) on {dev} does not fit weights {w.shape} on {w.wt.device}")
    n = w.n
    _check_vec("w_scale", w_scale, n, torch.float32, dev)
    _check_vec("bias", bias, n, torch.float32, dev)
    _check_vec("w_sum", w_sum, n, torch.int32, dev)
    requant = out_scale is not None
    out_t = torch.int8 if requant else out_dtype
    if out_t not in _OUT_KINDS:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    out = torch.empty((m, n), dtype=out_t, device=dev)
    if m == 0:
        return out
    rc = _lib.kernel_fn("int8_matmul_requant")(
        x_s.data_ptr(), _X_KINDS[x_s.dtype], w.wt.data_ptr(), w.wt.shape[1],
        w_scale.data_ptr(), bias.data_ptr(), w_sum.data_ptr(), out.data_ptr(),
        _OUT_KINDS[out_t], _ACTS[act], m, k, n, int(in_zp) - 128,
        int(out_zp) if requant else 0, _f32(in_scale), _inv(out_scale) if requant else 1.0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _lib.check("int8_matmul_requant", rc)
    return out
