"""The int8 depthwise conv with its requantizing epilogue (kernel E).

No Pallas kernel stands behind it: the JAX package computes
``inference_efficient_vision_models_tpu/ops/dwconv_int8.py:depthwise_conv_int8``
with XLA (k*k shifted int32 multiply-adds, or the grouped conv on a TPU)
and then the epilogue of ``compress/quant/qeffnet.py:_conv_q``. PyTorch has
no int8 convolution on CUDA, so on the GPU this runs the hand-written kernel
of ``csrc/dwconv_int8.cu`` (its header says what bounds it and how it is
laid out). On shifted-quint8 int8 NHWC:

    acc = sum_taps (x - zp_s) * w          (int32, the halo at zp_s adds nothing)
    y   = silu(acc * (s_in * s_w) + b)     (fp32)
    out = clip(round(y / s_out) + zp_out, 0, 255) - 128

``depthwise_conv_int8`` launches the kernel for a CUDA tensor and runs
``depthwise_conv_int8_plain`` for a CPU tensor only. The plain version is
the JAX lowering step by step: pad with zp_s, the k*k shifted int32
multiply-adds (``depthwise_acc_int32``), ``acc - zp_s * sum(w)``, the fp32
epilogue, the requant by true division (a 0-d tensor divisor: CUDA divides
by a Python scalar as a multiply by its reciprocal).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _lib
from .fused_mbconv import act_plain

__all__ = ["depthwise_acc_int32", "depthwise_conv_int8", "depthwise_conv_int8_plain",
           "vector_width"]


def _f32(v) -> float:
    return float(np.float32(v))


def depthwise_acc_int32(x_s8: torch.Tensor, w_q: torch.Tensor, stride: int) -> torch.Tensor:
    """The JAX package's shift lowering: (N, Hp, Wp, C) int8, already padded,
    and a (k, k, 1, C) int8 kernel -> (N, Ho, Wo, C) int32, Ho = (Hp - k) //
    stride + 1."""
    n, hp, wp, c = x_s8.shape
    k = w_q.shape[0]
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    w32 = w_q.to(torch.int32)
    acc = None
    for dy in range(k):
        for dx in range(k):
            sl = x_s8[:, dy : dy + (ho - 1) * stride + 1 : stride,
                      dx : dx + (wo - 1) * stride + 1 : stride, :].to(torch.int32)
            term = sl * w32[dy, dx, 0]
            acc = term if acc is None else acc + term
    return acc


def _requant_div(y: torch.Tensor, scale, zp) -> torch.Tensor:
    s = torch.full((), _f32(scale), dtype=torch.float32, device=y.device)
    q = torch.round(y / s) + float(zp)
    return (torch.clamp(q, 0.0, 255.0) - 128.0).to(torch.int8)


def depthwise_conv_int8_plain(x_s8: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                              bias: torch.Tensor, *, stride: int, in_scale, in_zp, out_scale,
                              out_zp) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: (N, H, W, C) int8
    and a (k, k, 1, C) int8 kernel -> (N, Ho, Wo, C) int8, padding (k - 1) // 2."""
    k = w_q.shape[0]
    pad = (k - 1) // 2
    zp_s = int(in_zp) - 128
    xp = F.pad(x_s8, (0, 0, pad, pad, pad, pad), value=zp_s)
    acc = depthwise_acc_int32(xp, w_q, stride) - zp_s * w_q.to(torch.int32).sum(dim=(0, 1, 2))
    y = act_plain(acc.float() * (w_scale * _f32(in_scale)) + bias, "silu")
    return _requant_div(y, out_scale, out_zp)


def vector_width(c: int, *tensors: torch.Tensor) -> int:
    """The widest load along C the kernel may take: 16, 8 or 4 bytes where C
    is a multiple and every tensor's address is aligned to it, else 1."""
    for v in (16, 8, 4):
        if c % v == 0 and all(t.data_ptr() % v == 0 for t in tensors):
            return v
    return 1


def depthwise_conv_int8(x_s8: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                        bias: torch.Tensor, *, stride: int, in_scale, in_zp, out_scale,
                        out_zp) -> torch.Tensor:
    """int8 depthwise conv + epilogue -> (N, Ho, Wo, C) int8 in the output's
    shifted quint8 domain; ``w_q`` is the (k, k, 1, C) int8 kernel (k 3 or 5,
    stride 1 or 2, padding (k - 1) // 2)."""
    if x_s8.device.type == "cpu":
        return depthwise_conv_int8_plain(x_s8, w_q, w_scale, bias, stride=stride,
                                         in_scale=in_scale, in_zp=in_zp, out_scale=out_scale,
                                         out_zp=out_zp)
    if x_s8.device.type != "cuda":
        raise ValueError(f"depthwise_conv_int8 runs on cpu or cuda, not {x_s8.device}")
    dev = x_s8.device
    if x_s8.dim() != 4 or x_s8.dtype != torch.int8 or not x_s8.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, H, W, C) int8 tensor, got "
                         f"{tuple(x_s8.shape)} {x_s8.dtype}")
    n, h, w, c = x_s8.shape
    k = w_q.shape[0]
    if (w_q.shape != (k, k, 1, c) or k not in (3, 5) or w_q.dtype != torch.int8
            or w_q.device != dev or not w_q.is_contiguous()):
        raise ValueError(f"w must be a contiguous (k, k, 1, {c}) int8 tensor on {dev} with k 3 "
                         f"or 5, got {tuple(w_q.shape)} {w_q.dtype} on {w_q.device}")
    if stride not in (1, 2):
        raise ValueError(f"the kernel takes stride 1 or 2, got {stride}")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if (t.shape != (c,) or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({c},) float32 tensor on {dev}")
    if not (float(out_zp).is_integer() and 0 <= out_zp <= 255 and 0 <= int(in_zp) <= 255):
        raise ValueError(f"zero points must be integers in [0, 255], got {in_zp}, {out_zp}")
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    out = torch.empty((n, ho, wo, c), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    if n * max(h * w, ho * wo) * c >= 2**31:
        raise ValueError("the tensors exceed the kernel's int32 pixel indexing")
    vec = vector_width(c, x_s8, w_q, out)
    rc = _lib.kernel_fn("dwconv_int8")(
        x_s8.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n, h, w, c, ho, wo, k, stride, pad, vec, int(in_zp) - 128, _f32(in_scale),
        1.0 / _f32(out_scale), float(out_zp), torch.cuda.current_stream(dev).cuda_stream,
    )
    _lib.check("dwconv_int8", rc)
    return out
