"""Fused direct 3x3 / stride-1 / same-padded int8 convolution, NHWC.

Replaces the Pallas TPU kernel
``inference_efficient_vision_models_tpu/ops/conv3x3.py:conv3x3_s1_int8`` with
the hand-written CUDA kernel ``csrc/conv3x3.cu``: an implicit GEMM over
K = 9*C that pads the halo with the input zero point inside the kernel and
never materialises patches (the source's header says what bounds it on an
H100 and what the design does about it). Same affine-int8 semantics as
``int8_matmul``: nine shifted int8 dots into int32, minus ``zp_s * sum(w)``,
times ``s_x * s_w`` plus bias, optional ReLU, then requant through
``1/s_y`` or an fp32 output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _lib
from .int8_matmul import (
    WeightLike,
    _check_vec,
    _f32,
    _inv,
    _packed,
    epilogue_plain,
)


def conv3x3_s1_int8_plain(
    x_s: torch.Tensor, w: WeightLike, w_scale: torch.Tensor, bias: torch.Tensor,
    w_sum: torch.Tensor, *, in_scale, in_zp, relu: bool = False, out_scale=None, out_zp=None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: nine shifted
    float64 matmuls, exact for int8 products (a float32 conv would round
    accumulators above 2^24), then the shared epilogue."""
    n, h, wd, c = x_s.shape
    w = _packed(w)
    w_q = w.unpack().double()  # (3, 3, C, O)
    zp_s = int(in_zp) - 128
    xp = F.pad(x_s, (0, 0, 1, 1, 1, 1), value=zp_s)
    acc = None
    for dy in range(3):
        for dx in range(3):
            part = xp[:, dy : dy + h, dx : dx + wd, :].reshape(-1, c).double() @ w_q[dy, dx]
            acc = part if acc is None else acc + part
    y = epilogue_plain(acc, zp_s=zp_s, w_sum=w_sum, in_scale=in_scale, w_scale=w_scale,
                       bias=bias, act="relu" if relu else None, out_scale=out_scale,
                       out_zp=out_zp)
    return y.reshape(n, h, wd, w.n)


def conv3x3_s1_int8(
    x_s: torch.Tensor,        # (N, H, W, C) int8 shifted activations
    w: WeightLike,            # (3, 3, C, O) int8, or pack_weight() of it
    w_scale: torch.Tensor,    # (O,) f32
    bias: torch.Tensor,       # (O,) f32
    w_sum: torch.Tensor,      # (O,) i32
    *,
    in_scale,
    in_zp,
    relu: bool = False,
    out_scale=None,
    out_zp=None,
) -> torch.Tensor:
    """Fused quantized 3x3 stride-1 same-pad conv -> int8 or fp32 (N, H, W, O)."""
    if x_s.device.type == "cpu":
        return conv3x3_s1_int8_plain(x_s, w, w_scale, bias, w_sum, in_scale=in_scale,
                                     in_zp=in_zp, relu=relu, out_scale=out_scale, out_zp=out_zp)
    if x_s.device.type != "cuda":
        raise ValueError(f"conv3x3_s1_int8 runs on cpu or cuda, not {x_s.device}")
    w = _packed(w)
    dev = x_s.device
    if x_s.dim() != 4 or x_s.dtype != torch.int8 or not x_s.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, H, W, C) int8 tensor, got "
                         f"{tuple(x_s.shape)} {x_s.dtype}")
    nb, h, wd, c = x_s.shape
    if w.shape[:3] != (3, 3, c) or w.wt.device != dev:
        raise ValueError(f"x (N, H, W, {c}) on {dev} does not fit weights {w.shape} "
                         f"on {w.wt.device}")
    o = w.n
    _check_vec("w_scale", w_scale, o, torch.float32, dev)
    _check_vec("bias", bias, o, torch.float32, dev)
    _check_vec("w_sum", w_sum, o, torch.int32, dev)
    requant = out_scale is not None
    out = torch.empty((nb, h, wd, o), dtype=torch.int8 if requant else torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    rc = _lib.kernel_fn("conv3x3_s1_int8")(
        x_s.data_ptr(), w.wt.data_ptr(), w.wt.shape[1], w_scale.data_ptr(), bias.data_ptr(),
        w_sum.data_ptr(), out.data_ptr(), 0 if requant else 1, int(relu), nb, h, wd, c, o,
        int(in_zp) - 128, int(out_zp) if requant else 0, _f32(in_scale),
        _inv(out_scale) if requant else 1.0, torch.cuda.current_stream(dev).cuda_stream,
    )
    _lib.check("conv3x3_s1_int8", rc)
    return out
