"""Fused direct 3x3 / stride-1 / same-padded int8 convolution, NHWC.

Replaces the Pallas TPU kernel
``inference_efficient_vision_models_tpu/ops/conv3x3.py:conv3x3_s1_int8`` with
the hand-written CUDA kernel ``csrc/conv3x3.cu``: an implicit GEMM over
K = 9*C on kernel A's Hopper pipeline (``csrc/panel_gemm.cuh``) whose panel
loader gathers the taps from the activation and pads the halo with the input
zero point, so patches never exist (the source's header says what bounds it
on an H100 and what the design does about it). Same affine-int8 semantics as
``int8_matmul``: nine shifted int8 dots into int32, minus ``zp_s * sum(w)``,
times ``s_x * s_w`` plus bias, optional ReLU, then requant through ``1/s_y``
or an fp32 output.

With ``residual`` the kernel ends a ResNet basic block instead: it adds the
block's identity to the fp32 conv output, applies ReLU and requantizes with a
true division, ``clip(round(relu(y + id) / s_out) + zp_out, 0, 255) - 128``,
the executor's unfused sequence, so the block's fp32 sum never reaches memory.
The identity is ``("int8", x_in, in_scale, in_zp)`` (the block's own input,
dequantized as ``(q - zp_s) * s``) or an fp32 tensor (the downsample's output).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..compress.quant.observers import dequantize_affine_shifted, quantize_affine_shifted
from . import _lib
from .int8_matmul import (
    PackedInt8Weight,
    TilePlan,
    WeightLike,
    _check_vec,
    _f32,
    _inv,
    _packed,
    epilogue_plain,
    tile_plan,
)

# the block's own int8 input with its qparams, or the downsample's fp32 output
Residual = Union[Tuple[str, torch.Tensor, float, int], torch.Tensor]


def conv3x3_plan(nb: int, h: int, w: int, c: int, o: int, out_kind: int,
                 residual: bool = False) -> TilePlan:
    """The kernel's tiles for a (nb, h, w, c) -> (nb, h, w, o) conv:
    ``int8_matmul.tile_plan`` at (M, K, N) = (nb h w, 9 c, o), the GEMM the
    kernel runs (its panel loader replaces kernel A's, its shared-memory
    layout is the same). ``bn`` is one of the kernel's built widths 64..256,
    the one that pads O least: 64 for O = 56, 128 for 112, 256 for 224 and
    two tiles of 256 for 456 (``.s8`` wgmma takes N = 8, 16, 24 and the
    multiples of 16 from 32 to 256: 112 and 224 too, but not 56; the built
    widths pad the served O by 12.5% at most); few 128-row slices split N into groups across
    blocks (layer 4 at batch 256: 98 slices, 2 groups); a K whose panel does
    not fit beside the weight ring streams in windows. The kernel converts an
    int8 output in registers, so its blocks stage only output rows
    (``staged_y=False``), and its 64-wide tile is built for two blocks per
    SM as kernel A's is. The residual epilogue writes int8 (``out_kind`` 0)."""
    if residual and out_kind != 0:
        raise ValueError("the residual epilogue writes int8")
    return tile_plan(nb * h * w, 9 * c, o, out_kind, staged_y=False)


def _check_residual(residual, relu: bool, out_scale) -> None:
    if relu or out_scale is None:
        raise ValueError("residual ends a basic block: it needs out_scale and applies the "
                         "ReLU itself (relu=False)")
    if not ((isinstance(residual, torch.Tensor) and residual.dtype == torch.float32)
            or (isinstance(residual, tuple) and len(residual) == 4 and residual[0] == "int8")):
        raise ValueError("residual is ('int8', x_in, in_scale, in_zp) or an fp32 tensor")


def residual_plain(residual: Residual) -> torch.Tensor:
    """The identity a residual adds, as fp32."""
    if isinstance(residual, torch.Tensor):
        return residual
    _, x_in, scale, zp = residual
    return dequantize_affine_shifted(x_in, scale, zp)


def conv3x3_s1_int8_plain(
    x_s: torch.Tensor, w: WeightLike, w_scale: torch.Tensor, bias: torch.Tensor,
    w_sum: torch.Tensor, *, in_scale, in_zp, relu: bool = False, out_scale=None, out_zp=None,
    residual: Residual = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: nine shifted
    float64 matmuls, exact for int8 products (a float32 conv would round
    accumulators above 2^24), then the shared epilogue; with ``residual``,
    the fp32 output plus the identity, ReLU, and the requant by division."""
    if residual is not None:
        _check_residual(residual, relu, out_scale)
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
    rq = dict(out_scale=out_scale, out_zp=out_zp) if residual is None else {}
    y = epilogue_plain(acc, zp_s=zp_s, w_sum=w_sum, in_scale=in_scale, w_scale=w_scale,
                       bias=bias, act="relu" if relu else None, **rq).reshape(n, h, wd, w.n)
    if residual is None:
        return y
    return quantize_affine_shifted(torch.relu(y + residual_plain(residual)), out_scale, out_zp)


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
    residual: Residual = None,
) -> torch.Tensor:
    """Fused quantized 3x3 stride-1 same-pad conv -> int8 or fp32 (N, H, W, O);
    with ``residual``, the basic block's int8 output. The op
    ``ievm::conv3x3_s1_int8``, which takes the residual as one tensor: an
    int8 block input (with its scale and zero point) or an fp32 identity."""
    if residual is not None:
        _check_residual(residual, relu, out_scale)
    w = _packed(w)
    res, res_scale, res_zp = residual, 0.0, 0
    if isinstance(residual, tuple):
        _, res, res_scale, res_zp = residual
    return _lib.call("conv3x3_s1_int8", x_s, w.wt, list(w.shape), w_scale, bias, w_sum,
                     float(in_scale), int(in_zp), bool(relu),
                     None if out_scale is None else float(out_scale),
                     None if out_zp is None else int(out_zp), res, float(res_scale), int(res_zp))


def _residual(res: Optional[torch.Tensor], res_scale: float, res_zp: int) -> Residual:
    if res is None or res.dtype != torch.int8:
        return res
    return ("int8", res, res_scale, res_zp)


def _op_cpu(x, wt, w_shape, w_scale, bias, w_sum, in_scale, in_zp, relu, out_scale, out_zp, res,
            res_scale, res_zp):
    return conv3x3_s1_int8_plain(x, PackedInt8Weight(wt, tuple(w_shape)), w_scale, bias, w_sum,
                                 in_scale=in_scale, in_zp=in_zp, relu=relu, out_scale=out_scale,
                                 out_zp=out_zp, residual=_residual(res, res_scale, res_zp))


def _op_fake(x, wt, w_shape, w_scale, bias, w_sum, in_scale, in_zp, relu, out_scale, out_zp, res,
             res_scale, res_zp):
    return x.new_empty((*x.shape[:3], w_shape[-1]),
                       dtype=torch.int8 if out_scale is not None else torch.float32)


def _op_cuda(x_s, wt, w_shape, w_scale, bias, w_sum, in_scale, in_zp, relu, out_scale, out_zp,
             residual, res_scale, res_zp):
    """Validate and launch kernel B on CUDA tensors."""
    if x_s.device.type != "cuda":
        raise ValueError(f"conv3x3_s1_int8 runs on cpu or cuda, not {x_s.device}")
    w = PackedInt8Weight(wt, tuple(w_shape))
    residual = _residual(residual, res_scale, res_zp)
    if residual is not None:
        _check_residual(residual, relu, out_scale)
    dev = x_s.device
    if x_s.dim() != 4 or x_s.dtype != torch.int8 or not x_s.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, H, W, C) int8 tensor, got "
                         f"{tuple(x_s.shape)} {x_s.dtype}")
    nb, h, wd, c = x_s.shape
    if w.shape[:3] != (3, 3, c) or w.wt.device != dev:
        raise ValueError(f"x (N, H, W, {c}) on {dev} does not fit weights {w.shape} "
                         f"on {w.wt.device}")
    if nb * h * wd >= 2**31:
        raise ValueError(f"{nb * h * wd} pixels exceed the kernel's int32 indexing")
    o = w.n
    _check_vec("w_scale", w_scale, o, torch.float32, dev)
    _check_vec("bias", bias, o, torch.float32, dev)
    _check_vec("w_sum", w_sum, o, torch.int32, dev)
    requant = out_scale is not None
    res, res_kind, res_zp_s, res_scale = None, 0, 0, 0.0
    if residual is not None:
        if isinstance(residual, torch.Tensor):
            res, res_kind, want = residual, 2, torch.float32
        else:
            _, res, scale, zp = residual
            res_kind, want, res_zp_s, res_scale = 1, torch.int8, int(zp) - 128, _f32(scale)
        if (res.shape != (nb, h, wd, o) or res.dtype != want or res.device != dev
                or not res.is_contiguous()):
            raise ValueError(f"the residual must be a contiguous {(nb, h, wd, o)} {want} tensor "
                             f"on {dev}, got {tuple(res.shape)} {res.dtype} on {res.device}")
    out = torch.empty((nb, h, wd, o), dtype=torch.int8 if requant else torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    p = conv3x3_plan(nb, h, wd, c, o, 0 if requant else 1, res is not None)
    rc = _lib.kernel_fn("conv3x3_s1_int8")(
        x_s.data_ptr(), w.tensor_map(), w_scale.data_ptr(), bias.data_ptr(), w_sum.data_ptr(),
        out.data_ptr(), 0 if requant else 1, int(relu), nb, h, wd, c, o, int(in_zp) - 128,
        int(out_zp) if requant else 0, _f32(in_scale), _inv(out_scale) if requant else 1.0,
        None if res is None else res.data_ptr(), res_kind, res_zp_s, res_scale,
        1.0 / _f32(out_scale) if requant else 1.0, p.bn, p.grid_m, p.groups, p.tiles_per_group,
        p.stages, p.window, torch.cuda.current_stream(dev).cuda_stream,
    )
    _lib.check("conv3x3_s1_int8", rc)
    return out


_lib.custom_op("conv3x3_s1_int8",
               "(Tensor x, Tensor wt, int[] w_shape, Tensor w_scale, Tensor bias, Tensor w_sum, "
               "float in_scale, int in_zp, bool relu, float? out_scale, int? out_zp, "
               "Tensor? residual, float res_scale, int res_zp) -> Tensor",
               cpu=_op_cpu, cuda=_op_cuda, fake=_op_fake)
