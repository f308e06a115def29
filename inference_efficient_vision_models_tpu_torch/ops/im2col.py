"""int8 convolution as patch extraction + the int8 matmul kernel.

Patch extraction is plain PyTorch data movement (strided slices of the
padded input, concatenated along channels), as the JAX package leaves it to
XLA outside its kernel; the matmul and its epilogue run in
``int8_matmul_requant``. Carries the convs the direct 3x3 kernel does not
take: the s2d stem, stride-2 3x3 convs and 1x1 convs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .int8_matmul import WeightLike, _packed, int8_matmul_requant, int8_matmul_requant_plain


def extract_patches_nhwc(x: torch.Tensor, kh: int, kw: int, stride: int, padding: int,
                         pad_value):
    """(N, H, W, C) -> (N, Ho, Wo, kh*kw*C), symmetric padding with ``pad_value``."""
    n, h, w, c = x.shape
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding), value=pad_value)
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    cols = [
        x[:, dy : dy + (ho - 1) * stride + 1 : stride, dx : dx + (wo - 1) * stride + 1 : stride, :]
        for dy in range(kh)
        for dx in range(kw)
    ]
    patches = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return patches, ho, wo


def conv_int8_im2col(
    x_s: torch.Tensor,        # (N, H, W, C) int8 shifted activations
    w: WeightLike,            # (kh, kw, C, O) int8, or pack_weight() of it
    w_scale: torch.Tensor,    # (O,)
    bias: torch.Tensor,       # (O,)
    w_sum: torch.Tensor,      # (O,) sum over (kh, kw, C)
    *,
    stride: int,
    padding: int,
    in_scale,
    in_zp,
    relu: bool = False,
    out_scale: Optional[float] = None,
    out_zp: Optional[int] = None,
    backend: str = "kernel",
) -> torch.Tensor:
    """Quantized conv via patches + int8 matmul -> (N, Ho, Wo, O) int8 or fp32.

    Padding uses the shifted zero point, so the affine correction stays the
    per-channel constant ``zp_s * sum(w)``. ``backend="kernel"`` runs
    ``int8_matmul_requant`` (the CUDA kernel on a CUDA tensor);
    ``backend="plain"`` its plain PyTorch version on any device."""
    w = _packed(w)
    kh, kw, c, o = w.shape
    n = x_s.shape[0]
    patches, ho, wo = extract_patches_nhwc(x_s, kh, kw, stride, padding, int(in_zp) - 128)
    pm = patches.reshape(n * ho * wo, kh * kw * c)
    if backend == "kernel":
        mm = int8_matmul_requant
    elif backend == "plain":
        mm = int8_matmul_requant_plain
    else:
        raise ValueError(f"unknown backend {backend!r}")
    out = mm(pm, w, w_scale, bias, w_sum, in_scale=in_scale, in_zp=in_zp, relu=relu,
             out_scale=out_scale, out_zp=out_zp)
    return out.reshape(n, ho, wo, o)
