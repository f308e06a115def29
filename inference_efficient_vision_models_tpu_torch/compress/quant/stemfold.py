"""Fold ImageNet normalization into a quantized stem conv (generic).

The port of the JAX package's ``compress/quant/stemfold.py`` (the u8 stem of
the MBConv families and the ViT patch embed). The normalize step
x_f = u*k_c + d_c (u raw uint8, k_c = 1/(255 sigma_c), d_c = -mu_c/sigma_c)
is affine, so for a stem conv W

    conv_pad0(x_f, W) = conv_upad0(u, W*k) + conv_pad0(d_img, W)
    conv_upad0(u, W*k) = s_w * conv_pad-128(u - 128, Wq) + 128 * s_w * sum(Wq)

i.e. the device consumes raw uint8 pixels through an int8 conv whose input
quantization is exact, plus an offset E: for a padded stem a map that the
checkpoint leaves out and ``restore_offsets`` rebuilds at load, for a VALID
stem (a ViT patch embed) a per-channel vector stored as it is.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ...ops.fused_mbconv import act_plain
from ...ops.im2col import conv_int8_im2col, patch_matrix
from ...ops.int8_matmul import int8_matmul_requant, int8_matmul_requant_plain
from .observers import minmax_qparams_affine, quantize_weight_per_channel

DERIVED_KEYS = ("e",)


def _d(cin: int) -> np.ndarray:
    return -(np.asarray(IMAGENET_MEAN[:cin], np.float32) / np.asarray(IMAGENET_STD[:cin], np.float32))


def make_u8_stem(w, b, obs_out, *, stride: int, padding: int, image_size) -> Dict:
    """Folded fp32 stem (w HWIO, b) + its output observer -> the u8-consuming
    int8 stem, in numpy on the host as the JAX package makes it: W * k
    quantized per channel, the output qparams from the observer. A VALID
    stem (``padding=0``) stores its offset as a per-channel vector ``e``; a
    padded one stores the exact folded kernel ``w_fp``, from which
    ``restore_offsets`` derives the map ``e`` (never serialized)."""
    w = np.asarray(w, np.float32)
    b = np.asarray(b, np.float32)
    cin = w.shape[2]
    k = 1.0 / (255.0 * np.asarray(IMAGENET_STD[:cin], np.float32))
    w_q, w_scale = quantize_weight_per_channel(w * k.reshape(1, 1, cin, 1), channel_axis=3)
    scale, zp = minmax_qparams_affine(obs_out.min, obs_out.max)
    stem = {
        "w_q": w_q,
        "w_scale": w_scale,
        "bias": b,
        "input_hw": np.asarray(image_size, np.int32),
        "stride": np.int32(stride),
        "pad": np.int32(padding),
        "out_scale": np.float32(scale),
        "out_zp": np.int32(zp),
    }
    if padding == 0:
        e = _d(cin) @ w.sum(axis=(0, 1)) + 128.0 * w_scale * w_q.sum(axis=(0, 1, 2))
        return {**stem, "e": e.astype(np.float32)}
    return restore_offsets({**stem, "w_fp": w})


def restore_offsets(stem: Dict) -> Dict:
    """(Re)compute the derived offset map E (1, Ho, Wo, C) on the CPU in fp32:
    E = conv_zero-pad(d_img, w_fp) + 128 * s_w * sum(w_q)."""
    w_fp = torch.from_numpy(np.array(stem["w_fp"], np.float32))  # (kh, kw, C, O) HWIO
    cin = w_fp.shape[2]
    d = _d(cin)
    h, wid = (int(v) for v in np.asarray(stem["input_hw"]))
    stride, pad = int(stem["stride"]), int(stem["pad"])
    w_q = np.asarray(stem["w_q"], np.float32)
    w_scale = np.asarray(stem["w_scale"], np.float32)
    d_img = torch.from_numpy(d).reshape(1, cin, 1, 1).expand(1, cin, h, wid)
    conv_d = F.conv2d(d_img, w_fp.permute(3, 2, 0, 1), stride=stride, padding=pad)
    e = conv_d.permute(0, 2, 3, 1).numpy() + 128.0 * w_scale * w_q.sum(axis=(0, 1, 2))
    return {**stem, "e": np.ascontiguousarray(e, np.float32)}


def apply_u8_stem(stem: Dict, x_u8: torch.Tensor, *, stride: int, pad: int, act: str,
                  impl: str = "kernel") -> torch.Tensor:
    """Raw uint8 NHWC -> fp32 stem output act(acc * s_w + b + E), before
    requantization; ``act`` is "silu", "relu6" or "none".

    ``stem`` holds the packed weight ``w`` with ``w_scale``, ``bias``, a zero
    ``w_sum`` and the offset ``e`` on the input's device: a (1, Ho, Wo, C)
    map for a padded stem, a (C,) vector for a VALID one (a ViT patch embed).
    The conv runs the int8 matmul kernel with ``in_zp = 128`` (the shifted
    zero point is 0, so no correction) over u - 128, padded with -128, the
    shifted value of a zero pixel, as the JAX stem pads. A VALID conv whose
    stride equals its kernel reads its patch matrix by a reshape; any other
    stem goes through im2col."""
    if x_u8.dtype != torch.uint8:
        raise ValueError(f"expected raw uint8 images, got {x_u8.dtype}")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    x_s = (x_u8.to(torch.int16) - 128).to(torch.int8)
    kh, _, _, o = stem["w"].shape
    if pad == 0 and stride == kh:
        n, h, w = x_s.shape[:3]
        mm = int8_matmul_requant if impl == "kernel" else int8_matmul_requant_plain
        y = mm(patch_matrix(x_s, kh), stem["w"], stem["w_scale"], stem["bias"], stem["w_sum"],
               in_scale=1.0, in_zp=128).reshape(n, h // kh, w // kh, o)
    else:
        if pad:
            x_s = F.pad(x_s, (0, 0, pad, pad, pad, pad), value=-128)
        y = conv_int8_im2col(x_s, stem["w"], stem["w_scale"], stem["bias"], stem["w_sum"],
                             stride=stride, padding=0, in_scale=1.0, in_zp=128, backend=impl)
    return act_plain(y + stem["e"], act)
