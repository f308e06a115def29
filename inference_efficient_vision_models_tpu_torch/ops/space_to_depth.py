"""Space-to-depth input layout for the stem conv.

Packing 2x2 pixel blocks into channels turns a (B, 224, 224, 3) image batch
into (B, 112, 112, 12) and the 7x7/s2 stem conv into an equivalent 4x4/s1
conv with asymmetric pad (2, 1), whose kernel is a zero-filled remap:

    W4[k, l, (sy, sx, c), o] = W[2k + sy - 1, 2l + sx - 1, c, o]   (index in [0, 6], else 0)
"""

from __future__ import annotations

import numpy as np
import torch


def space_to_depth_u8(imgs: np.ndarray, factor: int = 2) -> np.ndarray:
    """(B, H, W, C) uint8 -> (B, H/f, W/f, f*f*C), on the host.

    The serving layout (f=2, C=3, uint8) goes through the C++ row interleave
    of ``data/native_loader.py`` (numpy's strided transpose runs at well
    under a GB/s on one core); other layouts take ``space_to_depth_u8_plain``,
    the reference the tests hold the native path to."""
    b, h, w, c = imgs.shape
    if h % factor or w % factor:
        raise ValueError(f"image size {h}x{w} is not a multiple of {factor}")
    if factor == 2 and c == 3 and imgs.dtype == np.uint8:
        from ..data.native_loader import s2d_batch_native

        return s2d_batch_native(imgs)
    return space_to_depth_u8_plain(imgs, factor)


def space_to_depth_u8_plain(imgs: np.ndarray, factor: int = 2) -> np.ndarray:
    """``space_to_depth_u8`` by numpy's reshape and transpose."""
    b, h, w, c = imgs.shape
    if h % factor or w % factor:
        raise ValueError(f"image size {h}x{w} is not a multiple of {factor}")
    out = (
        imgs.reshape(b, h // factor, factor, w // factor, factor, c)
        .transpose(0, 1, 3, 2, 4, 5)
        .reshape(b, h // factor, w // factor, factor * factor * c)
    )
    return np.ascontiguousarray(out)


def space_to_depth_device(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """The same layout as ``space_to_depth_u8``, on a tensor's own device."""
    b, h, w, c = x.shape
    return (
        x.reshape(b, h // factor, factor, w // factor, factor, c)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(b, h // factor, w // factor, factor * factor * c)
    )


def remap_stem_weights_s2d(w: torch.Tensor) -> torch.Tensor:
    """(7, 7, C, O) stem kernel -> (4, 4, 4C, O) for the s2d(2) input layout."""
    kh, kw, c, o = w.shape
    if (kh, kw) != (7, 7):
        raise ValueError("the stem remap is specialised to the 7x7/s2 stem")
    w4 = torch.zeros((4, 4, 4 * c, o), dtype=w.dtype, device=w.device)
    for k in range(4):
        for sy in range(2):
            dy = 2 * k + sy - 1
            if not 0 <= dy <= 6:
                continue
            for l in range(4):
                for sx in range(2):
                    dx = 2 * l + sx - 1
                    if not 0 <= dx <= 6:
                        continue
                    sub = (sy * 2 + sx) * c
                    w4[k, l, sub : sub + c, :] = w[dy, dx, :, :]
    return w4
