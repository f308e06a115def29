"""Weight-only INT4 (W4A16): packed int4 weight storage with group scales,
bf16 compute; the port of the JAX package's ``compress/quant/wo4.py``.

Storage, leaf for leaf the JAX package's:

    q4   int8 array with two int4 values per byte, packed along the output
         axis (low nibble: even output channel, high nibble: odd) -> (..., out/2)
    s    fp32 scales (G, out): per output channel and per group of the
         flattened reduction axis, G = r / g for the largest divisor g <= 64
         of r = prod(leading dims), so the layout follows from the shapes alone

Weights with an odd output count, and those the ``keep_int8`` policy picks
(depthwise kernels, reductions shorter than 32: the stems), keep the W8A16
leaf ``{"q", "s"}`` inside the same artifact. Serving dequantizes once, on
the host, as ``wo8.dequantize`` does: the nibbles sign-extended by
arithmetic shifts, ``q * s`` in fp32, then the cast, the JAX package's
arithmetic (which dequantizes inside its jitted forward).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import wo8
from .observers import quantize_weight_per_channel

__all__ = ["convert_weight_only_int4", "dequantize", "is_weight_only_int4",
           "quantize_weight_int4"]

_MAX_GROUP = 64


def _pick_group(r: int) -> int:
    """Largest divisor of ``r`` that is <= _MAX_GROUP (>= 1 always exists)."""
    for g in range(min(r, _MAX_GROUP), 0, -1):
        if r % g == 0:
            return g
    return 1


def _is_q4leaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q4", "s"}


def quantize_weight_int4(w: np.ndarray) -> Dict[str, np.ndarray]:
    """(..., out) fp32 -> {"q4": (..., out/2) int8 packed, "s": (G, out) fp32}:
    symmetric int4 in [-7, 7], scales max|w| / 7 per (reduction group, output
    channel); ``out`` even (the caller checks)."""
    w = np.asarray(w, np.float32)
    out = w.shape[-1]
    r = int(np.prod(w.shape[:-1]))
    g = _pick_group(r)
    wg = w.reshape(r // g, g, out)
    s = np.maximum(np.abs(wg).max(axis=1) / 7.0, 1e-12).astype(np.float32)
    q = np.clip(np.rint(wg / s[:, None, :]), -7, 7).astype(np.int8)
    q = q.reshape(*w.shape[:-1], out)
    lo, hi = q[..., 0::2], q[..., 1::2]
    packed = ((lo & np.int8(0x0F)) | (hi << np.int8(4))).astype(np.int8)
    return {"q4": packed, "s": s}


def _unpack_scale(x, dtype) -> torch.Tensor:
    """The inverse of ``quantize_weight_int4`` as a CPU tensor in ``dtype``:
    the low nibble sign-extended by (p << 4) >> 4, the high one by p >> 4
    (arithmetic shifts on int8), ``q * s`` in fp32, then the cast."""
    p = np.ascontiguousarray(x["q4"], np.int8)
    # the left shift on the unsigned view: it wraps without signed overflow
    lo = np.right_shift(np.left_shift(p.view(np.uint8), np.uint8(4)).view(np.int8), np.int8(4))
    hi = np.right_shift(p, np.int8(4))
    q = np.stack([lo, hi], axis=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)
    s = np.array(x["s"], np.float32)
    out = q.shape[-1]
    r = int(np.prod(q.shape[:-1]))
    wf = torch.from_numpy(q.reshape(s.shape[0], r // s.shape[0], out).astype(np.float32))
    wf = wf * torch.from_numpy(s)[:, None, :]
    return wf.reshape(q.shape).to(dtype)


def _keep_int8_auto(path, a) -> bool:
    """The default int8-fallback policy, the JAX package's: depthwise kernels
    (HWIO with I == 1) and reductions shorter than 32 (the stems) keep int8:
    few of the bytes, most of int4's accuracy loss."""
    return (a.ndim == 4 and a.shape[2] == 1) or int(np.prod(a.shape[:-1])) < 32


def convert_weight_only_int4(folded, *, keep_int8=_keep_int8_auto) -> Dict[str, Any]:
    """Folded fp32 model (JAX layout, numpy) -> the same tree with packed-int4
    ``"w"`` leaves ({"q4", "s"}); odd-output weights and leaves that
    ``keep_int8(key path, array)`` selects keep the W8A16 per-channel int8
    leaf ({"q", "s"}). ``keep_int8=lambda p, a: False``: int4 everywhere."""

    def walk(node, path=()):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                a = None if isinstance(v, dict) else np.asarray(v)
                if k == "w" and a is not None and a.ndim >= 2 and a.dtype == np.float32:
                    if a.shape[-1] % 2 != 0 or (keep_int8 is not None
                                                and keep_int8(path + (k,), a)):
                        w_q, scale = quantize_weight_per_channel(a, channel_axis=a.ndim - 1)
                        out[k] = {"q": w_q, "s": scale}
                    else:
                        out[k] = quantize_weight_int4(a)
                else:
                    out[k] = walk(v, path + (k,))
            return out
        return np.asarray(node)

    return walk(folded)


def dequantize(model, dtype=torch.bfloat16):
    """The folded tree in ``dtype`` (CPU tensors, JAX layout): int4 and int8
    weight leaves dequantized in fp32 then cast, every other fp32 leaf cast."""

    def d(x):
        if _is_q4leaf(x):
            return _unpack_scale(x, dtype)
        if isinstance(x, dict) and not wo8._is_qleaf(x):
            return {k: d(v) for k, v in x.items()}
        return wo8.dequantize(x, dtype)  # an int8 fallback leaf, or any other leaf

    return d(model)


def is_weight_only_int4(model) -> bool:
    """A W4A16 artifact, told by its {"q4", "s"} weight leaves."""
    if _is_q4leaf(model):
        return True
    return isinstance(model, dict) and not wo8._is_qleaf(model) and any(
        is_weight_only_int4(v) for v in model.values())
