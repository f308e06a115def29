"""Weight-only INT8 (W8A16): int8 per-channel weight storage, bf16 compute;
the port of the JAX package's ``compress/quant/wo8.py``.

Every ``"w"`` kernel of the folded model with two or more axes (HWIO convs,
the (in, out) fc: output channel last) is stored as ``{"q": int8, "s":
fp32 per output channel}``; biases stay fp32. Serving dequantizes once, on
the host, to the compute dtype: ``(q * s)`` in fp32 then cast, the JAX
package's arithmetic (which dequantizes inside its jitted forward).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .observers import quantize_weight_per_channel

__all__ = ["convert_weight_only", "dequantize", "is_weight_only"]


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q", "s"}


def convert_weight_only(folded) -> Dict[str, Any]:
    """Folded fp32 model (JAX layout, numpy) -> the same tree with int8
    ``"w"`` leaves."""

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                a = None if isinstance(v, dict) else np.asarray(v)
                if k == "w" and a is not None and a.ndim >= 2 and a.dtype == np.float32:
                    w_q, scale = quantize_weight_per_channel(a, channel_axis=a.ndim - 1)
                    out[k] = {"q": w_q, "s": scale}
                else:
                    out[k] = walk(v)
            return out
        return np.asarray(node)

    return walk(folded)


def dequantize(model, dtype=torch.bfloat16):
    """The folded tree in ``dtype`` (CPU tensors, JAX layout): each int8 leaf
    as (q * s) in fp32 then cast, every other fp32 leaf cast."""

    def d(x):
        if _is_qleaf(x):
            return (torch.from_numpy(np.asarray(x["q"], np.float32))
                    * torch.from_numpy(np.array(x["s"], np.float32))).to(dtype)
        if isinstance(x, dict):
            return {k: d(v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x))
        return t.to(dtype) if t.dtype == torch.float32 else t

    return d(model)


def is_weight_only(model) -> bool:
    """A weight-only artifact, told by its {"q", "s"} weight leaves."""
    if _is_qleaf(model):
        return True
    return isinstance(model, dict) and any(is_weight_only(v) for v in model.values())
