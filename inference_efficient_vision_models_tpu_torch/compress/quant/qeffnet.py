"""Quantized EfficientNet: the pieces of the JAX package's
``compress/quant/qeffnet.py`` that the fused executor (``fusedpath``) uses.

Activations are shifted quint8 (int8 ``q - 128``) NHWC, weights per-channel
symmetric int8; SiLU is applied in fp32 after each conv's dequantized
epilogue and before its requantization; the SE gate computes in fp32 from
int8-stored weights. The unfused ``block_int8`` / ``apply_int8`` op chain and
``apply_int8_mixed`` are not ported yet: they need an int8 depthwise conv.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...ops.fused_mbconv import act_plain
from ...ops.int8_matmul import int8_matmul_requant, int8_matmul_requant_plain
from . import stemfold
from .qresnet import _requant  # true division through a 0-d tensor, as the JAX executors


def _silu(y: torch.Tensor) -> torch.Tensor:
    return act_plain(y, "silu")


def _deq_se(se: Dict) -> np.ndarray:
    """SE (in, out) int8 matrix + per-output-channel scale -> fp32."""
    return np.asarray(se["w_q"]).astype(np.float32) * np.asarray(se["w_scale"], np.float32)


def restore_derived(qmodel: Dict) -> Dict:
    """Add the stem offset map a checkpoint leaves out (``serializable``'s inverse)."""
    if "stem" in qmodel and "w_fp" in qmodel["stem"] and "e" not in qmodel["stem"]:
        return {**qmodel, "stem": stemfold.restore_offsets(qmodel["stem"])}
    return qmodel


def conv1x1_silu_requant(x_s: torch.Tensor, zp: int, in_scale: float, qc: Dict, *,
                         impl: str) -> torch.Tensor:
    """``_conv_q(..., 1, 0, act=True, requant=True)`` of a 1x1 conv (the head
    conv ``last``): the int8 matmul kernel with fp32 out, then SiLU and the
    requant as glue (the kernel's contract has no SiLU)."""
    n, h, w, c = x_s.shape
    mm = int8_matmul_requant if impl == "kernel" else int8_matmul_requant_plain
    y = mm(x_s.reshape(-1, c), qc["w"], qc["w_scale"], qc["bias"], qc["w_sum"],
           in_scale=in_scale, in_zp=zp)
    return _requant(_silu(y), qc["out_scale"], qc["out_zp"]).reshape(n, h, w, -1)
