"""Dense layer + exact-erf GELU in one kernel: ``gelu(x @ w + b)``.

Replaces the Pallas TPU kernel
``inference_efficient_vision_models_tpu/ops/fused_dense.py:dense_gelu`` with
the hand-written CUDA kernel ``csrc/fused_dense.cu`` (its header says what
bounds it on an H100 and what the design does about it). Same contract: the
product accumulates in fp32, the bias is added in fp32, GELU uses the A&S
7.1.26 erf polynomial (``int8_matmul.gelu_as``) in fp32, and the result is
cast once to ``x.dtype``. ``dense_gelu`` launches the kernel for a CUDA
tensor and runs ``dense_gelu_plain`` for a CPU tensor only.
"""

from __future__ import annotations

import torch

from . import _lib
from .int8_matmul import gelu_as

_KINDS = {torch.float32: 1, torch.bfloat16: 2}


def dense_gelu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the product in
    float64 (exact for bf16 inputs, so only the kernel's fp32 summation
    order separates the two), rounded to fp32, then the fp32 epilogue."""
    k, n = w.shape
    y = (x.reshape(-1, k).double() @ w.double()).float() + b.float()
    return gelu_as(y).to(x.dtype).reshape(*x.shape[:-1], n)


def dense_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``gelu(x @ w + b)`` for (..., K) fp32 or bf16 ``x``, (K, N) ``w`` and
    (N,) ``b`` of the same dtype -> (..., N) in ``x.dtype``."""
    if x.device.type == "cpu":
        return dense_gelu_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"dense_gelu runs on cpu or cuda, not {x.device}")
    if x.dtype not in _KINDS or w.dtype != x.dtype or b.dtype != x.dtype:
        raise ValueError(f"x, w and b must all be float32 or all bfloat16, got "
                         f"{x.dtype}, {w.dtype}, {b.dtype}")
    if w.dim() != 2 or b.shape != (w.shape[1],) or x.shape[-1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} do not fit")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("x, w and b must be contiguous")
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"w and b must lie on {x.device}")
    k, n = w.shape
    m = x.numel() // k
    if m >= 2**31:
        raise ValueError(f"M = {m} rows exceed the kernel's int32 indexing")
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    rc = _lib.kernel_fn("dense_gelu")(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), _KINDS[x.dtype], m, k, n,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _lib.check("dense_gelu", rc)
    return out
