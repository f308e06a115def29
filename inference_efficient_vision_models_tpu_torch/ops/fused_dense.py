"""Dense layer + exact-erf GELU in one kernel: ``gelu(x @ w + b)``.

Replaces the Pallas TPU kernel
``inference_efficient_vision_models_tpu/ops/fused_dense.py:dense_gelu`` with
the hand-written CUDA kernel ``csrc/fused_dense.cu`` (its header says what
bounds it on an H100 and what the design does about it). Same contract: the
product accumulates in fp32, the bias is added in fp32, GELU uses the A&S
7.1.26 erf polynomial (``int8_matmul.gelu_as``) in fp32, and the result is
cast once to ``x.dtype``. ``dense_gelu`` launches the kernel for a CUDA
tensor and runs ``dense_gelu_plain`` for a CPU tensor only; ``dense_plan``
picks its route and grid.
"""

from __future__ import annotations

import dataclasses

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


NUM_SMS = 132            # H100 SXM
SMEM_LIMIT = 232_448     # shared memory one block may take (227 KB)
WGMMA_MAX_K = 192        # csrc/fused_dense.cu W_MAX_K: the W slice stays resident
WGMMA_BN = 128           # output columns per block of the Hopper route
WGMMA_TM = 64            # rows per consumer tile
WGMMA_CONSUMERS = 3      # consumer warpgroups per block (csrc/fused_dense.cu W_CONSUMERS)
WGMMA_STAGES = 1         # A tiles in flight per consumer warpgroup (W_STAGES)
WGMMA_BUFS = 1           # staged output tiles per consumer warpgroup (W_BUFS)


def wgmma_smem_bytes(k: int) -> int:
    """Dynamic shared memory of the Hopper route (csrc/fused_dense.cu
    ``WLayout``): the resident W slice (two 64-column halves of K rounded up
    to 16 rows of 128 bytes), per consumer warpgroup a ring of A tiles (64
    rows x 128 bytes per 64-value K chunk) and staged 64 x 128 bf16 output
    tiles (16 KB each), the bias slice, the mbarriers, 1024 bytes of
    alignment slack."""
    kb, nch = -(-k // 16) * 16, -(-k // 64)
    cw = WGMMA_CONSUMERS
    return (2 * kb * 128 + cw * WGMMA_STAGES * nch * 64 * 128 + cw * WGMMA_BUFS * 16384
            + 128 * 4 + (1 + 2 * cw * WGMMA_STAGES) * 8 + 1024)


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """``route`` 1: the Hopper kernel on a (``grid_m``, ``grid_n``) grid, one
    block per SM, each block's consumer warpgroups taking turns at the 64-row
    tiles of its M group against its resident 128-column W slice; 0: the general
    mma.sync (bf16) or CUDA-core (fp32) kernel, 128 x 128 tiles."""

    route: int
    grid_m: int
    grid_n: int
    smem: int


def dense_plan(m: int, k: int, n: int, dtype: torch.dtype, aligned: bool) -> DensePlan:
    """The Hopper route for bf16 with 16-byte rows (K, N multiples of 8,
    16-byte aligned pointers) and K <= 192; the general route otherwise."""
    if (dtype != torch.bfloat16 or not aligned or k % 8 or n % 8 or k > WGMMA_MAX_K
            or wgmma_smem_bytes(k) > SMEM_LIMIT):
        return DensePlan(0, -(-m // 128), -(-n // 128), 0)
    grid_n = -(-n // WGMMA_BN)
    rounds = -(-(-(-m // WGMMA_TM)) // WGMMA_CONSUMERS)  # one tile per warpgroup a round
    return DensePlan(1, max(1, min(rounds, NUM_SMS // grid_n)), grid_n, wgmma_smem_bytes(k))


def dense_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``gelu(x @ w + b)`` for (..., K) fp32 or bf16 ``x``, (K, N) ``w`` and
    (N,) ``b`` of the same dtype -> (..., N) in ``x.dtype``: the op
    ``ievm::dense_gelu``."""
    return _lib.call("dense_gelu", x, w, b)


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Validate and launch kernel D on CUDA tensors."""
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
    aligned = (x.data_ptr() | w.data_ptr() | out.data_ptr()) % 16 == 0
    p = dense_plan(m, k, n, x.dtype, aligned)
    rc = _lib.kernel_fn("dense_gelu")(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), _KINDS[x.dtype], m, k, n,
        p.route, p.grid_m, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _lib.check("dense_gelu", rc)
    return out


_lib.custom_op("dense_gelu", "(Tensor x, Tensor w, Tensor b) -> Tensor",
               cpu=dense_gelu_plain, cuda=_launch,
               fake=lambda x, w, b: x.new_empty((*x.shape[:-1], w.shape[1])))
