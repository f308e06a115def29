"""The int8 depthwise conv with its requantizing epilogue (kernel E).

No Pallas kernel stands behind it: the JAX package computes
``inference_efficient_vision_models_tpu/ops/dwconv_int8.py:depthwise_conv_int8``
with XLA (k*k shifted int32 multiply-adds, or the grouped conv on a TPU)
and then the epilogue of ``compress/quant/qeffnet.py:_conv_q``. PyTorch has
no int8 convolution on CUDA, so on the GPU this runs the hand-written kernel
of ``csrc/dwconv_int8.cu`` (its header says what bounds it and how it is
laid out). On shifted-quint8 int8 NHWC:

    acc = sum_taps (x - zp_s) * w          (int32, the halo at zp_s adds nothing)
    y   = silu(acc * (s_in * s_w) + b)     (fp32)
    out = clip(round(y / s_out) + zp_out, 0, 255) - 128

``depthwise_conv_int8`` launches the kernel for a CUDA tensor and runs
``depthwise_conv_int8_plain`` for a CPU tensor only. The plain version is
the JAX lowering step by step: pad with zp_s, the k*k shifted int32
multiply-adds (``depthwise_acc_int32``), ``acc - zp_s * sum(w)``, the fp32
epilogue, the requant by true division (a 0-d tensor divisor: CUDA divides
by a Python scalar as a multiply by its reciprocal).

``dw_plan`` chooses the kernel's tiles (bands of output rows at full width,
tiles per block, a group of channels, outputs per thread along x, the copy
width) and the wrapper passes them to the kernel, which refuses a plan it
does not take.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _lib
from .fused_mbconv import act_plain

__all__ = ["DwPlan", "depthwise_acc_int32", "depthwise_conv_int8", "depthwise_conv_int8_plain",
           "dw_plan", "make_dw_plan", "vector_width"]


def _f32(v) -> float:
    return float(np.float32(v))


def depthwise_acc_int32(x_s8: torch.Tensor, w_q: torch.Tensor, stride: int) -> torch.Tensor:
    """The JAX package's shift lowering: (N, Hp, Wp, C) int8, already padded,
    and a (k, k, 1, C) int8 kernel -> (N, Ho, Wo, C) int32, Ho = (Hp - k) //
    stride + 1."""
    n, hp, wp, c = x_s8.shape
    k = w_q.shape[0]
    ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
    w32 = w_q.to(torch.int32)
    acc = None
    for dy in range(k):
        for dx in range(k):
            sl = x_s8[:, dy : dy + (ho - 1) * stride + 1 : stride,
                      dx : dx + (wo - 1) * stride + 1 : stride, :].to(torch.int32)
            term = sl * w32[dy, dx, 0]
            acc = term if acc is None else acc + term
    return acc


def _requant_div(y: torch.Tensor, scale, zp) -> torch.Tensor:
    s = torch.full((), _f32(scale), dtype=torch.float32, device=y.device)
    q = torch.round(y / s) + float(zp)
    return (torch.clamp(q, 0.0, 255.0) - 128.0).to(torch.int8)


def depthwise_conv_int8_plain(x_s8: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                              bias: torch.Tensor, *, stride: int, in_scale, in_zp, out_scale,
                              out_zp) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: (N, H, W, C) int8
    and a (k, k, 1, C) int8 kernel -> (N, Ho, Wo, C) int8, padding (k - 1) // 2."""
    k = w_q.shape[0]
    pad = (k - 1) // 2
    zp_s = int(in_zp) - 128
    xp = F.pad(x_s8, (0, 0, pad, pad, pad, pad), value=zp_s)
    acc = depthwise_acc_int32(xp, w_q, stride) - zp_s * w_q.to(torch.int32).sum(dim=(0, 1, 2))
    y = act_plain(acc.float() * (w_scale * _f32(in_scale)) + bias, "silu")
    return _requant_div(y, out_scale, out_zp)


def vector_width(c: int, *tensors: torch.Tensor) -> int:
    """The widest copy along C the kernel may take: 16, 8 or 4 bytes where C
    is a multiple and every tensor's address is aligned to it, else 1."""
    for v in (16, 8, 4):
        if c % v == 0 and all(t.data_ptr() % v == 0 for t in tensors):
            return v
    return 1


# the kernel's launch (csrc/dwconv_int8.cu): threads per block, the shared
# memory one block may take, and what an SM holds (H100 SXM)
DW_THREADS = 256
DW_SMEM_LIMIT = 232_448
DW_MAX_GROUP = 128     # channels per block
DW_REGS = 128          # registers per thread at most (__launch_bounds__(256, 2))
NUM_SMS = 132
SM_SMEM = 233_472      # 228 KB, 1 KB of it reserved per block
OUTPUTS_PER_THREAD = (2, 4)
ROWS_PER_THREAD = 2    # csrc/dwconv_int8.cu DWE_ROWS


def blocks_per_sm(smem: int) -> int:
    """Blocks of the kernel one SM holds: registers, then shared memory."""
    return min(65536 // (DW_THREADS * DW_REGS), SM_SMEM // (smem + 1024))


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """The kernel's tiles for one call. A block takes channel group
    ``blockIdx.y`` (``cg`` channels, a multiple of 4; the last group ragged
    past C) and ``nb`` consecutive tiles of the N x ``bands`` tiles (image,
    band of ``bh`` output rows at full width), tile t being image t //
    bands, band t % bands; it stages each tile's ``rh`` input rows x ``wp``
    padded pixels (the halo, and the pixels the last run reads past Wo) x
    ``cg`` bytes in shared memory (two buffers when ``nb`` > 1, the next
    tile's copies in flight while this one is computed). A thread
    computes ``p`` adjacent outputs along x in each of ``ROWS_PER_THREAD``
    adjacent rows, for 4 channels (one word); a band of odd ``bh`` stages the
    rows its last pair reads and skips that pair's second row.
    ``vec`` is the copy width in bytes (16, 8 or 4 by cp.async, 1: bytes, for
    C not a multiple of 4), the largest that divides C and ``cg``."""

    n: int
    ho: int
    wo: int
    c: int
    k: int
    stride: int
    cg: int
    bh: int
    nb: int
    p: int
    vec: int
    rh: int
    wp: int
    groups: int
    bands: int
    grid: tuple
    smem: int


def _out_hw(h: int, w: int, k: int, stride: int):
    pad = (k - 1) // 2
    return pad, (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def dw_smem(k: int, cg: int, rh: int, wp: int, nb: int) -> int:
    """Shared-memory bytes of a block: per channel of the group 2k tap-pair
    words, the int zero-point correction, the fp32 scale (s_in * s_w) and
    bias; then one tile buffer of rh x wp x cg bytes (rounded to 16) per
    stage, two when the block takes more than one tile. The kernel's
    DwLayout computes the same."""
    return 4 * cg * (2 * k + 3) + min(nb, 2) * (-(-rh * wp * cg // 16) * 16)


def make_dw_plan(n: int, h: int, w: int, c: int, k: int, stride: int, *, cg: int, bh: int,
                 nb: int, p: int) -> DwPlan:
    """A plan of the given tiles, its derived sizes filled in."""
    _, ho, wo = _out_hw(h, w, k, stride)
    # wp covers every thread's window, the last run's past Wo included
    rows = -(-bh // ROWS_PER_THREAD) * ROWS_PER_THREAD
    rh, wp = (rows - 1) * stride + k, (-(-wo // p) * p - 1) * stride + k
    groups, bands = -(-c // cg), -(-ho // bh)
    vec = next((v for v in (16, 8, 4) if c % v == 0 and cg % v == 0), 1)
    return DwPlan(n, ho, wo, c, k, stride, cg, bh, nb, p, vec, rh, wp, groups, bands,
                  (-(-n * bands // nb), groups), dw_smem(k, cg, rh, wp, nb))


def _item_cost(k: int, stride: int, p: int) -> int:
    """Issue slots of one thread's item, p outputs x 4 channels in each of
    its rows: per staged row a window of (p - 1) s + k words loaded and its
    input pairs built (a byte permute a pair and channel), (k + 1) / 2 dp2a
    per output, channel and tap row, and ~34 per value of epilogue."""
    r = ROWS_PER_THREAD
    nw, nr = (p - 1) * stride + k, (r - 1) * stride + k
    pairs = nw if stride == 1 else (nw + 1) // 2
    return nr * (nw + 4 * pairs) + r * k * (2 + 4 * p * (k + 1) // 2) + r * 4 * p * 34


@functools.lru_cache(maxsize=None)
def dw_plan(n: int, h: int, w: int, c: int, k: int, stride: int) -> DwPlan:
    """The channel group that pads C least with at most 128 channels (a
    multiple of 4), then the outputs per thread, band height and tiles per
    block (up to 4: the next tile's copies fly during this one's compute)
    that minimise an issue-slot estimate: every tile's thread passes over
    its items (ragged passes, runs past Wo and channels past C included),
    its staging copies (~16 a copy) and barriers (~4096 a tile), scaled by
    the card's waves at the blocks an SM holds and by the share of two
    blocks' warps an SM keeps in flight. A plan with two waves of blocks (at
    one block per SM) beats one without."""
    _, ho, wo = _out_hw(h, w, k, stride)
    c4 = -(-c // 4) * 4
    groups = -(-c4 // DW_MAX_GROUP)
    cg = -(-(-(-c4 // groups)) // 4) * 4
    best = None
    for p in OUTPUTS_PER_THREAD:
        runs = -(-wo // p)
        per_item = _item_cost(k, stride, p)
        for bh in range(1, ho + 1):
            tiles = n * -(-ho // bh)
            items = -(-bh // ROWS_PER_THREAD) * runs * (cg // 4)
            for nb in range(1, min(4, tiles) + 1):
                plan = make_dw_plan(n, h, w, c, k, stride, cg=cg, bh=bh, nb=nb, p=p)
                if plan.smem > DW_SMEM_LIMIT:
                    break
                per_sm = blocks_per_sm(plan.smem)
                staged = plan.rh * plan.wp * cg
                tile = (-(-items // DW_THREADS) * DW_THREADS * per_item
                        + staged // plan.vec * 16 + 4096)
                blocks, slots = plan.grid[0] * groups, NUM_SMS * per_sm
                cost = (tiles * groups * tile * (-(-blocks // slots) * slots / blocks)
                        * 2 / min(per_sm, 2))
                key = (blocks < 2 * NUM_SMS, cost, -bh)  # two waves first, where the grid allows
                if best is None or key < best[0]:
                    best = (key, plan)
    if best is None:
        raise ValueError(f"no tile plan fits ({n}, {h}, {w}, {c}) k {k} stride {stride}")
    return best[1]


def depthwise_conv_int8(x_s8: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                        bias: torch.Tensor, *, stride: int, in_scale, in_zp, out_scale,
                        out_zp) -> torch.Tensor:
    """int8 depthwise conv + epilogue -> (N, Ho, Wo, C) int8 in the output's
    shifted quint8 domain; ``w_q`` is the (k, k, 1, C) int8 kernel (k 3 or 5,
    stride 1 or 2, padding (k - 1) // 2)."""
    if x_s8.device.type == "cpu":
        return depthwise_conv_int8_plain(x_s8, w_q, w_scale, bias, stride=stride,
                                         in_scale=in_scale, in_zp=in_zp, out_scale=out_scale,
                                         out_zp=out_zp)
    if x_s8.device.type != "cuda":
        raise ValueError(f"depthwise_conv_int8 runs on cpu or cuda, not {x_s8.device}")
    dev = x_s8.device
    if x_s8.dim() != 4 or x_s8.dtype != torch.int8 or not x_s8.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, H, W, C) int8 tensor, got "
                         f"{tuple(x_s8.shape)} {x_s8.dtype}")
    n, h, w, c = x_s8.shape
    k = w_q.shape[0]
    if (w_q.shape != (k, k, 1, c) or k not in (3, 5) or w_q.dtype != torch.int8
            or w_q.device != dev or not w_q.is_contiguous()):
        raise ValueError(f"w must be a contiguous (k, k, 1, {c}) int8 tensor on {dev} with k 3 "
                         f"or 5, got {tuple(w_q.shape)} {w_q.dtype} on {w_q.device}")
    if stride not in (1, 2):
        raise ValueError(f"the kernel takes stride 1 or 2, got {stride}")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if (t.shape != (c,) or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({c},) float32 tensor on {dev}")
    if not (float(out_zp).is_integer() and 0 <= out_zp <= 255 and 0 <= int(in_zp) <= 255):
        raise ValueError(f"zero points must be integers in [0, 255], got {in_zp}, {out_zp}")
    _, ho, wo = _out_hw(h, w, k, stride)
    out = torch.empty((n, ho, wo, c), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    if n * max(h * w, ho * wo) * c >= 2**31:
        raise ValueError("the tensors exceed the kernel's int32 pixel indexing")
    plan = dw_plan(n, h, w, c, k, stride)
    # the plan's copy width, lowered to what x's address allows
    rc = _lib.kernel_fn("dwconv_int8")(
        x_s8.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n, h, w, c, k, stride, int(in_zp) - 128, _f32(in_scale), 1.0 / _f32(out_scale),
        float(out_zp), plan.cg, plan.bh, plan.nb, plan.p, vector_width(plan.vec, x_s8),
        plan.smem, torch.cuda.current_stream(dev).cuda_stream,
    )
    _lib.check("dwconv_int8", rc)
    return out
