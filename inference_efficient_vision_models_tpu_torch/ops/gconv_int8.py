"""The int8 grouped 3x3 conv with its ReLU + requantizing epilogue (kernel F).

No Pallas kernel stands behind it: the JAX package computes a ResNeXt
bottleneck's conv2 with XLA,
``inference_efficient_vision_models_tpu/compress/quant/qresnet.py:330
_qconv_int8`` with ``feature_group_count=groups``, then ``_epilogue`` (:358)
and ``_requant`` (:363); ``_conv_q`` routes every ``groups > 1`` conv there.
PyTorch has no int8 convolution on CUDA, so on the GPU this runs the
hand-written kernel of ``csrc/gconv_int8.cu`` (its header says what bounds
it and how it is laid out). On shifted-quint8 int8 NHWC, C channels in G
groups of Cg, group-major (channel c in group c // Cg):

    acc = sum_{dy, dx, ci in group(co)} (x_pad - zp_s) * w[dy, dx, ci - g Cg, co]
          (int32; padding 1 with zp_s, which adds nothing)
    y   = relu(f32(acc) * (s_in * s_w[co]) + b[co])           (fp32)
    out = clip(round(y / s_out) + zp_out, 0, 255) - 128       (true division)

``grouped_conv_int8`` launches the kernel for a CUDA tensor and runs
``grouped_conv_int8_plain`` for a CPU tensor only. The plain version is the
JAX lowering step by step: pad with zp_s, the grouped conv in float64
(exact: every partial sum is an integer below 2^24), rounded to int32, the
int32 correction ``- zp_s * w_sum``, the fp32 epilogue op by op, the
division by a 0-d tensor (CUDA divides by a Python scalar as a multiply by
its reciprocal).

The kernel takes the weights in its own word layout
(``pack_grouped_weight``, once at load time) and the tiles ``gconv_plan``
chooses; it refuses any other plan and any other route than ReLU + requant.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _lib
from .dwconv_int8 import NUM_SMS, SM_SMEM, vector_width

__all__ = ["GcPlan", "GroupedInt8Weight", "gconv_plan", "grouped_conv_int8",
           "grouped_conv_int8_plain", "make_gconv_plan", "pack_grouped_weight"]


def _f32(v) -> float:
    return float(np.float32(v))


def _round4(v: int) -> int:
    return -(-v // 4) * 4


@dataclasses.dataclass
class GroupedInt8Weight:
    """A grouped 3x3 int8 kernel: ``hwio`` (3, 3, Cg, C) as the JAX package
    stores it (the plain version's operand) and ``words``, the kernel's
    layout: int32 words (G, 9, Cg4 / 4, Cg4), word (g, tap, i, co) holding
    the weights of input channels 4i .. 4i + 3 of group g for its output
    channel co (byte k: channel 4i + k), zero past Cg on either axis
    (Cg4 = Cg rounded up to 4)."""

    hwio: torch.Tensor
    words: torch.Tensor
    groups: int

    @property
    def cg(self) -> int:
        return int(self.hwio.shape[2])

    @property
    def n(self) -> int:
        return int(self.hwio.shape[3])


def pack_grouped_weight(w_q: torch.Tensor, groups: int) -> GroupedInt8Weight:
    """(3, 3, Cg, C) int8, C = groups * Cg -> GroupedInt8Weight on w_q's
    device, once at load time."""
    if w_q.dtype != torch.int8 or w_q.dim() != 4 or tuple(w_q.shape[:2]) != (3, 3):
        raise ValueError(f"expected a (3, 3, Cg, C) int8 kernel, got {tuple(w_q.shape)} "
                         f"{w_q.dtype}")
    cg, c = int(w_q.shape[2]), int(w_q.shape[3])
    if c != groups * cg:
        raise ValueError(f"{c} output channels are not {groups} groups of {cg}")
    cg4 = _round4(cg)
    w = w_q.reshape(9, cg, groups, cg)  # (tap, ci, g, co)
    w = F.pad(w, (0, cg4 - cg, 0, 0, 0, cg4 - cg))  # (tap, Cg4 ci, g, Cg4 co)
    w = w.reshape(9, cg4 // 4, 4, groups, cg4).permute(3, 0, 1, 4, 2)  # (g, tap, i, co, k)
    words = w.contiguous().view(torch.int32).reshape(-1)
    return GroupedInt8Weight(w_q.contiguous(), words.contiguous(), groups)


def _requant_div(y: torch.Tensor, scale, zp) -> torch.Tensor:
    s = torch.full((), _f32(scale), dtype=torch.float32, device=y.device)
    q = torch.round(y / s) + float(zp)
    return (torch.clamp(q, 0.0, 255.0) - 128.0).to(torch.int8)


def grouped_acc_int32(x_s8: torch.Tensor, w_hwio: torch.Tensor, groups: int, stride: int,
                      zp_s: int) -> torch.Tensor:
    """XLA's grouped int8 conv: (N, H, W, C) int8 padded by 1 with ``zp_s``,
    a (3, 3, Cg, C) kernel -> the (N, Ho, Wo, C) int32 sum of x * w, in
    float64 (exact: every partial sum is an integer of magnitude < 2^24)."""
    xp = F.pad(x_s8, (0, 0, 1, 1, 1, 1), value=zp_s)
    acc = F.conv2d(xp.permute(0, 3, 1, 2).double(), w_hwio.permute(3, 2, 0, 1).double(),
                   stride=stride, groups=groups)
    return acc.permute(0, 2, 3, 1).round().to(torch.int32)


def grouped_conv_int8_plain(x_s8: torch.Tensor, w: GroupedInt8Weight, w_scale: torch.Tensor,
                            bias: torch.Tensor, w_sum: torch.Tensor, *, stride: int, in_scale,
                            in_zp, out_scale, out_zp, relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: the JAX grouped
    ``_qconv_int8`` + ``_epilogue`` + ``_requant`` op by op -> (N, Ho, Wo, C)
    int8 (padding 1)."""
    if not relu:
        raise NotImplementedError("kernel F computes the ReLU + requant route only")
    zp_s = int(in_zp) - 128
    acc = grouped_acc_int32(x_s8, w.hwio, w.groups, stride, zp_s) - zp_s * w_sum
    y = torch.relu(acc.float() * (w_scale * _f32(in_scale)) + bias)
    return _requant_div(y, out_scale, out_zp)


# the kernel's launch (csrc/gconv_int8.cu): threads per block, outputs per
# thread along x, channels per thread, bytes of a slab's pixel at most, and
# the shared memory one block may take
GC_THREADS = 256
GC_P = 4
GC_MAX_SLAB = 128
GC_SMEM_LIMIT = 232_448
GC_REGS = 128  # __launch_bounds__(256, 2)


def group_stride_words(cg4: int) -> int:
    """Words between two groups' weights in shared memory: the group's 9
    Cg4^2 / 4 words, padded so that the stride is 4 (Cg4 / 4) modulo 32:
    thread i of a quarter warp (group i // (Cg4/4), channel word i % (Cg4/4))
    then reads banks 4i .. 4i + 3, without conflicts."""
    gw = 9 * cg4 * cg4 // 4
    return gw + (cg4 - gw) % 32


def gconv_smem(gs: int, cg4: int, rh: int, wp: int, nb: int) -> int:
    """Shared-memory bytes of a block: the slab's weights (gs groups at
    ``group_stride_words``), three fp32/int vectors of the slab's padded
    channels (the correction -zp_s w_sum, s_in s_w, the bias), then one tile
    buffer of rh x wp x (gs Cg4) bytes (rounded to 16) per stage, two when
    the block takes more than one tile. The kernel's GcLayout computes the
    same."""
    cs = gs * cg4
    return 4 * gs * group_stride_words(cg4) + 12 * cs + min(nb, 2) * (-(-rh * wp * cs // 16) * 16)


@dataclasses.dataclass(frozen=True)
class GcPlan:
    """The kernel's tiles for one call. A block takes channel slab
    ``blockIdx.y`` (``gs`` whole groups, Cg4 bytes each in shared memory: cs
    = gs Cg4 <= 128 bytes a pixel; the last slab ragged past G) and ``nb``
    consecutive tiles of the N x ``bands`` (image, band of ``bh`` output
    rows at full width) tiles, staging each tile's ``rh`` input rows x
    ``wp`` padded pixels (the halo, and the pixels the last run reads past
    Wo). A thread computes GC_P adjacent outputs along x of one row for 4
    output channels of one group. ``vec`` is the copy width in bytes (16, 8
    or 4 by cp.async, 1: bytes, for Cg not a multiple of 4)."""

    n: int
    h: int
    w: int
    c: int
    groups: int
    stride: int
    ho: int
    wo: int
    cg: int
    cg4: int
    gs: int
    slabs: int
    bh: int
    nb: int
    vec: int
    rh: int
    wp: int
    bands: int
    grid: tuple
    smem: int


def _out_hw(h: int, w: int, stride: int):
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def make_gconv_plan(n: int, h: int, w: int, c: int, groups: int, stride: int, *, bh: int,
                    nb: int) -> GcPlan:
    """A plan of the given band height and tiles per block, its derived sizes
    filled in."""
    ho, wo = _out_hw(h, w, stride)
    cg = c // groups
    cg4 = _round4(cg)
    gs = min(groups, max(1, GC_MAX_SLAB // cg4))
    cs = gs * cg4
    rh, wp = (bh - 1) * stride + 3, (-(-wo // GC_P) * GC_P - 1) * stride + 3
    bands, slabs = -(-ho // bh), -(-groups // gs)
    vec = next((v for v in (16, 8, 4) if cg % 4 == 0 and c % v == 0 and cs % v == 0), 1)
    return GcPlan(n, h, w, c, groups, stride, ho, wo, cg, cg4, gs, slabs, bh, nb, vec, rh, wp,
                  bands, (-(-n * bands // nb), slabs), gconv_smem(gs, cg4, rh, wp, nb))


def _item_cost(cg4: int, stride: int) -> int:
    """Issue slots of one thread's item (GC_P outputs x 4 channels of one
    row): per tap row and input word of the group the window's words and
    three 16-byte weight loads, 3 GC_P x 4 dp4a (two slots each: half the
    rate of a simple integer op); ~16 per output value of epilogue."""
    nw = (GC_P - 1) * stride + 3
    return 3 * (cg4 // 4) * (nw + 3 + 2 * 3 * GC_P * 4) + 16 * GC_P * 4


def blocks_per_sm(smem: int) -> int:
    """Blocks of the kernel one SM holds: registers, then shared memory."""
    return min(65536 // (GC_THREADS * GC_REGS), SM_SMEM // (smem + 1024))


@functools.lru_cache(maxsize=None)
def gconv_plan(n: int, h: int, w: int, c: int, groups: int, stride: int) -> GcPlan:
    """The band height and tiles per block (1..8: a block stages its slab's
    weights once) that minimise an issue-slot estimate: every tile's passes
    over its items (ragged passes, runs past Wo and rows past Ho included),
    its staging copies (~16 a copy), barriers (~4096 a tile), and each
    block's weight staging, scaled by the card's waves at the blocks an SM
    holds. A plan with two waves of blocks (at one block per SM) beats one
    without, where the grid allows."""
    if c % groups:
        raise ValueError(f"{c} channels are not {groups} groups")
    cg4 = _round4(c // groups)
    if cg4 > GC_MAX_SLAB:
        raise ValueError(f"kernel F takes at most {GC_MAX_SLAB} channels a group, "
                         f"got {c // groups}")
    ho, wo = _out_hw(h, w, stride)
    per_item = _item_cost(cg4, stride)
    best = None
    for bh in range(1, ho + 1):
        for nb in range(1, 9):
            plan = make_gconv_plan(n, h, w, c, groups, stride, bh=bh, nb=nb)
            if plan.smem > GC_SMEM_LIMIT:
                break
            tiles = n * plan.bands
            if nb > tiles:
                break
            items = bh * -(-wo // GC_P) * plan.gs * (cg4 // 4)
            per_sm = blocks_per_sm(plan.smem)
            staged = plan.rh * plan.wp * plan.gs * cg4
            tile = -(-items // GC_THREADS) * GC_THREADS * per_item + staged // plan.vec * 16 + 4096
            weights = 9 * plan.gs * cg4 * cg4 // 16 * 16 + 4096
            blocks, slots = plan.grid[0] * plan.slabs, NUM_SMS * per_sm
            cost = ((tiles * plan.slabs * tile + blocks * weights)
                    * (-(-blocks // slots) * slots / blocks) * 2 / min(per_sm, 2))
            key = (blocks < 2 * NUM_SMS, cost, -bh)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is None:
        raise ValueError(f"no tile plan fits ({n}, {h}, {w}, {c}) groups {groups} stride {stride}")
    return best[1]


def grouped_conv_int8(x_s8: torch.Tensor, w: GroupedInt8Weight, w_scale: torch.Tensor,
                      bias: torch.Tensor, w_sum: torch.Tensor, *, stride: int, in_scale, in_zp,
                      out_scale, out_zp, relu: bool = True) -> torch.Tensor:
    """int8 grouped 3x3 conv (padding 1, stride 1 or 2) + ReLU + requant ->
    (N, Ho, Wo, C) int8 in the output's shifted quint8 domain."""
    if x_s8.device.type == "cpu":
        return grouped_conv_int8_plain(x_s8, w, w_scale, bias, w_sum, stride=stride,
                                       in_scale=in_scale, in_zp=in_zp, out_scale=out_scale,
                                       out_zp=out_zp, relu=relu)
    if not relu or out_scale is None:
        raise NotImplementedError("kernel F computes the ReLU + requant route only")
    if x_s8.device.type != "cuda":
        raise ValueError(f"grouped_conv_int8 runs on cpu or cuda, not {x_s8.device}")
    dev = x_s8.device
    if x_s8.dim() != 4 or x_s8.dtype != torch.int8 or not x_s8.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, H, W, C) int8 tensor, got "
                         f"{tuple(x_s8.shape)} {x_s8.dtype}")
    n, h, wd, c = x_s8.shape
    if (not isinstance(w, GroupedInt8Weight) or w.n != c or w.groups * w.cg != c
            or w.words.device != dev or w.words.dtype != torch.int32
            or w.words.numel() != w.groups * 9 * _round4(w.cg) ** 2 // 4):
        raise ValueError(f"w must be a GroupedInt8Weight of {c} channels on {dev}")
    if stride not in (1, 2):
        raise ValueError(f"the kernel takes stride 1 or 2, got {stride}")
    for name, t, dt in (("w_scale", w_scale, torch.float32), ("bias", bias, torch.float32),
                        ("w_sum", w_sum, torch.int32)):
        if t.shape != (c,) or t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({c},) {dt} tensor on {dev}")
    if not (float(out_zp).is_integer() and 0 <= out_zp <= 255 and 0 <= int(in_zp) <= 255):
        raise ValueError(f"zero points must be integers in [0, 255], got {in_zp}, {out_zp}")
    ho, wo = _out_hw(h, wd, stride)
    out = torch.empty((n, ho, wo, c), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    if n * max(h * wd, ho * wo) * c >= 2**31:
        raise ValueError("the tensors exceed the kernel's int32 pixel indexing")
    plan = gconv_plan(n, h, wd, c, w.groups, stride)
    # the plan's copy width, lowered to what x's address allows
    rc = _lib.kernel_fn("gconv_int8")(
        x_s8.data_ptr(), w.words.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
        w_sum.data_ptr(), out.data_ptr(), n, h, wd, c, w.groups, stride, int(in_zp) - 128,
        _f32(in_scale), 1.0 / _f32(out_scale), float(out_zp), plan.gs, plan.bh, plan.nb,
        vector_width(plan.vec, x_s8), plan.smem, torch.cuda.current_stream(dev).cuda_stream,
    )
    _lib.check("gconv_int8", rc)
    return out
