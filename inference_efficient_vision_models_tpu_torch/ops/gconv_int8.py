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

The kernel computes each group's conv as an implicit GEMM on the tensor
cores (``mma.sync`` m16n8k32, int8 in, int32 sums). Its unit is a
*window*: one group, or two groups of Cg <= 4 side by side, ``win`` bytes a
pixel (each group in a slot of Cg rounded up to 8 bytes, 4 for Cg <= 4). A
window's GEMM has M = output pixels, N = the window's columns and K = 9 taps
x ``win`` bytes, in words (tap, 4 bytes) ordered so that each lane's two A
words of a k32 step lie side by side (one 64-bit shared-memory load); its
weights are block-diagonal and zero at every pad byte, so whatever the pad
bytes of the input hold adds nothing.
``pack_grouped_weight`` lays the weights out as the mma's B fragments once
at load time; ``gconv_plan`` chooses the tiles, and the kernel refuses any
other plan and any other route than ReLU + requant.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from . import _lib
from .dwconv_int8 import NUM_SMS, SM_SMEM

__all__ = ["GcGeom", "GcPlan", "GroupedInt8Weight", "gc_geom", "gconv_plan",
           "grouped_conv_int8", "grouped_conv_int8_plain", "make_gconv_plan",
           "pack_grouped_weight", "quotient_check", "quotient_rn"]


def _f32(v) -> float:
    return float(np.float32(v))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


# the kernel's launch (csrc/gconv_int8.cu): threads (8 warps) per block, the
# bytes of a slab's staged pixel at most, the n8 tiles one warp item holds
# at most, the shared memory one block may take, registers per thread
GC_THREADS = 256
GC_WARPS = GC_THREADS // 32
GC_MAX_SLAB = 128
GC_NTW = 4
GC_SMEM_LIMIT = 232_448
GC_REGS = 128  # __launch_bounds__(256, 2)


@dataclasses.dataclass(frozen=True)
class GcGeom:
    """The kernel's units for C channels in G groups (csrc/gconv_int8.cu
    gc_geom computes the same): each group in a ``slot`` of Cg rounded up to
    8 bytes (4 for Cg <= 4), a window of ``gw`` groups (2 for Cg <= 4, else
    1), ``win`` = gw slot bytes a pixel and tap, ``nwt`` = win / 4 K words a
    tap (even), ``ks`` k32 steps (9 nwt words, padded to 8), ``nt`` n8
    tiles (win columns, padded to ``ntw``, the tiles one warp item holds: 1,
    2 or 4, times a power of 2); ``nwin`` windows, ``ws`` of them a slab (ws win
    <= 128 bytes), ``gs`` = ws gw groups a slab, ``slabs`` slabs."""

    cg: int
    slot: int
    gw: int
    win: int
    nwt: int
    ks: int
    nt: int
    ntw: int
    nwin: int
    ws: int
    gs: int
    slabs: int


def gc_geom(c: int, groups: int) -> GcGeom:
    if groups < 1 or c % groups:
        raise ValueError(f"{c} channels are not {groups} groups")
    cg = c // groups
    if cg > GC_MAX_SLAB:
        raise ValueError(f"kernel F takes at most {GC_MAX_SLAB} channels a group, got {cg}")
    slot = 4 if cg <= 4 else _round_up(cg, 8)
    gw = 2 if cg <= 4 else 1
    win = gw * slot
    nwt = win // 4
    ks = -(-9 * nwt // 8)
    nt0 = -(-win // 8)
    ntw = nt0 if nt0 <= 2 else GC_NTW
    chunks = 1 << (-(-nt0 // ntw) - 1).bit_length()  # n chunks a window: a power of 2
    nwin = -(-groups // gw)
    ws = min(nwin, max(1, GC_MAX_SLAB // win))
    return GcGeom(cg, slot, gw, win, nwt, ks, chunks * ntw, ntw, nwin, ws, ws * gw,
                  -(-nwin // ws))


def k_word(kw: int, nwt: int):
    """K word kw of a window -> (tap, word i of the tap's window bytes), or
    None past the 9 taps (the pad of the last k32 step). Lane quarter tig of
    k32 step s takes words 8 s + 2 tig (its A and B registers 0: K bytes 4
    tig .. + 3 of the step) and 8 s + 2 tig + 1 (registers 1 and 2 of B and
    A: K bytes 16 + 4 tig .. + 3): one tap's adjacent words, nwt being
    even."""
    return divmod(kw, nwt) if kw < 9 * nwt else None


@dataclasses.dataclass
class GroupedInt8Weight:
    """A grouped 3x3 int8 kernel: ``hwio`` (3, 3, Cg, C) as the JAX package
    stores it (the plain version's operand) and ``words``, the kernel's
    layout: the mma B fragments, int32 words (nwin, ks, nt, 32 lanes, 2):
    lane l = 4 gid + tig of k step s and n8 tile j holds K words 8 s + 2 tig
    and 8 s + 2 tig + 1 (``k_word``; byte k of word kw: window byte 4 i + k
    of tap t, (t, i) = divmod(kw, nwt)) of column 8 j + gid."""

    hwio: torch.Tensor
    words: torch.Tensor
    groups: int

    @property
    def cg(self) -> int:
        return int(self.hwio.shape[2])

    @property
    def n(self) -> int:
        return int(self.hwio.shape[3])


@functools.lru_cache(maxsize=None)
def _b_index(cg: int, groups: int):
    """(gather index into the flattened (9, Cg, C) kernel, valid mask) of
    every byte of the B fragments, shaped (nwin, ks, nt, 32, 2, 4)."""
    g = gc_geom(cg * groups, groups)
    win, s, j, lane, half, k = np.meshgrid(np.arange(g.nwin), np.arange(g.ks), np.arange(g.nt),
                                           np.arange(32), np.arange(2), np.arange(4),
                                           indexing="ij")
    kw = 8 * s + 2 * (lane & 3) + half
    tap, i = kw // g.nwt, kw % g.nwt
    byte = 4 * i + k                       # byte of the window in the tap
    gi_in, ci = byte // g.slot, byte % g.slot
    col = 8 * j + (lane >> 2)
    gi_out, co = col // g.slot, col % g.slot
    grp = win * g.gw + gi_out
    valid = ((kw < 9 * g.nwt) & (col < g.win) & (gi_in == gi_out) & (ci < cg) & (co < cg)
             & (grp < groups))
    idx = (np.minimum(tap, 8) * cg + np.minimum(ci, cg - 1)) * (cg * groups) + \
        np.minimum(grp, groups - 1) * cg + np.minimum(co, cg - 1)
    return idx.reshape(-1), valid.reshape(-1)


def pack_grouped_weight(w_q: torch.Tensor, groups: int) -> GroupedInt8Weight:
    """(3, 3, Cg, C) int8, C = groups * Cg -> GroupedInt8Weight on w_q's
    device, once at load time."""
    if w_q.dtype != torch.int8 or w_q.dim() != 4 or tuple(w_q.shape[:2]) != (3, 3):
        raise ValueError(f"expected a (3, 3, Cg, C) int8 kernel, got {tuple(w_q.shape)} "
                         f"{w_q.dtype}")
    cg, c = int(w_q.shape[2]), int(w_q.shape[3])
    if c != groups * cg:
        raise ValueError(f"{c} output channels are not {groups} groups of {cg}")
    gc_geom(c, groups)  # refuses Cg past the kernel's limit
    w_np = w_q.cpu().numpy()
    idx, valid = _b_index(cg, groups)
    b = np.where(valid, w_np.reshape(-1)[idx], 0).astype(np.int8)
    words = torch.from_numpy(b.view(np.int32).copy()).to(w_q.device)
    return GroupedInt8Weight(w_q.contiguous(), words, groups)


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


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """RN_f32(a * b + c), rounded once, for float32 arrays: the product is
    exact in float64, the sum's rounding error comes back by TwoSum, and a
    float64 sum that lies on a float32 midpoint is settled by that error."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    f = s.astype(np.float32)
    nb = np.nextafter(f, np.where(s > f, np.float32(np.inf), np.float32(-np.inf)).astype(np.float32))
    mid = (f.astype(np.float64) != s) & ((f.astype(np.float64) + nb.astype(np.float64)) / 2 == s)
    out = np.where(mid & (err > 0), np.maximum(f, nb), np.where(mid & (err < 0), np.minimum(f, nb), f))
    return out.astype(np.float32)


def quotient_rn(y: np.ndarray, s) -> np.ndarray:
    """The kernel's fp32 quotient y / s (csrc/gconv_int8.cu quot_rn), step
    by step: r = RN(1 / s), q = RN(y r), q' = RN(q + RN(y - q s) r), each
    RN(a b + c) one fused multiply-add. It equals RN(y / s), the division
    of the plain version, which tests/test_torch_port_gconv.py checks here
    and chip_smoke.py checks on the card over every y below the clip."""
    s = np.asarray(s, np.float32)
    y = np.asarray(y, np.float32)
    r = (np.float32(1) / s).astype(np.float32)
    q = (y * r).astype(np.float32)
    e = _fma32(-q, s, y)
    return _fma32(e, r, q)


@dataclasses.dataclass(frozen=True)
class GcPlan:
    """The kernel's tiles for one call. A block takes channel slab
    ``blockIdx.y`` (``geom.ws`` whole windows, ``geom.gs`` groups; the last
    slab ragged past G) and ``nb`` consecutive tiles of the N x ``bands``
    (image, band of ``bh`` output rows at full width, bh even) tiles. It
    stages each tile's ``rh`` input rows x ``wp`` padded pixels at ``ps``
    bytes a pixel (the slab's ws win bytes, then pad: ``ps`` is chosen so
    that the mma's A fragment loads meet few bank conflicts), the halo at
    zp_s, and copies ``vec`` bytes at a time (16, 8 or 4 by cp.async, spread
    into the slots in shared memory where the groups do not fill them; 1:
    words gathered from x and shifted into place, for an unaligned x). Warp
    items are (``item_tiles`` m16 tiles, window, chunk of ``ntw`` n8
    tiles); an m16 tile is 2 output rows x 8 outputs along x (``runs`` of 8
    a row, past Wo computed and not stored). Each item's bytes go to a
    shared output tile (``ow`` = runs x 8 pixels a row, ``cso`` bytes a
    pixel, ``out_rows`` rows), which leaves ``vec_out`` bytes a store."""

    n: int
    h: int
    w: int
    c: int
    groups: int
    stride: int
    ho: int
    wo: int
    geom: GcGeom
    bh: int
    nb: int
    vec: int
    ps: int
    vec_out: int
    rh: int
    wp: int
    runs: int
    ow: int
    cso: int
    bands: int
    grid: tuple
    smem: int


def out_stride(nbytes: int) -> int:
    """Bytes of an output tile pixel: at least 2 past the slab's (the pad
    columns' stores go to the last two), rounded to 16, and 16 modulo 32, so
    that the 8 rows of an accumulator store hit 8 distinct 4-bank groups."""
    v = _round_up(nbytes + 2, 16)
    return v if v % 32 == 16 else v + 16


def item_tiles(g: GcGeom, runs: int) -> int:
    """m16 tiles a warp item: 8 / ntw, or 7 where a row holds a multiple of
    7 runs of 8 outputs (56 wide: then none is left over)."""
    return 7 if g.ntw == 1 and runs % 7 == 0 else 8 // g.ntw


def out_rows(g: GcGeom, bh: int, runs: int) -> int:
    """Rows of the output tile: the band's bh, and those the last warp item's
    m16 tiles past the band write to (never copied out)."""
    mt = item_tiles(g, runs)
    groups = -(-(bh // 2 * runs) // mt)
    return 2 * ((groups * mt - 1) // runs + 1)


def _out_hw(h: int, w: int, stride: int):
    return (h - 1) // stride + 1, (w - 1) // stride + 1


def gconv_smem(g: GcGeom, rh: int, wp: int, ps: int, bh: int, ow: int, cso: int, nb: int) -> int:
    """Shared-memory bytes of a block (csrc/gconv_int8.cu GcLayout): the
    slab's B fragments (ws ks nt x 256 bytes), the A offsets of each k step
    and lane quarter (ks x 32), a 16-byte record per slab column (ws nt 8),
    one input tile (rh wp ps, rounded to 16) per stage, two when a block
    takes more than one tile, and the output tile (``out_rows`` x ow x
    cso)."""
    bufs = 2 if nb > 1 else 1
    return (g.ws * g.ks * g.nt * 256 + g.ks * 32 + g.ws * g.nt * 128
            + bufs * _round_up(rh * wp * ps, 16)
            + _round_up(out_rows(g, bh, ow // 8) * ow * cso, 16))


def koff(g: GcGeom, kw: int, wp: int, ps: int) -> int:
    """Byte offset of K word kw from an output pixel's first tap in the
    staged tile (0 for the pad words: their weights are zero)."""
    tw = k_word(kw, g.nwt)
    if tw is None:
        return 0
    tap, i = tw
    return ((tap // 3) * wp + tap % 3) * ps + 4 * i


@functools.lru_cache(maxsize=None)
def a_wavefronts(g: GcGeom, stride: int, wp: int, ps: int) -> int:
    """Shared-memory wavefronts of one m16 tile's A fragment loads over the
    ks steps: two 64-bit loads a step (rows gid and gid + 8, the same
    pattern), each served a half warp at a time, a bank one word a
    wavefront: 4 ks without conflicts."""
    gid, tig = np.arange(32) >> 2, np.arange(32) & 3
    total = 0
    for s in range(g.ks):
        off = np.array([koff(g, 8 * s + 2 * t, wp, ps) for t in tig])
        words = (gid * stride * ps + off) // 4
        for half in (slice(0, 16), slice(16, 32)):
            w = np.concatenate([words[half], words[half] + 1])
            total += 2 * max(len(set(w[w % 32 == b])) for b in range(32))
    return total


def _vec_out(c: int, g: GcGeom, groups: int) -> int:
    last = (groups - (g.slabs - 1) * g.gs) * g.cg
    return next(v for v in (16, 8, 4, 2, 1)
                if c % v == 0 and (g.gs * g.cg) % v == 0 and last % v == 0)


def _vecs(c: int, g: GcGeom, align: int):
    """The copy widths the staging may take: 16, 8 or 4 bytes by cp.async
    where C and ``align`` (x's address) allow it (and the slab's bytes, where
    the groups fill their slots: Cg 4 or a multiple of 8; else the copied
    bytes are spread into the slots in shared memory), else 1 (words
    gathered from x and shifted into place)."""
    return tuple(v for v in (16, 8, 4) if v <= align and c % v == 0
                 and (g.cg != g.slot or (g.ws * g.win) % v == 0)) or (1,)


def spread_extent(g: GcGeom, groups: int, c: int, vec: int) -> int:
    """The most bytes the staging copies for one slab (vec at a time,
    aligned around the slab's bytes) where they are spread into the slots
    (csrc/gconv_int8.cu spread_extent); a staged pixel holds them and 8
    more."""
    most = 0
    for slab in range(g.slabs):
        g0 = slab * g.gs
        gsl = min(g.gs, groups - g0)
        lo = g0 * g.cg // vec * vec
        hi = min(c, _round_up((g0 + gsl) * g.cg, vec))
        most = max(most, hi - lo)
    return most


def _best_ps(g: GcGeom, stride: int, wp: int, vec: int, least: int = 0) -> int:
    """The staged pixel stride: at least the slab's bytes (and ``least``), a
    multiple of the copy width (8 at least: the A loads are 64-bit), with
    the fewest A-load wavefronts."""
    step = max(vec, 8)
    base = _round_up(max(g.ws * g.win, least), step)
    return min((base + k * step for k in range(8)),
               key=lambda ps: (a_wavefronts(g, stride, wp, ps), ps))


def slab_geom(g: GcGeom, ws: int) -> GcGeom:
    """g with slabs of ``ws`` windows (at most g.ws, the widest)."""
    if not 1 <= ws <= g.ws:
        raise ValueError(f"a slab holds 1 to {g.ws} windows, got {ws}")
    return dataclasses.replace(g, ws=ws, gs=ws * g.gw, slabs=-(-g.nwin // ws))


def make_gconv_plan(n: int, h: int, w: int, c: int, groups: int, stride: int, *, bh: int,
                    nb: int, vec: int, ps: int = 0, ws: int = 0) -> GcPlan:
    """A plan of the given band height, tiles per block, copy width and
    windows a slab, its derived sizes filled in (``ps`` 0: the best pixel
    stride; ``ws`` 0: the widest slab)."""
    g = gc_geom(c, groups)
    g = slab_geom(g, ws) if ws else g
    ho, wo = _out_hw(h, w, stride)
    runs = -(-wo // 8)
    ow = runs * 8
    rh, wp = (bh - 1) * stride + 3, (ow - 1) * stride + 3
    spread = vec > 1 and g.cg != g.slot
    ps = ps or _best_ps(g, stride, wp, vec, spread_extent(g, groups, c, vec) + 8 if spread else 0)
    cso = out_stride(g.gs * g.cg)
    bands = -(-ho // bh)
    return GcPlan(n, h, w, c, groups, stride, ho, wo, g, bh, nb, vec, ps, _vec_out(c, g, groups),
                  rh, wp, runs, ow, cso, bands, (-(-n * bands // nb), g.slabs),
                  gconv_smem(g, rh, wp, ps, bh, ow, cso, nb))


def blocks_per_sm(smem: int) -> int:
    """Blocks of the kernel one SM holds: registers, then shared memory."""
    return min(65536 // (GC_THREADS * GC_REGS), SM_SMEM // (smem + 1024))


def _item_cycles(g: GcGeom, wavefronts: int, mt: int) -> float:
    """SM cycles of one warp item (mt m16 tiles x ntw n8 tiles): the
    larger of its issue slots over the 4 schedulers and its shared-memory
    wavefronts (one a cycle). Issue: per k step the A offsets, B loads, 2
    loads and 2 address adds per m16 tile and MT ntw mma; per output value
    ~11 of epilogue (the int-to-float, scale, bias, ReLU, three for the
    quotient, rint, the zero point, the clip, half a pack) and a store per
    pair. Wavefronts: the A loads' (``wavefronts`` per m16 tile), the A
    offsets' and B loads', the column records and the stores."""
    issue = 40 + g.ks * (3 + g.ntw + mt * (4 + g.ntw)) + mt * g.ntw * (4 * 9 + 3)
    smem = g.ks * (2 + 2 * g.ntw) + mt * wavefronts + g.ntw * 10 + mt * g.ntw * 2
    return max(issue / 4, smem)


@functools.lru_cache(maxsize=None)
def gconv_plan(n: int, h: int, w: int, c: int, groups: int, stride: int,
               align: int = 16) -> GcPlan:
    """The band height (even), tiles per block (1..8: a block stages its
    slab's weights once, and the next tile while it computes one), copy
    width (the widest x allows: ``align`` is the largest of 16, 8, 4, 1
    dividing x's address) and, for small calls, windows a slab, that
    minimise an SM-cycle estimate: every tile's
    passes of 8 warp items (ragged passes and the m16 tiles past the band
    included; two warps' items share an SM's issue), its staging (a
    wavefront per 128 bytes at half weight for cp.async, a cycle a word
    gathered), its output copies and a fixed latency, each block's setup,
    scaled by the card's waves at the blocks an SM holds and doubled at one
    block per SM. Its weights were fitted to the times of every plan of
    resnext26_32x4d's calls and the ResNeXt chain's on an H100
    (``port_block_launches.py --gconv --sweep``). A plan with two waves of
    blocks (at one block per SM) beats one without, where the grid
    allows."""
    g0 = gc_geom(c, groups)
    ho, wo = _out_hw(h, w, stride)
    # narrower slabs only where the widest leave the card under two waves of
    # blocks even at the smallest band (small batches: more blocks, fewer
    # items each)
    few = n * -(-ho // 2) * g0.slabs < 2 * NUM_SMS
    slabs = [v for v in (g0.ws, g0.ws // 2, g0.ws // 4) if v >= 1] if few else [g0.ws]
    best = None
    for ws in dict.fromkeys(slabs):
        g = slab_geom(g0, ws)
        for vec, bh, nb in itertools.product(_vecs(c, g, align),
                                             range(2, _round_up(ho, 2) + 1, 2), range(1, 9)):
            plan = make_gconv_plan(n, h, w, c, groups, stride, bh=bh, nb=nb, vec=vec, ws=ws)
            tiles = n * plan.bands
            if plan.smem > GC_SMEM_LIMIT or nb > tiles:
                continue
            mt = item_tiles(g, plan.runs)
            items = -(-(bh // 2 * plan.runs) // mt) * g.ws * (g.nt // g.ntw)
            per_item = _item_cycles(g, a_wavefronts(g, stride, plan.wp, plan.ps), mt)
            staged = plan.rh * plan.wp * g.ws * g.win
            if vec > 1 and g.cg != g.slot:  # copied, then spread by a warp a pixel
                stage = plan.rh * plan.wp * (spread_extent(g, groups, c, vec) / 256 + g.ws
                                             * g.nwt / 16)
            else:
                stage = staged / 256 if vec > 1 else staged / 4
            copy_out = bh * wo * g.gs * g.cg / 64
            tile = -(-items // GC_WARPS) * GC_WARPS * per_item / 2 + stage + copy_out + 500
            setup = g.ws * g.ks * g.nt * 2 + 500
            per_sm = blocks_per_sm(plan.smem)
            blocks, slots = plan.grid[0] * g.slabs, NUM_SMS * per_sm
            cost = (blocks * (nb * tile + setup) * (-(-blocks // slots) * slots / blocks) / NUM_SMS
                    * (1.0 if per_sm >= 2 else 2.0) / min(per_sm, 2))
            key = (blocks < 2 * NUM_SMS, cost, -bh)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is None:
        raise ValueError(f"no tile plan fits ({n}, {h}, {w}, {c}) groups {groups} stride {stride}")
    return best[1]


def quotient_check(scales, device="cuda") -> dict:
    """The kernel's fp32 quotient (``quot_rn``) on the card against the
    division (``div_rn_by`` and ``__fdiv_rn``) over every float32 y >= 0 for
    each scale s -> {s: {"quotient": y in [2^-90, 512 s] whose quotient
    differs in any bit, "rint": y up to 512 s whose rounded integer (the
    epilogue's byte, any zero point) differs, "clip": y above 512 s whose
    quotient is neither NaN nor >= 511 (both then clip to 255),
    "largest_differing_y": the largest y up to 512 s whose quotient differs
    (0.0: none)}}. Launches no kernel F."""
    fn = _lib.kernel_fn("gconv_int8", "ievm_gconv_quotient_check")
    stream = torch.cuda.current_stream(device).cuda_stream
    bads = {}
    for s in scales:
        bad = torch.zeros(4, dtype=torch.int64, device=device)
        _lib.check_call("gconv_quotient_check", fn(_f32(s), bad.data_ptr(), stream))
        bads[_f32(s)] = bad
    out = {}
    for s, bad in bads.items():
        q, r, c, top = (int(v) for v in bad.cpu())
        out[s] = {"quotient": q, "rint": r, "clip": c,
                  "largest_differing_y": float(np.uint32(top).view(np.float32))}
    return out


def _align(t: torch.Tensor) -> int:
    return next(v for v in (16, 8, 4, 1) if t.data_ptr() % v == 0)


def grouped_conv_int8(x_s8: torch.Tensor, w: GroupedInt8Weight, w_scale: torch.Tensor,
                      bias: torch.Tensor, w_sum: torch.Tensor, *, stride: int, in_scale, in_zp,
                      out_scale, out_zp, relu: bool = True) -> torch.Tensor:
    """int8 grouped 3x3 conv (padding 1, stride 1 or 2) + ReLU + requant ->
    (N, Ho, Wo, C) int8 in the output's shifted quint8 domain. The op
    ``ievm::gconv_int8``."""
    if out_scale is None:
        raise NotImplementedError("kernel F computes the ReLU + requant route only")
    return _lib.call("gconv_int8", x_s8, w.words, w.hwio, int(w.groups), w_scale, bias, w_sum,
                     int(stride), float(in_scale), int(in_zp), float(out_scale), float(out_zp),
                     bool(relu))


def _op_cpu(x_s8, words, hwio, groups, w_scale, bias, w_sum, stride, in_scale, in_zp, out_scale,
            out_zp, relu):
    return grouped_conv_int8_plain(x_s8, GroupedInt8Weight(hwio, words, groups), w_scale, bias,
                                   w_sum, stride=stride, in_scale=in_scale, in_zp=in_zp,
                                   out_scale=out_scale, out_zp=out_zp, relu=relu)


def _op_fake(x_s8, words, hwio, groups, w_scale, bias, w_sum, stride, in_scale, in_zp, out_scale,
             out_zp, relu):
    n, h, wd, c = x_s8.shape
    return x_s8.new_empty((n, *_out_hw(h, wd, stride), c))


def _op_cuda(x_s8, words, hwio, groups, w_scale, bias, w_sum, stride, in_scale, in_zp,
             out_scale, out_zp, relu):
    """Validate and launch kernel F on CUDA tensors."""
    w = GroupedInt8Weight(hwio, words, groups)
    if not relu:
        raise NotImplementedError("kernel F computes the ReLU + requant route only")
    if x_s8.device.type != "cuda":
        raise ValueError(f"grouped_conv_int8 runs on cpu or cuda, not {x_s8.device}")
    dev = x_s8.device
    if x_s8.dim() != 4 or x_s8.dtype != torch.int8 or not x_s8.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, H, W, C) int8 tensor, got "
                         f"{tuple(x_s8.shape)} {x_s8.dtype}")
    n, h, wd, c = x_s8.shape
    if not isinstance(w, GroupedInt8Weight) or w.n != c or w.groups * w.cg != c:
        raise ValueError(f"w must be a GroupedInt8Weight of {c} channels on {dev}")
    g = gc_geom(c, w.groups)
    if (w.words.device != dev or w.words.dtype != torch.int32
            or w.words.numel() != g.nwin * g.ks * g.nt * 64):
        raise ValueError(f"w must be a GroupedInt8Weight of {c} channels on {dev}")
    if stride not in (1, 2):
        raise ValueError(f"the kernel takes stride 1 or 2, got {stride}")
    for name, t, dt in (("w_scale", w_scale, torch.float32), ("bias", bias, torch.float32),
                        ("w_sum", w_sum, torch.int32)):
        if t.shape != (c,) or t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({c},) {dt} tensor on {dev}")
    if not (float(out_zp).is_integer() and 0 <= out_zp <= 255 and 0 <= int(in_zp) <= 255):
        raise ValueError(f"zero points must be integers in [0, 255], got {in_zp}, {out_zp}")
    s_out = _f32(out_scale)
    if not (s_out > 0 and np.isfinite(np.float32(1) / np.float32(s_out))):
        raise ValueError(f"out_scale must be a positive normal float32, got {out_scale}")
    ho, wo = _out_hw(h, wd, stride)
    out = torch.empty((n, ho, wo, c), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    if n * max(h * wd, ho * wo) * c >= 2**31:
        raise ValueError("the tensors exceed the kernel's int32 pixel indexing")
    plan = gconv_plan(n, h, wd, c, w.groups, stride, _align(x_s8))
    rc = _lib.kernel_fn("gconv_int8", "ievm_gconv_int8")(
        x_s8.data_ptr(), w.words.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
        w_sum.data_ptr(), out.data_ptr(), n, h, wd, c, w.groups, stride, int(in_zp) - 128,
        _f32(in_scale), s_out, float(out_zp), plan.geom.ws, plan.bh, plan.nb, plan.vec,
        plan.ps, plan.vec_out, plan.smem, torch.cuda.current_stream(dev).cuda_stream,
    )
    _lib.check("gconv_int8", rc)
    return out


_lib.custom_op("gconv_int8",
               "(Tensor x, Tensor words, Tensor hwio, int groups, Tensor w_scale, Tensor bias, "
               "Tensor w_sum, int stride, float in_scale, int in_zp, float out_scale, "
               "float out_zp, bool relu) -> Tensor",
               cpu=_op_cpu, cuda=_op_cuda, fake=_op_fake)
