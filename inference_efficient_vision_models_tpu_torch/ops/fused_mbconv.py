"""One whole int8 MBConv block (expand, depthwise, SE gate, project, residual).

Replaces the Pallas TPU kernel
``inference_efficient_vision_models_tpu/ops/fused_mbconv.py:fused_mbconv_block``
with the hand-written CUDA kernels of ``csrc/fused_mbconv.cu`` (its header
says what bounds them on an H100 and why the block is split in two passes
around a per-image SE gate). Same contract, on shifted-quint8 int8 NHWC:

    hidden = requant_e(act(X . We * ve0 + ve1)) - e_zp    (or X - zp_s_in)
    y      = act(dwconv_k,s(zero-pad(hidden), wdw) * vdw0 + vdw1)
    yq     = clip(round(y * inv_d) + d_zp, 0, 255)
    h      = (yq - d_zp) * d_scale
    h      = h * g,  g = sigmoid(silu(mean(h) . srw + srb) . sew + seb)   (SE)
    hq     = clip(round(h * inv_q) + q_zp, 0, 255) - 128
    yp     = hq . Wp * vp0 + vp1  [+ (x_res - res_zp_s) * res_scale]
    out    = clip(round(yp * inv_o) + o_zp, 0, 255) - 128

``fused_mbconv_block`` launches the kernels for a CUDA tensor (three
launches with SE, two without) and runs ``fused_mbconv_block_plain`` for a
CPU tensor only; ``expand_dw_plan`` chooses the first launch's tiles,
``se_gate_group`` the images per block of the second, ``project_plan`` the
third's. The
SE gate is taken in float64 from the exact integer sum of ``yq - d_zp`` and
rounded to fp32 once, on both sides, so kernel and plain version agree bit
for bit whatever order each sums in; the JAX kernel takes it in fp32 from an
fp32 mean, which differs from both by ulps of ``g``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _lib
from .int8_matmul import NUM_SMS, PackedInt8Weight, pack_weight

# the scalar row of the packed block (the Pallas kernel's SMEM row layout)
ZP_S_IN = 0      # input zero point - 128 (shifted)
INV_E, E_ZP = 1, 2          # expand requant (unused without expand)
INV_D, D_ZP, D_SCALE = 3, 4, 5   # dw requant + dequant scale
INV_Q, Q_ZP = 6, 7          # project-input requant (SE domain / dw domain)
INV_O, O_ZP = 8, 9          # block-output requant
RES_SCALE, RES_ZP_S = 10, 11  # residual dequant

_ACTS = {"silu": 0, "relu6": 1}
_VEC_KEYS = ("ve", "wdw", "vdw", "srw", "srb", "sew", "seb", "vp")


def act_plain(y: torch.Tensor, kind: str) -> torch.Tensor:
    """SiLU as y * (1 / (1 + exp(-y))) in fp32, the kernels' formula, ReLU6,
    or ``"none"`` (the identity: a ViT patch embed)."""
    if kind == "silu":
        return y * torch.reciprocal(1.0 + torch.exp(-y))
    if kind == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    if kind == "none":
        return y
    raise ValueError(f"unknown act {kind!r}")


def _requant_q(y: torch.Tensor, inv: float, zp: float) -> torch.Tensor:
    """clip(round(y * inv) + zp, 0, 255) as fp32 (the quint8 value)."""
    return torch.clamp(torch.round(y * inv) + zp, 0.0, 255.0)


def to_device_packed(packed_np: Dict, device) -> Dict:
    """One block's packed operands (numpy, ``fusedpath.pack_fused``) -> the
    kernels' operands on ``device``, once at load: int8 weights in the GEMM
    core's packed layout, fp32 vectors contiguous, the scalar row as 12
    Python floats so a forward needs no host sync."""
    out: Dict = {"scal": tuple(float(v) for v in np.asarray(packed_np["scal"]).reshape(-1))}
    for k in ("we", "wp"):
        if k in packed_np:
            out[k] = pack_weight(torch.from_numpy(np.array(packed_np[k], np.int8)).to(device))
    wdw = np.asarray(packed_np["wdw"], np.float32)
    if not (np.array_equal(wdw, np.rint(wdw)) and np.abs(wdw).max(initial=0) <= 128):
        # the kernel's depthwise sums are exact in any order only for int8 weights
        raise ValueError("the depthwise weights must be int8 values")
    for k in _VEC_KEYS:
        if k in packed_np:
            v = np.array(packed_np[k], np.float32)
            if k in ("srb", "seb"):
                v = v.reshape(-1)
            out[k] = torch.from_numpy(v).to(device)
    return out


def se_gate_plain(pool_sum: torch.Tensor, packed: Dict, pool_scale: float) -> torch.Tensor:
    """(N, Ce) integer sums of yq - d_zp -> the fp32 SE gate (N, Ce), in float64."""
    pooled = pool_sum.double() * pool_scale
    r = pooled @ packed["srw"].double() + packed["srb"].double()
    r = r * torch.reciprocal(1.0 + torch.exp(-r))
    v = r @ packed["sew"].double() + packed["seb"].double()
    return torch.reciprocal(1.0 + torch.exp(-v)).float()


def _out_hw(h: int, w: int, kernel: int, stride: int):
    pad = (kernel - 1) // 2
    return pad, (h + 2 * pad - kernel) // stride + 1, (w + 2 * pad - kernel) // stride + 1


def fused_mbconv_block_plain(x_s8: torch.Tensor, packed: Dict, *, kernel: int, stride: int,
                             act: str, x_res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels, launch by launch, on any device.

    Both int8 GEMMs accumulate in float64 (exact for int8 products); the
    depthwise sum is exact in fp32 (|sum| <= 25 * 255 * 128 < 2^24)."""
    return _block(x_s8, packed, kernel, stride, act, x_res,
                  lambda name, *args: _PLAIN[name](*args))


def _block(x_s8, packed, kernel, stride, act, x_res, run):
    """The block as its three launches, each run by ``run(name, *args)``."""
    sc = list(packed["scal"])
    we = packed.get("we")
    yq, pool = run("fused_mbconv_expand_dw", x_s8, we.wt if we else None,
                   list(we.shape) if we else [], packed.get("ve"), packed["wdw"], packed["vdw"],
                   sc, int(kernel), int(stride), act, "srw" in packed)
    g = None
    if "srw" in packed:
        g = run("fused_mbconv_se_gate", pool, packed["srw"], packed["srb"], packed["sew"],
                packed["seb"], sc[D_SCALE] / (yq.shape[1] * yq.shape[2]))
    wp = packed["wp"]
    return run("fused_mbconv_project", yq, g, wp.wt, list(wp.shape), packed["vp"], x_res, sc)


def _expand_dw_plain(x_s8, we_wt, we_shape, ve, wdw, vdw, sc, kernel, stride, act, se):
    """Launch 1: expand, depthwise, act, requant -> (yq: the quint8 values
    - 128, int8; pool: their per-image sums of yq - d_zp, int32, or empty
    without SE)."""
    n, h, w, cin = x_s8.shape
    pad, ho, wo = _out_hw(h, w, kernel, stride)
    if we_wt is not None:
        acc = x_s8.reshape(-1, cin).double() @ PackedInt8Weight(we_wt, tuple(we_shape)).kn().double()
        y = act_plain(acc.float() * ve[0] + ve[1], act)
        hidden = (_requant_q(y, sc[INV_E], sc[E_ZP]) - sc[E_ZP]).reshape(n, h, w, -1)
    else:
        hidden = x_s8.float() - sc[ZP_S_IN]
    hp = F.pad(hidden, (0, 0, pad, pad, pad, pad))
    acc = None
    for dy in range(kernel):
        for dx in range(kernel):
            sl = hp[:, dy : dy + (ho - 1) * stride + 1 : stride,
                    dx : dx + (wo - 1) * stride + 1 : stride, :]
            term = sl * wdw[dy * kernel + dx]
            acc = term if acc is None else acc + term
    q = _requant_q(act_plain(acc * vdw[0] + vdw[1], act), sc[INV_D], sc[D_ZP])
    pool = ((q - sc[D_ZP]).double().sum(dim=(1, 2)).to(torch.int32) if se
            else x_s8.new_zeros((0,), dtype=torch.int32))
    return (q - 128.0).to(torch.int8), pool


def _se_gate_plain(pool, srw, srb, sew, seb, pool_scale):
    """Launch 2: the SE gate from the pooled sums."""
    return se_gate_plain(pool, {"srw": srw, "srb": srb, "sew": sew, "seb": seb}, pool_scale)


def _project_plain(yq, g, wp_wt, wp_shape, vp, x_res, sc):
    """Launch 3: (yq - d_zp) * d_scale [* g], requantized, the project GEMM,
    the residual and the block-output requant."""
    n, ho, wo, ce = yq.shape
    hf = ((yq.float() + 128.0) - sc[D_ZP]) * sc[D_SCALE]
    if g is not None:
        hf = hf * g[:, None, None, :]
    hq = (_requant_q(hf, sc[INV_Q], sc[Q_ZP]) - 128.0).to(torch.int8)
    wp = PackedInt8Weight(wp_wt, tuple(wp_shape))
    accp = hq.reshape(-1, ce).double() @ wp.kn().double()
    yp = (accp.float() * vp[0] + vp[1]).reshape(n, ho, wo, wp.n)
    if x_res is not None:
        yp = yp + (x_res.float() - sc[RES_ZP_S]) * sc[RES_SCALE]
    return (_requant_q(yp, sc[INV_O], sc[O_ZP]) - 128.0).to(torch.int8)


_PLAIN = {"fused_mbconv_expand_dw": _expand_dw_plain, "fused_mbconv_se_gate": _se_gate_plain,
          "fused_mbconv_project": _project_plain}


# the first launch's tile plan (csrc/fused_mbconv.cu checks it and lays out its
# shared memory by the same formula as expand_dw_smem)
DW_SMEM_LIMIT = 232_448   # shared memory one block may take (227 KB)
DW_MAP_LIMIT = 56 * 1024  # the byte map of one tile: three blocks fit on an SM
DW_P = 4                  # adjacent outputs along x per depthwise thread
MAP_PAD = 4               # bytes after the channel tile in a map row
CHANNEL_TILES = (32, 48)


def expand_dw_smem(r: int, ct: int, kc: int, kernel: int, expand: bool) -> int:
    """Dynamic shared memory of one expand_dw block (``DwLayout``): the byte
    map (``r`` region pixels of ``ct + 4`` bytes, rounded up to 16), the
    expand's weight tile (``ct`` rows of ``kc + 16`` bytes), the depthwise
    weights (k*k x ct fp32), four ct-vectors of scales and the pool sums."""
    return (-(-r * (ct + MAP_PAD) // 16) * 16 + (ct * (kc + 16) if expand else 0)
            + kernel * kernel * ct * 4 + 4 * ct * 4 + ct * 4)


@dataclasses.dataclass(frozen=True)
class ExpandDwPlan:
    """Tiles of the first launch: ``ct`` expanded channels per block, output
    tiles of ``th`` x ``tw`` whose halo'd input regions are ``rh`` x ``rw``
    pixels, on a (``tiles_y * tiles_x``, ``ctiles``, N) grid; ``kc`` is the
    expand's K (Cin rounded up to the mma's 32; 0 without expand)."""

    ct: int
    th: int
    tw: int
    rh: int
    rw: int
    tiles_y: int
    tiles_x: int
    ctiles: int
    kc: int
    smem: int


def expand_dw_plan(h: int, w: int, cin: int, ce: int, kernel: int, stride: int,
                   expand: bool) -> ExpandDwPlan:
    """The channel tile that pads Ce least (32 on a tie), then the square
    output tile (clipped to the map) whose expand-plus-depthwise work is
    least: every region pixel costs an expand epilogue per channel (~30
    instructions, or a copy without expand), every output slot of the
    tiles, ragged edges included, a depthwise conv and its epilogue; the
    map must fit in ``DW_MAP_LIMIT``. The larger tile wins a tie."""
    _, ho, wo = _out_hw(h, w, kernel, stride)
    ct = min(CHANNEL_TILES, key=lambda c: (-(-ce // c) * c, c))
    kc = -(-cin // 32) * 32 if expand else 0
    best = None
    for t in range(1, max(ho, wo) + 1):
        th, tw = min(t, ho), min(t, wo)
        rh, rw = (th - 1) * stride + kernel, (tw - 1) * stride + kernel
        if rh * rw * (ct + MAP_PAD) > DW_MAP_LIMIT:
            break
        tiles = -(-ho // th) * -(-wo // tw)
        cost = tiles * (rh * rw * (30 if expand else 2)
                        + th * -(-tw // DW_P) * DW_P * (kernel * kernel + 30))
        if best is None or cost <= best[0]:
            best = (cost, th, tw, rh, rw)
    _, th, tw, rh, rw = best
    return ExpandDwPlan(ct, th, tw, rh, rw, -(-ho // th), -(-wo // tw), -(-ce // ct), kc,
                        expand_dw_smem(rh * rw, ct, kc, kernel, expand))


def _round16(v: int) -> int:
    return -(-v // 16) * 16


# the SE gate's images per block and shared memory (csrc/fused_mbconv.cu SeLayout)
SE_THREADS = 512
SE_MAX_SQUEEZE = 256  # Se: FC1 gives each column a thread per row group
SE_GROUPS = (1, 2, 4, 8)
SE_STAGES = 4         # chunks of the SE weights in the ring
SE_CHUNK = 8192       # floats a chunk takes at most, unless one row is longer


def se_gate_smem(group: int, ce: int, se: int) -> int:
    """Dynamic shared memory of one SE-gate block (``SeLayout``): the pooled
    means and FC2's sums (group x Ce doubles each), FC1's partial sums by row
    group (512 // Se groups x group x Se doubles) and its activations (group
    x Se doubles), then, on a 16-byte boundary, a ring of SE_STAGES weight
    chunks (FC1: a multiple of 4 rows of Se floats, FC2: rows of Ce floats,
    about SE_CHUNK floats)."""
    rows1 = SE_CHUNK // se // 4 * 4 if SE_CHUNK // se >= 8 else 4
    rows2 = max(1, SE_CHUNK // ce)
    stage = -(-max(rows1 * se, rows2 * ce) // 4) * 4
    head = (2 * group * ce + (SE_THREADS // se) * group * se + group * se) * 8
    return _round16(head) + SE_STAGES * stage * 4


def se_gate_group(n: int, ce: int, se: int) -> int:
    """Images per SE-gate block: the fewest that keep the blocks within one
    wave of the SMs (each block reads both SE weights once), at most 8, and
    fewer where their sums would not fit in shared memory."""
    fits = [g for g in SE_GROUPS if se_gate_smem(g, ce, se) <= DW_SMEM_LIMIT] or [1]
    return next((g for g in fits if -(-n // g) <= NUM_SMS), fits[-1])


# the project launch's tile plan (csrc/fused_mbconv.cu checks it and lays out
# its shared memory by the same formula as project_smem)
PJ_KS = 128          # K bytes per chunk: one 128-byte-swizzled row
PJ_BM = 64           # rows a panel: one warpgroup's wgmma M
PJ_THREADS = 256     # at most two warpgroups a block, along N
PJ_NARROW = 48       # tiles up to this wide are built for 1024 threads an SM (64 registers)
PJ_SM_SMEM = 233_472  # an SM's shared memory (228 KB), 1 KB of it reserved per block
PJ_TNS = (16, 24, 32, 48, 64, 80, 96, 112, 128, 160)  # s8 wgmma widths the served Co need


def project_smem(nb: int, nch: int, stages: int, resident: bool, gi: int, co: int,
                 se: bool, residual: bool) -> int:
    """Dynamic shared memory of one project block (``ProjLayout``): the A
    ring (stages x 64 rows of 128 bytes), the weights (nch resident chunks or
    a ring of stages, nb rows of 128 bytes), the gate ring (stages x gi
    images x 128 fp32), the residual ring (stages x 64 x Co bytes), the
    staged output rows (64 x nb), vp (2 x nb fp32), the byte table and the
    1024-byte alignment."""
    return (stages * PJ_BM * PJ_KS + (nch if resident else stages) * nb * PJ_KS
            + (stages * gi * PJ_KS * 4 if se else 0)
            + (stages * _round16(PJ_BM * co) if residual else 0)
            + _round16(PJ_BM * nb) + 8 * nb + 256 + 1024)


@dataclasses.dataclass(frozen=True)
class ProjectPlan:
    """Tiles of the project launch. A warpgroup multiplies a panel of 64 rows
    by ``tn`` columns; a block has ``wg_n`` of them, so it owns ``nb`` =
    wg_n tn columns, Co split over ``nsplit`` blocks along y. ``grid``
    persistent blocks along x walk the ``panels`` chunk by chunk (``nch``
    chunks of 128 bytes of K, K padded to ``kc``, a multiple of 32) through
    a ring of ``stages`` units; the weights stay ``resident`` or stream
    through the ring. ``gi``: the images a panel spans, at most."""

    tn: int
    wg_n: int
    nsplit: int
    stages: int
    resident: bool
    grid: int
    nb: int
    kc: int
    nch: int
    gi: int
    panels: int
    threads: int
    blocks_per_sm: int
    smem: int


@functools.lru_cache(maxsize=None)
def project_plan(m: int, hwo: int, ce: int, co: int, se: bool, residual: bool) -> ProjectPlan:
    """The project launch's tiles for (M, Ce) -> (M, Co), M = N * HWo:

    - warpgroups along N: one per 160 columns of Co (two at Co 192 and 320),
      Co split across blocks past 320, and in two where the 64-row panels
      do not fill the SMs (small M) and the second block would get columns;
    - ``tn``: the narrowest of ``PJ_TNS`` that covers the block's share;
    - blocks per SM: as many as the kernel's registers allow
      (``project_max_blocks``) and shared memory holds with two stages, the
      weights resident where they take at most half of a block's share and
      then fit, else streamed; the ring and the grid by ``project_fit``.

    Every plan at B0's and MobileNetV2's blocks on the H100
    (``port_block_launches.py --sweep``, PERF.md): the blocks per SM move a
    block's time up to 3.4x, streamed weights are 3-18% slower than
    resident ones at every count, and this choice sums within 1.1% of the
    fastest plan of each block. 128- and 256-row panels as well moved the
    sums by under 2% (in turns against a tree that chose them)."""
    if m <= 0 or hwo <= 0 or m % hwo or ce <= 0 or co <= 0:
        raise ValueError(f"no project plan for M {m}, HWo {hwo}, Ce {ce}, Co {co}")
    kc, nch = -(-ce // 32) * 32, -(-ce // PJ_KS)
    wg_n = -(-co // PJ_TNS[-1])
    nsplit = 1
    if wg_n > 2:
        wg_n, nsplit = 2, -(-wg_n // 2)
    if nsplit == 1 and -(-m // PJ_BM) < NUM_SMS and co > wg_n * PJ_TNS[0]:
        nsplit = 2
    tn = next((t for t in PJ_TNS if t * wg_n * nsplit >= co), None)
    if tn is None or (nsplit - 1) * wg_n * tn >= co:
        raise ValueError(f"no project plan for Co {co}")
    base = ProjectPlan(tn, wg_n, nsplit, 0, False, 0, wg_n * tn, kc, nch,
                       min(m // hwo, (PJ_BM - 1) // hwo + 2), -(-m // PJ_BM), 128 * wg_n, 0, 0)
    for bps in range(project_max_blocks(base), 0, -1):
        budget = min(DW_SMEM_LIMIT, PJ_SM_SMEM // bps - 1024)
        for resident in (True, False) if nch * base.nb * PJ_KS <= budget // 2 else (False,):
            p = project_fit(base, bps, resident, co, se, residual)
            if p is not None:
                return p
    raise ValueError(f"no project plan fits shared memory: M {m}, HWo {hwo}, Ce {ce}, Co {co}")


def project_max_blocks(p: ProjectPlan) -> int:
    """Blocks of plan ``p`` an SM's registers hold at once: the kernel is
    built for 1024 threads of 64 registers where ``tn`` <= 48, else 512 of
    128."""
    return (1024 if p.tn <= PJ_NARROW else 512) // p.threads


def project_fit(p: ProjectPlan, bps: int, resident: bool, co: int, se: bool,
                residual: bool) -> Optional[ProjectPlan]:
    """Plan ``p`` at ``bps`` blocks per SM with the weights ``resident`` or
    streamed: the ring as deep as a block's share of shared memory holds (up
    to 6 units with one chunk of K, 4 with two, 3 past; at least 2), and as
    many persistent blocks as fit at once, at most the panels; None where
    two stages do not fit."""
    budget = min(DW_SMEM_LIMIT, PJ_SM_SMEM // bps - 1024)
    smax = 6 if p.nch == 1 else 4 if p.nch == 2 else 3
    for st in range(smax, 1, -1):
        smem = project_smem(p.nb, p.nch, st, resident, p.gi, co, se, residual)
        if smem <= budget:
            return dataclasses.replace(p, stages=st, resident=resident, blocks_per_sm=bps,
                                       grid=min(p.panels, max(1, NUM_SMS * bps // p.nsplit)),
                                       smem=smem)
    return None


def _check_f32(name: str, t: torch.Tensor, shape, device) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} float32 tensor on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_weight(name: str, w: PackedInt8Weight, shape, device) -> None:
    if not isinstance(w, PackedInt8Weight) or w.shape != tuple(shape) or w.wt.device != device:
        raise ValueError(f"{name} must be a packed {tuple(shape)} int8 weight on {device}")


def fused_mbconv_block(
    x_s8: torch.Tensor,               # (N, H, W, Cin) int8 shifted quint8
    packed: Dict,                     # to_device_packed(pack_fused(...)[block])
    *,
    kernel: int,
    stride: int,
    act: str,                         # 'silu' | 'relu6'
    x_res: Optional[torch.Tensor] = None,  # (N, Ho, Wo, Co) int8 residual input
) -> torch.Tensor:
    """Run one packed MBConv block -> (N, Ho, Wo, Co) int8 in the block-out
    domain: the ops ``ievm::fused_mbconv_expand_dw``, ``..._se_gate`` (with
    SE) and ``..._project``, one per launch."""
    return _block(x_s8, packed, kernel, stride, act, x_res, _lib.call)


def _expand_dw_fake(x_s8, we_wt, we_shape, ve, wdw, vdw, sc, kernel, stride, act, se):
    n, h, w, _ = x_s8.shape
    _, ho, wo = _out_hw(h, w, kernel, stride)
    ce = wdw.shape[-1]
    return (x_s8.new_empty((n, ho, wo, ce)),
            x_s8.new_empty((n, ce) if se else (0,), dtype=torch.int32))


def _expand_dw_cuda(x_s8, we_wt, we_shape, ve, wdw, vdw, sc, kernel, stride, act, se):
    """Validate and launch kernel C's first launch on CUDA tensors."""
    if x_s8.device.type != "cuda":
        raise ValueError(f"fused_mbconv_block runs on cpu or cuda, not {x_s8.device}")
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}")
    if kernel not in (1, 3, 5) or stride not in (1, 2):
        raise ValueError(f"the kernel takes k in (1, 3, 5) and stride 1 or 2, got {kernel}, {stride}")
    dev = x_s8.device
    if x_s8.dim() != 4 or x_s8.dtype != torch.int8 or not x_s8.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, H, W, C) int8 tensor, got "
                         f"{tuple(x_s8.shape)} {x_s8.dtype}")
    n, h, w, cin = x_s8.shape
    _, ho, wo = _out_hw(h, w, kernel, stride)
    ce = wdw.shape[-1]
    we = None if we_wt is None else PackedInt8Weight(we_wt, tuple(we_shape))
    if we is not None:
        _check_weight("we", we, (cin, ce), dev)
        _check_f32("ve", ve, (2, ce), dev)
    elif cin != ce:
        raise ValueError(f"a block without expand needs Cin == Ce, got {cin} and {ce}")
    _check_f32("wdw", wdw, (kernel * kernel, ce), dev)
    _check_f32("vdw", vdw, (2, ce), dev)
    if n * max(h * w * cin, ho * wo * ce) >= 2**31:
        raise ValueError("the block's tensors exceed the kernels' int32 indexing")
    # the byte of a hidden zero in the first launch's map
    map_zp = sc[E_ZP] if we is not None else sc[ZP_S_IN] + 128.0
    if not (float(map_zp).is_integer() and 0 <= map_zp <= 255):
        raise ValueError(f"the hidden zero point must be an integer in [0, 255], got {map_zp}")
    yq = torch.empty((n, ho, wo, ce), dtype=torch.int8, device=dev)
    pool = torch.zeros((n, ce) if se else (0,), dtype=torch.int32, device=dev)
    if yq.numel() == 0:
        return yq, pool
    plan = expand_dw_plan(h, w, cin, ce, kernel, stride, we is not None)
    rc = _lib.kernel_fn("fused_mbconv_block", "ievm_fused_mbconv_expand_dw")(
        x_s8.data_ptr(), we.wt.data_ptr() if we else None, we.wt.shape[1] if we else 0,
        ve.data_ptr() if we else None, wdw.data_ptr(), vdw.data_ptr(),
        yq.data_ptr(), pool.data_ptr() if se else None,
        n, h, w, cin, ce, ho, wo, kernel, stride, _ACTS[act], plan.ct, plan.th, plan.tw,
        map_zp, sc[INV_E], sc[INV_D], sc[D_ZP], torch.cuda.current_stream(dev).cuda_stream,
    )
    _lib.check("fused_mbconv_block", rc)
    return yq, pool


def _se_gate_cuda(pool, srw, srb, sew, seb, pool_scale):
    """Validate and launch kernel C's SE-gate launch on CUDA tensors."""
    dev = pool.device
    if dev.type != "cuda":
        raise ValueError(f"fused_mbconv_block runs on cpu or cuda, not {dev}")
    n, ce = pool.shape
    if pool.dtype != torch.int32 or not pool.is_contiguous():
        raise ValueError(f"pool must be a contiguous (N, Ce) int32 tensor, got {pool.dtype}")
    se = srw.shape[-1]
    _check_f32("srw", srw, (ce, se), dev)
    _check_f32("srb", srb, (se,), dev)
    _check_f32("sew", sew, (se, ce), dev)
    _check_f32("seb", seb, (ce,), dev)
    g = torch.empty((n, ce), dtype=torch.float32, device=dev)
    if g.numel() == 0:
        return g
    group = se_gate_group(n, ce, se)
    if se > SE_MAX_SQUEEZE or se_gate_smem(group, ce, se) > DW_SMEM_LIMIT:
        raise ValueError(f"the SE gate kernel takes Se <= {SE_MAX_SQUEEZE} and its sums within "
                         f"{DW_SMEM_LIMIT} bytes, got Ce {ce}, Se {se}")
    rc = _lib.kernel_fn("fused_mbconv_block", "ievm_fused_mbconv_se_gate")(
        pool.data_ptr(), srw.data_ptr(), srb.data_ptr(), sew.data_ptr(), seb.data_ptr(),
        g.data_ptr(), n, ce, se, pool_scale, group, torch.cuda.current_stream(dev).cuda_stream,
    )
    _lib.check("fused_mbconv_block", rc)
    return g


def _project_fake(yq, g, wp_wt, wp_shape, vp, x_res, sc):
    return yq.new_empty((*yq.shape[:3], wp_shape[-1]))


def check_project_zero_points(sc, gated: bool) -> None:
    """The project kernel requantizes in the integer domain (``requant_zi``):
    o_zp, and with SE d_zp and q_zp, must be integers in [0, 255]."""
    zps = (O_ZP, D_ZP, Q_ZP) if gated else (O_ZP,)
    if not all(float(sc[i]).is_integer() and 0 <= sc[i] <= 255 for i in zps):
        raise ValueError(f"the project launch needs integer zero points in [0, 255] (o_zp, and "
                         f"d_zp and q_zp with SE), got {[sc[i] for i in zps]}")


def _project_cuda(yq, g, wp_wt, wp_shape, vp, x_res, sc):
    """Validate and launch kernel C's project launch on CUDA tensors."""
    dev = yq.device
    if dev.type != "cuda":
        raise ValueError(f"fused_mbconv_block runs on cpu or cuda, not {dev}")
    if yq.dim() != 4 or yq.dtype != torch.int8 or not yq.is_contiguous():
        raise ValueError(f"yq must be a contiguous (N, Ho, Wo, Ce) int8 tensor, got "
                         f"{tuple(yq.shape)} {yq.dtype}")
    n, ho, wo, ce = yq.shape
    wp = PackedInt8Weight(wp_wt, tuple(wp_shape))
    co = wp.n
    _check_weight("wp", wp, (ce, co), dev)
    _check_f32("vp", vp, (2, co), dev)
    if g is not None:
        _check_f32("g", g, (n, ce), dev)
    if x_res is not None and (tuple(x_res.shape) != (n, ho, wo, co) or x_res.dtype != torch.int8
                              or x_res.device != dev or not x_res.is_contiguous()):
        raise ValueError(f"x_res must be a contiguous {(n, ho, wo, co)} int8 tensor on {dev}")
    if n * ho * wo * max(ce, co) >= 2**31:
        raise ValueError("the block's tensors exceed the kernels' int32 indexing")
    if wp.wt.data_ptr() % 16 or not wp.wt.is_contiguous():
        raise ValueError("wp must be a contiguous packed weight on a 16-byte boundary")
    check_project_zero_points(sc, g is not None)
    out = torch.empty((n, ho, wo, co), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    p = project_plan(n * ho * wo, ho * wo, ce, co, g is not None, x_res is not None)
    rc = _lib.kernel_fn("fused_mbconv_block", "ievm_fused_mbconv_project")(
        yq.data_ptr(), None if g is None else g.data_ptr(), wp.wt.data_ptr(), wp.wt.shape[0],
        wp.wt.shape[1], vp.data_ptr(), None if x_res is None else x_res.data_ptr(),
        out.data_ptr(), n * ho * wo, ho * wo, ce, co,
        sc[D_ZP], sc[D_SCALE], sc[INV_Q], sc[Q_ZP], sc[RES_SCALE], sc[RES_ZP_S],
        sc[INV_O], sc[O_ZP], p.tn, p.wg_n, p.nsplit, p.stages, int(p.resident), p.grid,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _lib.check("fused_mbconv_block", rc)
    return out


_lib.custom_op("fused_mbconv_expand_dw",
               "(Tensor x, Tensor? we, int[] we_shape, Tensor? ve, Tensor wdw, Tensor vdw, "
               "float[] scal, int kernel, int stride, str act, bool se) -> (Tensor, Tensor)",
               cpu=_expand_dw_plain, cuda=_expand_dw_cuda, fake=_expand_dw_fake)
_lib.custom_op("fused_mbconv_se_gate",
               "(Tensor pool, Tensor srw, Tensor srb, Tensor sew, Tensor seb, float pool_scale) "
               "-> Tensor",
               cpu=_se_gate_plain, cuda=_se_gate_cuda,
               fake=lambda pool, srw, srb, sew, seb, pool_scale: pool.new_empty(
                   pool.shape, dtype=torch.float32))
_lib.custom_op("fused_mbconv_project",
               "(Tensor yq, Tensor? g, Tensor wp, int[] wp_shape, Tensor vp, Tensor? x_res, "
               "float[] scal) -> Tensor",
               cpu=_project_plain, cuda=_project_cuda, fake=_project_fake)
