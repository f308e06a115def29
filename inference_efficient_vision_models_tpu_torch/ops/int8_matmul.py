"""int8 x int8 -> int32 matmul with the fused affine-int8 epilogue.

Replaces the Pallas TPU kernel
``inference_efficient_vision_models_tpu/ops/int8_matmul.py:int8_matmul_requant``
with the hand-written CUDA kernel ``csrc/int8_matmul.cu`` (its header says
what bounds it on an H100 and what the design does about it; ``tile_plan``
below chooses its tiles). Same contract:

    acc   = X_s . W_q                 (int32)
    acc  -= zp_s * sum_k W_q[k, n]
    y     = acc * (s_x * s_w[n]) + b[n]
    y     = act(y)                    (none | relu | erf-GELU | tanh-GELU)
    out   = clip(round(y * (1/s_y)) + zp_y, 0, 255) - 128   or y as a float

A float ``x`` (fp32/bf16) is quantized per element first, as
``round(x / s_x) + zp``. ``int8_matmul_requant`` launches the kernel for a
CUDA tensor and runs ``int8_matmul_requant_plain`` for a CPU tensor only.

The dynamic route (``int8_matmul_requant_dynamic``, the JAX package's
``qvit._dyn_dense``) takes s_x and zp from the batch itself:
``dynamic_qparams`` reduces x to its range on the device and writes
{1/s_x, s_x, zp - 128} into a small float64 buffer that the kernel reads in
place of the scalar arguments, so a forward of dynamic layers never waits
for the host.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..compress.quant.observers import quantize_affine_shifted
from . import _lib

_ACTS = {None: 0, "relu": 1, "gelu": 2, "gelu_tanh": 3}
_X_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_OUT_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class PackedInt8Weight:
    """An int8 weight in the kernels' layout: ``wt`` is (Np, Kp), K contiguous
    for each output column, zero-padded to the tile sizes. ``shape`` is the
    JAX-layout shape it came from, (K, N) or HWIO (kh, kw, C, O)."""

    wt: torch.Tensor
    shape: Tuple[int, ...]
    # the TMA descriptor of ``wt``, encoded on first use by the kernel
    _tensor_map: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def k(self) -> int:
        return int(np.prod(self.shape[:-1]))

    @property
    def n(self) -> int:
        return self.shape[-1]

    def kn(self) -> torch.Tensor:
        """The weight as a (K, N) view of ``wt``."""
        return self.wt[: self.n, : self.k].t()

    def unpack(self) -> torch.Tensor:
        """The weight in its JAX layout."""
        return self.kn().reshape(self.shape)

    def tensor_map(self) -> int:
        """Address of the 128-byte TMA descriptor of ``wt`` (a CUDA tensor),
        encoded once: the weights are static."""
        buf = self._tensor_map.get("buf")
        if buf is None:
            buf = ctypes.create_string_buffer(128)
            rc = _lib.kernel_fn("int8_matmul_requant", "ievm_int8_weight_tensor_map")(
                self.wt.data_ptr(), self.wt.shape[0], self.wt.shape[1], ctypes.addressof(buf))
            _lib.check_call("int8_matmul_requant tensor map", rc)
            self._tensor_map["buf"] = buf
        return ctypes.addressof(buf)


def pack_weight(w_q: torch.Tensor) -> PackedInt8Weight:
    """(K, N) or (kh, kw, C, O) int8 -> PackedInt8Weight, once at load time."""
    if w_q.dtype != torch.int8:
        raise TypeError(f"weights must be int8, got {w_q.dtype}")
    w2 = w_q.reshape(-1, w_q.shape[-1])
    k, n = w2.shape
    wt = torch.zeros(_round_up(n, _lib.TILE_N), _round_up(k, _lib.TILE_K),
                     dtype=torch.int8, device=w_q.device)
    wt[:n, :k] = w2.t()
    return PackedInt8Weight(wt, tuple(w_q.shape))


WeightLike = Union[PackedInt8Weight, torch.Tensor]


def _packed(w: WeightLike) -> PackedInt8Weight:
    return w if isinstance(w, PackedInt8Weight) else pack_weight(w)


def _inv(out_scale) -> float:
    # 1/s_y in fp32, as the Pallas kernel takes it
    return float(np.float32(1.0) / np.float32(out_scale))


def _f32(v) -> float:
    return float(np.float32(v))


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 erf, the Pallas kernel's ``_erf``."""
    s = torch.sign(x)
    a = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )
    return s * (1.0 - poly * torch.exp(-a * a))


def gelu_as(y: torch.Tensor) -> torch.Tensor:
    """y * 0.5 * (1 + erf(y / sqrt(2))) with the A&S erf, in the kernels' order."""
    return y * 0.5 * (1.0 + erf_as(y * 2.0**-0.5))


def epilogue_plain(acc: torch.Tensor, *, zp_s, w_sum, in_scale, w_scale, bias,
                   act=None, out_scale=None, out_zp=None, out_dtype=torch.float32):
    """The shared epilogue on an exact float64 accumulator ``acc`` (..., N);
    ``zp_s`` and ``in_scale`` are numbers or 0-d tensors on acc's device."""
    acc = acc - zp_s * w_sum.double()
    s = in_scale.float() if isinstance(in_scale, torch.Tensor) else _f32(in_scale)
    y = acc.float() * (w_scale * s) + bias
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "gelu":
        y = gelu_as(y)
    elif act == "gelu_tanh":
        y = y * (0.5 * (1.0 + torch.tanh(0.7978845608028654 * (y + 0.044715 * (y * y * y)))))
    elif act is not None:
        raise ValueError(f"unknown act {act!r}")
    if out_scale is None:
        return y.to(out_dtype)
    q = torch.round(y * _inv(out_scale)) + float(out_zp)
    return (torch.clamp(q, 0.0, 255.0) - 128.0).to(torch.int8)


def int8_matmul_requant_plain(
    x_s: torch.Tensor, w: WeightLike, w_scale: torch.Tensor, bias: torch.Tensor,
    w_sum: torch.Tensor, *, in_scale, in_zp, relu: bool = False, act: Optional[str] = None,
    out_scale=None, out_zp=None, out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    The int32 accumulator reaches |acc| ~ 128*128*K (6.7e7 at K = 4104),
    above 2^24, so a float32 matmul would round it; float64 holds every
    partial sum of int8 products exactly (< 2^53), whatever the order."""
    if relu:
        act = "relu"
    w = _packed(w)
    if x_s.is_floating_point():
        x_s = quantize_affine_shifted(x_s, in_scale, in_zp)
    acc = x_s.double() @ w.kn().double()
    return epilogue_plain(acc, zp_s=int(in_zp) - 128, w_sum=w_sum, in_scale=in_scale,
                          w_scale=w_scale, bias=bias, act=act, out_scale=out_scale,
                          out_zp=out_zp, out_dtype=out_dtype)


def dynamic_qparams(x: torch.Tensor) -> torch.Tensor:
    """The per-batch input qparams of a dynamic int8 dense, found on x's
    device without a host sync, as the JAX ``_dyn_dense`` finds them in fp32:
    lo = min(min x, 0), hi = max(max x, 0), s = max((hi - lo) / 255, 1.2e-7),
    zp = clip(round(-lo / s), 0, 255). -> float64 (4,) {RN_f64(1 / s), s,
    zp - 128, 0}: what the kernel takes as inv_in, in_scale and zp_s."""
    lo, hi = torch.aminmax(x)  # exact in x's dtype, so in fp32 too
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    lo, hi = torch.minimum(lo.float(), zero), torch.maximum(hi.float(), zero)
    # 0-d divisors: CUDA divides by a Python scalar as a multiply by its reciprocal
    s = torch.clamp_min((hi - lo) / torch.full((), 255.0, device=x.device), 1.2e-7)
    zp = torch.clamp(torch.round(-lo / s), 0.0, 255.0)
    s64 = s.double()
    return torch.stack([torch.ones_like(s64) / s64, s64, zp.double() - 128.0,
                        torch.zeros_like(s64)])


def _check_qparams(qparams: torch.Tensor, device) -> None:
    if (qparams.shape != (4,) or qparams.dtype != torch.float64 or qparams.device != device
            or not qparams.is_contiguous()):
        raise ValueError(f"qparams must be the contiguous (4,) float64 buffer dynamic_qparams "
                         f"makes, on {device}; got {tuple(qparams.shape)} {qparams.dtype} on "
                         f"{qparams.device}")


def int8_matmul_requant_dynamic_plain(
    x: torch.Tensor, w: WeightLike, w_scale: torch.Tensor, bias: torch.Tensor,
    w_sum: torch.Tensor, qparams: torch.Tensor, *, act: Optional[str] = None,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the dynamic route, on any device, from the
    same qparams buffer: ``int8_matmul_requant_plain`` with s_x, zp as 0-d
    tensors (the same true divisions and products), so it needs no host
    sync either."""
    _check_qparams(qparams, x.device)
    s = qparams[1].float()
    zp_s = qparams[2]
    x_s = (torch.clamp(torch.round(x.float() / s) + (zp_s + 128.0).float(), 0.0, 255.0)
           - 128.0).to(torch.int8)
    acc = x_s.double() @ _packed(w).kn().double()
    return epilogue_plain(acc, zp_s=zp_s, w_sum=w_sum, in_scale=s, w_scale=w_scale, bias=bias,
                          act=act, out_dtype=out_dtype)


# --------------------------------------------------------------------------
# the kernel's tile plan (csrc/int8_matmul.cu checks it and lays out its
# shared memory by the same formula as smem_bytes)
# --------------------------------------------------------------------------

NUM_SMS = 132            # H100 SXM
SMEM_LIMIT = 232_448     # shared memory one block may take (227 KB)
PANEL_ROWS = 128         # rows of A a block owns
K_CHUNK = 128            # K bytes per ring stage and per panel chunk
MAX_STAGES = 6
_OUT_BYTES = {0: 1, 1: 4, 2: 2}


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the kernel cuts (M, K) x (K, N): ``mblocks`` slices of
    ``PANEL_ROWS`` rows, N tiles of width ``bn`` in ``groups`` groups of
    ``tiles_per_group``; the grid is (``grid_m``, ``groups``) and a block
    takes every ``grid_m``-th slice. Weight tiles stream through a ring of
    ``stages``; the A panel holds ``window`` of the ``nchunks`` 128-byte K
    chunks (``window < nchunks``: A is reloaded in windows for each tile)."""

    bn: int
    tiles: int
    groups: int
    tiles_per_group: int
    mblocks: int
    grid_m: int
    nchunks: int
    stages: int
    window: int
    smem: int

    @property
    def stream(self) -> bool:
        return self.window < self.nchunks


def smem_bytes(bn: int, stages: int, window: int, out_kind: int, group_cols: int,
               staged_y: bool = True) -> int:
    """Dynamic shared memory of one block: panel, ring, the two warpgroups'
    staged 64-column output slices (fp32 rows of 288 bytes, and for an int8
    or bf16 output the converted rows; only the output rows where the kernel
    converts in registers, ``staged_y`` false), the group's epilogue vectors
    (scale, bias, zero-point correction), mbarriers and 1024 bytes of
    alignment slack (csrc/panel_gemm.cuh ``Layout``)."""
    e = _OUT_BYTES[out_kind]
    out_rows = 64 * (64 * e + (32 if e == 4 else 16))
    staged = (64 * 288 + (0 if e == 4 else out_rows)) if staged_y else out_rows
    return (window * PANEL_ROWS * K_CHUNK + stages * bn * K_CHUNK + 2 * staged
            + 12 * group_cols + 2 * MAX_STAGES * 8 + 1024)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


MAX_GROUP_COLS = 1280    # epilogue vectors a block keeps (15 KB)


def tile_plan(m: int, k: int, n: int, out_kind: int, act: int = 0,
              sms: int = NUM_SMS, staged_y: bool = True) -> TilePlan:
    """The tiles for out (m, n) = act(X (m, k) . W (k, n)):

    - ``bn``: of the wgmma widths 64..256 (64..192 under a GELU, whose
      epilogue needs the registers a 256-wide accumulator takes) that give at
      least one (slice, N tile) pair per SM, the one that pads N least (the
      widest on a tie); 64 when none does (small M: the most blocks);
    - N groups: as few as fill the SMs (one whenever M has >= 132 slices), so
      a float input is quantized once per group, and no group wider than
      ``MAX_GROUP_COLS``;
    - persistent blocks: one per SM along M when there is one group;
    - the whole A panel if it fits beside a ring of 6, 4, 3 or 2 stages (at
      ``bn`` 64 within half the SM's shared memory if it can, for two blocks
      per SM), else a ring of 3 and A in windows of as many chunks as fit
      (``staged_y``: the staging layout, ``smem_bytes``)."""
    mblocks = _cdiv(m, PANEL_ROWS)
    widest = 192 if act >= _ACTS["gelu"] else 256
    widths = sorted(range(64, widest + 1, 64), key=lambda b: (_cdiv(n, b) * b, -b))
    bn = next((b for b in widths if mblocks * _cdiv(n, b) >= sms), 64)
    tiles = _cdiv(n, bn)
    per = min(_cdiv(tiles, min(tiles, _cdiv(sms, mblocks))), MAX_GROUP_COLS // bn)
    groups = _cdiv(tiles, per)
    grid_m = min(mblocks, sms) if groups == 1 else mblocks
    nchunks = _cdiv(k, K_CHUNK)
    cols = per * bn
    for limit in ((SMEM_LIMIT // 2, SMEM_LIMIT) if bn == 64 else (SMEM_LIMIT,)):
        for stages in (6, 4, 3, 2):
            smem = smem_bytes(bn, stages, nchunks, out_kind, cols, staged_y)
            if smem <= limit:
                if limit < SMEM_LIMIT and groups == 1:
                    grid_m = min(mblocks, 2 * sms)
                return TilePlan(bn, tiles, groups, per, mblocks, grid_m, nchunks, stages, nchunks,
                                smem)
    stages = 3
    window = (SMEM_LIMIT - smem_bytes(bn, stages, 0, out_kind, cols, staged_y)) // (
        PANEL_ROWS * K_CHUNK)
    return TilePlan(bn, tiles, groups, per, mblocks, grid_m, nchunks, stages, window,
                    smem_bytes(bn, stages, window, out_kind, cols, staged_y))


def _check_vec(name: str, t: torch.Tensor, n: int, dtype, device) -> None:
    if t.shape != (n,) or t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) {dtype} tensor on {device}, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def int8_matmul_requant(
    x_s: torch.Tensor,        # (M, K) int8 shifted activations, or fp32/bf16
    w: WeightLike,            # (K, N) int8, or pack_weight() of it
    w_scale: torch.Tensor,    # (N,) f32
    bias: torch.Tensor,       # (N,) f32
    w_sum: torch.Tensor,      # (N,) i32, sum over K of w
    *,
    in_scale,
    in_zp,                    # unshifted quint8 zero point [0, 255]
    relu: bool = False,
    act: Optional[str] = None,  # None | 'relu' | 'gelu' | 'gelu_tanh'
    out_scale=None,           # None -> float output of out_dtype
    out_zp=None,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Fused quantized dense layer -> (M, N) int8 (requantized) or float."""
    return _launch(x_s, w, w_scale, bias, w_sum, in_scale=in_scale, in_zp=in_zp, relu=relu,
                   act=act, out_scale=out_scale, out_zp=out_zp, out_dtype=out_dtype)


def int8_matmul_requant_dynamic(
    x: torch.Tensor,          # (M, K) fp32/bf16 activations
    w: WeightLike,
    w_scale: torch.Tensor,
    bias: torch.Tensor,
    w_sum: torch.Tensor,
    qparams: torch.Tensor,    # dynamic_qparams(x), on x's device
    *,
    act: Optional[str] = None,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """The dynamic route: the kernel reads s_x and zp from ``qparams`` on the
    device; a float output. A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return int8_matmul_requant_dynamic_plain(x, w, w_scale, bias, w_sum, qparams, act=act,
                                                 out_dtype=out_dtype)
    if not x.is_floating_point():
        raise ValueError(f"the dynamic route quantizes a float input, got {x.dtype}")
    _check_qparams(qparams, x.device)
    return _launch(x, w, w_scale, bias, w_sum, in_scale=1.0, in_zp=128, act=act,
                   out_dtype=out_dtype, qparams=qparams)


def _launch(x_s, w, w_scale, bias, w_sum, *, in_scale, in_zp, relu=False, act=None,
            out_scale=None, out_zp=None, out_dtype=torch.float32, qparams=None):
    if x_s.device.type == "cpu":
        return int8_matmul_requant_plain(
            x_s, w, w_scale, bias, w_sum, in_scale=in_scale, in_zp=in_zp, relu=relu,
            act=act, out_scale=out_scale, out_zp=out_zp, out_dtype=out_dtype)
    if x_s.device.type != "cuda":
        raise ValueError(f"int8_matmul_requant runs on cpu or cuda, not {x_s.device}")
    if relu:
        act = "relu"
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}")
    w = _packed(w)
    dev = x_s.device
    if x_s.dim() != 2 or x_s.dtype not in _X_KINDS or not x_s.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D int8/fp32/bf16 tensor, got "
                         f"{tuple(x_s.shape)} {x_s.dtype}")
    m, k = x_s.shape
    if m >= 2**31:
        raise ValueError(f"M = {m} rows exceed the kernel's int32 indexing")
    if k != w.k or w.wt.device != dev:
        raise ValueError(f"x (M, {k}) on {dev} does not fit weights {w.shape} on {w.wt.device}")
    n = w.n
    _check_vec("w_scale", w_scale, n, torch.float32, dev)
    _check_vec("bias", bias, n, torch.float32, dev)
    _check_vec("w_sum", w_sum, n, torch.int32, dev)
    requant = out_scale is not None
    out_t = torch.int8 if requant else out_dtype
    if out_t not in _OUT_KINDS:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    out = torch.empty((m, n), dtype=out_t, device=dev)
    if m == 0:
        return out
    p = tile_plan(m, k, n, _OUT_KINDS[out_t], _ACTS[act])
    rc = _lib.kernel_fn("int8_matmul_requant", "ievm_int8_matmul_requant")(
        x_s.data_ptr(), _X_KINDS[x_s.dtype], w.tensor_map(),
        w_scale.data_ptr(), bias.data_ptr(), w_sum.data_ptr(), out.data_ptr(),
        _OUT_KINDS[out_t], _ACTS[act], m, k, n, int(in_zp) - 128,
        int(out_zp) if requant else 0, _f32(in_scale), _inv(out_scale) if requant else 1.0,
        1.0 / _f32(in_scale), p.bn, p.grid_m, p.groups, p.tiles_per_group, p.stages, p.window,
        None if qparams is None else qparams.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _lib.check("int8_matmul_requant", rc)
    return out
