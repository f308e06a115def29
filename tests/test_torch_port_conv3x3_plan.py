"""Kernel B (``csrc/conv3x3.cu``) around the CUDA code, on the CPU.

- ``ops/conv3x3.py:conv3x3_plan``, the tiles the kernel takes, at the 13
  calls of a batch-256 ResNet18 forward and at the odd shapes
  ``chip_smoke.py`` drives: widths ``.s8`` wgmma takes, shared memory within
  227 KB, every (slice, N tile) computed once, the panel whole or in the
  widest window that fits.
- A replay in torch of the conv panel loader (``conv_panel``): which thread
  writes which bytes of the 128-byte-swizzled panel, the tap and channel of
  each piece, the zero-point halo and the zero padding past K, equal to the
  plain version's patches at all nine border classes and for every load width.
- The residual epilogue's plain version against the executor's unfused
  sequence (``_conv_q`` + ``dequantize_affine_shifted`` + ``_requant``), bit
  for bit, and one basic block of random int8 weights (both identity kinds)
  against the JAX package's block as its ``apply_int8`` computes it, Pallas
  kernels in interpret mode (the whole model against the JAX package is
  ``tests/test_torch_port_qresnet.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ARTIFACT, B_ODD_SHAPES, main_path_calls
from inference_efficient_vision_models_tpu.compress.quant import qresnet as jq
from inference_efficient_vision_models_tpu.compress.quant.observers import (
    dequantize_affine_shifted as j_dequant,
)
from inference_efficient_vision_models_tpu_torch.compress.quant import qresnet as tq
from inference_efficient_vision_models_tpu_torch.compress.quant.observers import (
    dequantize_affine_shifted,
)
from inference_efficient_vision_models_tpu_torch.ops import _lib
from inference_efficient_vision_models_tpu_torch.ops.conv3x3 import (
    conv3x3_plan,
    conv3x3_s1_int8,
    conv3x3_s1_int8_plain,
)
from inference_efficient_vision_models_tpu_torch.ops.im2col import extract_patches_nhwc
from inference_efficient_vision_models_tpu_torch.ops.int8_matmul import (
    K_CHUNK,
    NUM_SMS,
    PANEL_ROWS,
    SMEM_LIMIT,
    smem_bytes,
)

# N of wgmma.mma_async m64nNk32 with .s8 operands (PTX ISA): 8, 16, 24, 32,
# then multiples of 16 up to 256. The kernel is built for 64, 128, 192, 256.
WGMMA_S8_N = {8, 16, 24} | set(range(32, 257, 16))
BUILT_N = (64, 128, 192, 256)


def served_conv3x3_calls():
    """(label, (nb, h, w, c), o, out_kind, residual) of the 13 kernel-B calls
    of one batch-256 forward of the committed ResNet18."""
    model = tq.load_static_int8(ARTIFACT, device="cpu")
    return [(label, tuple(shape), leaf["w"].n, 0 if kw.get("out_scale") is not None else 1,
             kw.get("residual") is not None)
            for kernel, label, shape, _, leaf, kw in main_path_calls(model, 256)
            if kernel == "conv3x3_s1_int8"]


def check_plan(nb, h, w, c, o, out_kind, residual):
    p = conv3x3_plan(nb, h, w, c, o, out_kind, residual)
    m, k = nb * h * w, 9 * c
    assert p.bn in BUILT_N and p.bn in WGMMA_S8_N
    assert p.smem == smem_bytes(p.bn, p.stages, p.window, out_kind, p.tiles_per_group * p.bn,
                                staged_y=False)
    assert p.smem <= SMEM_LIMIT == 227 * 1024
    assert p.nchunks == -(-k // K_CHUNK) and 1 <= p.window <= p.nchunks
    if p.window < p.nchunks:  # streamed: the widest window beside a ring of 3
        assert p.stages == 3
        assert smem_bytes(p.bn, 3, p.window + 1, out_kind, p.tiles_per_group * p.bn,
                          staged_y=False) > SMEM_LIMIT
    assert p.tiles == -(-o // p.bn) and (p.tiles - 1) * p.bn < o
    assert p.groups * p.tiles_per_group >= p.tiles > (p.groups - 1) * p.tiles_per_group
    assert p.mblocks == -(-m // PANEL_ROWS) and 1 <= p.grid_m <= p.mblocks
    if p.groups == 1:  # two blocks per SM only for the 64-wide tile, and only where they fit
        pair = p.bn == 64 and 2 * p.smem <= SMEM_LIMIT
        assert p.grid_m == min(p.mblocks, (2 if pair else 1) * NUM_SMS)
    seen = {}
    for bx in range(p.grid_m):
        for mb in range(bx, p.mblocks, p.grid_m):
            for g in range(p.groups):
                for t in range(g * p.tiles_per_group, min((g + 1) * p.tiles_per_group, p.tiles)):
                    seen[mb, t] = seen.get((mb, t), 0) + 1
    assert len(seen) == p.mblocks * p.tiles and set(seen.values()) == {1}
    return p


def test_served_calls_have_a_valid_plan():
    calls = served_conv3x3_calls()
    assert len(calls) == 13
    assert sum(r for *_, r in calls) == 8  # every block's conv2 ends it
    plans = {}
    for label, (nb, h, w, c), o, out_kind, residual in calls:
        assert out_kind == 0
        plans[(c, o)] = check_plan(nb, h, w, c, o, out_kind, residual)
    assert sorted(plans) == [(56, 56), (112, 112), (224, 224), (456, 456)]
    # the 64-wide tile for O = 56; 112 -> 128; 224 -> 256; 456 in two tiles of 256
    assert [plans[c, c].bn for c in (56, 112, 224, 456)] == [64, 128, 256, 256]
    assert plans[456, 456].tiles == 2
    # the panels of stages 1-2 fit whole; stages 3-4 (K 2016, 4104) stream in windows
    assert [plans[c, c].window == plans[c, c].nchunks for c in (56, 112, 224, 456)] == \
        [True, True, False, False]
    # stage 4 has 98 slices of 128 rows for 132 SMs: its two N tiles go to two groups
    assert plans[456, 456].mblocks == 98 and plans[456, 456].groups == 2
    assert plans[56, 56].groups == plans[112, 112].groups == plans[224, 224].groups == 1


@pytest.mark.parametrize("shape", B_ODD_SHAPES)
@pytest.mark.parametrize("out_kind,residual", [(0, False), (1, False), (0, True)])
def test_odd_shapes_have_a_valid_plan(shape, out_kind, residual):
    check_plan(*shape, out_kind, residual)


def test_residual_plan_writes_int8():
    with pytest.raises(ValueError):
        conv3x3_plan(2, 5, 6, 8, 8, 1, residual=True)


# --------------------------------------------------------------------------
# the panel loader, replayed
# --------------------------------------------------------------------------


def swz128(r, kb):
    """sm90.cuh swz128: byte offset of (row r, K byte kb) in a swizzled tile."""
    return r * 128 + ((((kb >> 4) ^ r) & 7) << 4) + (kb & 15)


def conv_panel_replay(x: torch.Tensor, zp_s: int, m0w: int, c0: int, nc: int, v: int):
    """What csrc/conv3x3.cu conv_panel<v> writes for a warpgroup's rows
    m0w..m0w+63, K chunks [c0, c0 + nc): per chunk the 64 x 128 swizzled
    bytes, as uint8, and how often each byte was written. Thread lt fills
    K bytes 16 (lt % 8)..+15 of rows lt / 8 + 16 j, in 16 / v pieces of v
    bytes read at the flat offset ((dy W + dx) C + ch) from the pixel's
    channel 0, the tap and channel taken once per piece and chunk."""
    nb, h, w, c = x.shape
    m_all, k_all = nb * h * w, 9 * c
    flat = x.reshape(-1).view(torch.uint8)
    zb = zp_s & 0xFF
    chunks = np.zeros((nc, 64 * 128), np.uint8)
    writes = np.zeros((nc, 64 * 128), np.int64)
    for lt in range(128):
        kb = (lt & 7) * 16
        for j in range(4):
            r = (lt >> 3) + 16 * j
            m = m0w + r
            ok = m < m_all
            rem = m % (h * w)
            ph = rem // w if ok else -2
            pw = rem - (rem // w) * w
            base = (m if ok else 0) * c
            for cc in range(nc):
                k0 = (c0 + cc) * K_CHUNK + kb
                piece = []
                for p in range(16 // v):
                    k = k0 + p * v
                    tap = k // c
                    ch = k - tap * c
                    dy, dx = tap // 3 - 1, tap % 3 - 1
                    kin = k < k_all
                    inside = kin and 0 <= ph + dy < h and 0 <= pw + dx < w
                    if inside:
                        off = base + (dy * w + dx) * c + ch
                        piece += flat[off : off + v].tolist()
                    else:
                        piece += [zb if kin else 0] * v
                at = swz128(r, kb)
                chunks[cc, at : at + 16] = piece
                writes[cc, at : at + 16] += 1
    return chunks, writes


def unswizzle(chunk: np.ndarray) -> np.ndarray:
    """(64 * 128,) swizzled bytes -> (64, 128) rows."""
    out = np.zeros((64, 128), np.uint8)
    for r in range(64):
        for kb in range(0, 128, 16):
            out[r, kb : kb + 16] = chunk[swz128(r, kb) : swz128(r, kb) + 16]
    return out


def plain_patch_rows(x: torch.Tensor, zp_s: int, m0w: int, nchunks: int) -> np.ndarray:
    """Rows m0w..m0w+63 of the plain version's patches (padded with zp_s, K
    in tap-then-channel order), zero-padded to nchunks * 128 bytes."""
    nb, h, w, c = x.shape
    pt = extract_patches_nhwc(x, 3, 3, 1, 1, zp_s)[0].reshape(nb * h * w, 9 * c)
    rows = np.zeros((64, nchunks * K_CHUNK), np.uint8)
    sel = pt[m0w : m0w + 64].view(torch.uint8).numpy()
    rows[: len(sel), : 9 * c] = sel
    return rows, len(sel)


@pytest.mark.parametrize("c,v", [(56, 8), (112, 16), (16, 16), (40, 8), (12, 4), (3, 1),
                                 (56, 4), (112, 1)])
def test_conv_panel_replay_equals_plain_patches(c, v):
    """Every byte of the panel written once, and equal to the plain
    patches at every border class: a 5 x 6 image has corners, edges and
    inner pixels; rows of 64 starting at 0 and at 64 - 7 cover the second
    image and the rows past M (which are never stored)."""
    rng = np.random.default_rng(c * 10 + v)
    nb, h, w = 3, 5, 6
    x = torch.from_numpy(rng.integers(-128, 128, (nb, h, w, c), dtype=np.int8))
    zp_s = int(rng.integers(-100, 100))
    nchunks = -(-9 * c // K_CHUNK)
    classes = set()
    for m0w in (0, nb * h * w - 57):
        chunks, writes = conv_panel_replay(x, zp_s, m0w, 0, nchunks, v)
        assert (writes == 1).all()
        got = np.concatenate([unswizzle(ch) for ch in chunks], axis=1)
        ref, valid = plain_patch_rows(x, zp_s, m0w, nchunks)
        np.testing.assert_array_equal(got[:valid], ref[:valid])
        for m in range(m0w, m0w + valid):
            hh, ww = (m % (h * w)) // w, m % w
            classes.add((min(hh, 1) + (hh == h - 1), min(ww, 1) + (ww == w - 1)))
    assert len(classes) == 9


def test_conv_panel_windows_equal_the_whole_panel():
    """A K streamed in windows (stages 3 and 4) loads the same bytes as the
    whole panel: chunks [c0, c0 + nc) are the whole panel's."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-128, 128, (1, 4, 5, 40), dtype=np.int8))
    whole, _ = conv_panel_replay(x, 7, 0, 0, 3, 8)
    part, _ = conv_panel_replay(x, 7, 0, 1, 2, 8)
    np.testing.assert_array_equal(part, whole[1:])


# --------------------------------------------------------------------------
# the residual epilogue, and one basic block against the JAX package
# --------------------------------------------------------------------------


def _leaf(rng, c, o, kh=3):
    w_q = rng.integers(-128, 128, (kh, kh, c, o), dtype=np.int8)
    return {"w_q": w_q, "w_scale": rng.uniform(0.001, 0.004, o).astype(np.float32),
            "bias": rng.standard_normal(o).astype(np.float32),
            "w_sum": w_q.astype(np.int32).sum(axis=(0, 1, 2)),
            "out_scale": np.float32(0.08), "out_zp": np.int32(rng.integers(90, 130))}


def _block(rng, cin, cout, down):
    blk = {"conv1": _leaf(rng, cin, cout), "conv2": _leaf(rng, cout, cout),
           "out_scale": np.float32(0.1), "out_zp": np.int32(60)}
    if down:
        blk["down"] = _leaf(rng, cin, cout, kh=1)
    return blk


def _port_block(blk):
    leaves = {k: tq._conv_leaf(v, torch.device("cpu")) for k, v in blk.items()
              if isinstance(v, dict)}
    return {**leaves, "out_scale": float(blk["out_scale"]), "out_zp": int(blk["out_zp"])}


@pytest.mark.parametrize("down", [False, True])
def test_residual_plain_equals_unfused_sequence(down):
    """conv3x3_s1_int8_plain(residual=...) is the executor's old sequence,
    bit for bit: fp32 conv2, + identity, ReLU, requant by division."""
    rng = np.random.default_rng(11 + down)
    blk = _port_block(_block(rng, 24, 24, down))
    x_in = torch.from_numpy(rng.integers(-128, 128, (2, 9, 10, 24), dtype=np.int8))
    in_s, in_z = 0.07, 121
    a_q = tq._conv_q(x_in, in_z, in_s, blk["conv1"], 1, 1, relu=True, requant=True,
                     impl="plain")
    c1, c2 = blk["conv1"], blk["conv2"]
    h = tq._conv_q(a_q, c1["out_zp"], c1["out_scale"], c2, 1, 1, relu=False, requant=False,
                   impl="plain")
    if down:
        identity = tq._conv_q(x_in, in_z, in_s, blk["down"], 1, 0, relu=False, requant=False,
                              impl="plain")
        residual = identity
    else:
        identity = dequantize_affine_shifted(x_in, in_s, in_z)
        residual = ("int8", x_in, in_s, in_z)
    ref = tq._requant(torch.relu(h + identity), blk["out_scale"], blk["out_zp"])
    args = (a_q, c2["w"], c2["w_scale"], c2["bias"], c2["w_sum"])
    kw = dict(in_scale=c1["out_scale"], in_zp=c1["out_zp"], residual=residual,
              out_scale=blk["out_scale"], out_zp=blk["out_zp"])
    before = _lib.launches["conv3x3_s1_int8"]
    got = conv3x3_s1_int8_plain(*args, **kw)
    assert _lib.launches["conv3x3_s1_int8"] == before
    assert got.dtype == torch.int8 and torch.equal(got, ref)
    assert torch.equal(conv3x3_s1_int8(*args, **kw), ref)  # a CPU tensor takes the plain version
    assert torch.equal(tq.basic_block(blk, x_in, in_s, in_z, 1, impl="plain"), ref)
    assert len(set(ref.flatten().tolist())) > 20  # mid-range, not clipped


def test_residual_is_refused_where_the_kernel_cannot_take_it():
    rng = np.random.default_rng(3)
    c = _port_block(_block(rng, 8, 8, False))["conv2"]
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    args = (x, c["w"], c["w_scale"], c["bias"], c["w_sum"])
    ident = ("int8", x, 0.1, 128)
    for kw in (dict(residual=ident), dict(residual=ident, relu=True, out_scale=0.1, out_zp=3),
               dict(residual=("fp32", x, 0.1, 128), out_scale=0.1, out_zp=3)):
        with pytest.raises(ValueError):
            conv3x3_s1_int8_plain(*args, in_scale=0.1, in_zp=128, **kw)


def _jax_block(blk, x_in, in_s, in_z, stride):
    """The JAX package's basic block as its apply_int8 computes it, with the
    Pallas kernels (3x3 stride-1 direct, im2col + int8 matmul) in interpret mode."""
    kw = dict(impl="pallas", interpret=True)
    q = {k: ({n: jnp.asarray(a) for n, a in v.items()} if isinstance(v, dict) else jnp.asarray(v))
         for k, v in blk.items()}
    x = jnp.asarray(x_in)
    in_s, in_z = jnp.float32(in_s), jnp.int32(in_z)
    a_q = jq._conv_q(x, in_z, in_s, q["conv1"], stride, 1, relu=True, requant=True, **kw)
    h = jq._conv_q(a_q, q["conv1"]["out_zp"], q["conv1"]["out_scale"], q["conv2"], 1, 1,
                   relu=False, requant=False, **kw)
    if "down" in q:
        identity = jq._conv_q(x, in_z, in_s, q["down"], stride, 0, relu=False, requant=False,
                              **kw)
    else:
        identity = j_dequant(x, in_s, in_z)
    return np.asarray(jq._requant(jax.nn.relu(h + identity), q["out_scale"], q["out_zp"]))


@pytest.mark.parametrize("cin,cout,stride,down", [(16, 16, 1, False), (16, 24, 2, True)])
def test_basic_block_matches_jax(cin, cout, stride, down):
    """One basic block (random int8 weights, qparams that keep every
    requant mid-range) through the port's basic_block and the JAX package's
    block: the int8 outputs agree within one quantum, >= 99% exactly (the
    port's conv1 requantizes through 1/s as the Pallas kernels do)."""
    rng = np.random.default_rng(cin + cout)
    blk = _block(rng, cin, cout, down)
    x_in = rng.integers(-128, 128, (2, 8, 8, cin), dtype=np.int8)
    in_s, in_z = 0.07, 121
    ref = _jax_block(blk, x_in, in_s, in_z, stride)
    got = tq.basic_block(_port_block(blk), torch.from_numpy(x_in), in_s, in_z, stride,
                         impl="plain").numpy()
    assert got.shape == ref.shape == (2, 8 // stride, 8 // stride, cout)
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99
    assert len(np.unique(ref)) > 20

