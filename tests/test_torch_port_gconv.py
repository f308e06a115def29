"""Kernel F (``ops/gconv_int8.py``, ``csrc/gconv_int8.cu``) on the CPU.

- ``grouped_conv_int8_plain`` against the JAX package's grouped branch run
  op by op (``qresnet._qconv_int8(groups=G)`` + ``_epilogue`` +
  ``_requant``): EQUAL, over Cg 1..32 (not a multiple of 4 among them),
  groups 2..32, stride 1 and 2, odd H and W, zero points 0, 128 and 255,
  and the requant at rint's ties (zero weights, the bias on and beside
  half-integer quotients).
- ``gconv_plan`` at resnext26_32x4d's and resnext50_32x4d's grouped calls
  (224x224, batch 256 and 1), at pruned widths and at ``chip_smoke.py``'s
  odd shapes: every output covered exactly once, shared memory within 227
  KB, legal copy widths, two waves of blocks at batch 256.
- A numpy replay of the kernel's data path: the packed weight words staged
  at the padded group stride, the tile staged as its loader does (the halo
  and the pad channels at zp_s, a group spread over Cg4 bytes for byte
  copies), the items each thread walks (the mixed-radix stepping against a
  division), dp4a over words of 4 input channels, and the epilogue's float
  steps (the int-to-float of the sum less zp_s * w_sum, the product and sum
  rounded apart, the ReLU, the quotient as a double product with RN(1/s),
  rint and clip by magic constants), equal to the plain version's output
  at every border class, slab and tile arrangement.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GC_ODD_SHAPES
from inference_efficient_vision_models_tpu.compress.quant import qresnet as jq
from inference_efficient_vision_models_tpu_torch.ops import gconv_int8 as tg
from inference_efficient_vision_models_tpu_torch.ops.dwconv_int8 import NUM_SMS

BATCH = 256


def case(rng, n, h, w, groups, cg, *, ties=False, out_scale=0.051):
    c = groups * cg
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    wq = rng.integers(-127, 128, (3, 3, cg, c), dtype=np.int8)
    w_scale = (rng.random(c) * 0.02 + 0.002).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.5).astype(np.float32)
    if ties:  # y = relu(bias) alone: quotients on and beside rint's ties
        wq[:] = 0
        half = (np.arange(c) % 7 + 0.5).astype(np.float32) * np.float32(out_scale)
        bias = np.stack([half, np.nextafter(half, np.float32(np.inf)),
                         np.nextafter(half, np.float32(-np.inf))])[np.arange(c) % 3,
                                                                   np.arange(c)]
        bias = bias.astype(np.float32)
    return x, wq, w_scale, bias


def jax_grouped(x, wq, w_scale, bias, groups, stride, in_zp, in_scale, out_scale, out_zp):
    """The JAX package's grouped branch of ``qresnet._conv_q``, op by op."""
    qc = {"w_q": jnp.asarray(wq), "w_scale": jnp.asarray(w_scale), "bias": jnp.asarray(bias),
          "w_sum": jnp.asarray(wq.sum(axis=(0, 1, 2), dtype=np.int32))}
    acc = jq._qconv_int8(jnp.asarray(x), jnp.int32(in_zp), qc, stride, 1, groups)
    y = jq._epilogue(acc, in_scale, qc, relu=True)
    return np.asarray(jq._requant(y, out_scale, out_zp))


def port_grouped(x, wq, w_scale, bias, groups, stride, in_zp, in_scale, out_scale, out_zp):
    w = tg.pack_grouped_weight(torch.from_numpy(wq), groups)
    return tg.grouped_conv_int8(
        torch.from_numpy(x), w, torch.from_numpy(w_scale), torch.from_numpy(bias),
        torch.from_numpy(wq.sum(axis=(0, 1, 2), dtype=np.int32)), stride=stride,
        in_scale=in_scale, in_zp=in_zp, out_scale=out_scale, out_zp=out_zp).numpy()


# (N, H, W, groups, Cg, stride)
JAX_SHAPES = [(2, 9, 11, 4, 4, 1), (2, 9, 11, 4, 4, 2), (1, 8, 7, 32, 1, 1), (2, 7, 9, 2, 3, 2),
              (1, 10, 5, 3, 5, 1), (2, 6, 6, 2, 14, 2), (1, 5, 7, 32, 8, 2), (1, 4, 4, 4, 32, 1)]


@pytest.mark.parametrize("n,h,w,groups,cg,stride", JAX_SHAPES)
@pytest.mark.parametrize("in_zp,out_zp", [(0, 255), (128, 128), (255, 0)])
def test_plain_equals_jax(n, h, w, groups, cg, stride, in_zp, out_zp):
    rng = np.random.default_rng(7 * h + 3 * cg + groups + in_zp)
    x, wq, w_scale, bias = case(rng, n, h, w, groups, cg)
    args = (x, wq, w_scale, bias, groups, stride, in_zp, np.float32(0.037),
            np.float32(0.051), np.int32(out_zp))
    got, ref = port_grouped(*args), jax_grouped(*args)
    assert got.dtype == np.int8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cg", [3, 4])
@pytest.mark.parametrize("out_scale", [0.05, 0.0123])
def test_plain_equals_jax_at_requant_ties(cg, out_scale):
    rng = np.random.default_rng(cg)
    x, wq, w_scale, bias = case(rng, 2, 5, 6, 8, cg, ties=True, out_scale=out_scale)
    args = (x, wq, w_scale, bias, 8, 1, 150, np.float32(0.03), np.float32(out_scale),
            np.int32(3))
    got, ref = port_grouped(*args), jax_grouped(*args)
    np.testing.assert_array_equal(got, ref)
    # the ties are real: rounding half away from zero would differ somewhere
    q = bias.astype(np.float64) / np.float32(out_scale)
    assert (np.abs(q - np.floor(q) - 0.5) == 0).any()


def test_packed_words_hold_the_weights():
    """Word (g, tap, i, co), byte k: w[tap, 4 i + k, g Cg + co], zero past Cg."""
    rng = np.random.default_rng(0)
    for groups, cg in ((4, 3), (2, 8), (3, 5)):
        wq = rng.integers(-127, 128, (3, 3, cg, groups * cg), dtype=np.int8)
        w = tg.pack_grouped_weight(torch.from_numpy(wq), groups)
        cg4 = -(-cg // 4) * 4
        b = w.words.numpy().view(np.int8).reshape(groups, 9, cg4 // 4, cg4, 4)
        for g in range(groups):
            for t in range(9):
                for ci in range(cg4):
                    for co in range(cg4):
                        want = wq[t // 3, t % 3, ci, g * cg + co] if ci < cg and co < cg else 0
                        assert b[g, t, ci // 4, co, ci % 4] == want
        assert tuple(w.hwio.shape) == wq.shape and w.cg == cg and w.n == groups * cg


def test_wrapper_refuses_other_routes():
    rng = np.random.default_rng(1)
    x, wq, w_scale, bias = case(rng, 1, 4, 4, 2, 4)
    w = tg.pack_grouped_weight(torch.from_numpy(wq), 2)
    v = (torch.from_numpy(w_scale), torch.from_numpy(bias),
         torch.from_numpy(wq.sum(axis=(0, 1, 2), dtype=np.int32)))
    kw = dict(stride=1, in_scale=1.0, in_zp=128, out_scale=1.0, out_zp=0)
    with pytest.raises(NotImplementedError):
        tg.grouped_conv_int8(torch.from_numpy(x), w, *v, relu=False, **kw)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        tg.grouped_conv_int8(torch.from_numpy(x).to("meta"), w, *v, **kw)
    with pytest.raises(ValueError):
        tg.pack_grouped_weight(torch.from_numpy(wq), 3)


# --------------------------------------------------------------------------
# the tile plan
# --------------------------------------------------------------------------


def resnext_calls(name, b=BATCH):
    """(N, H, W, C, groups, stride) of a ResNeXt's grouped calls at 224x224."""
    from inference_efficient_vision_models_tpu_torch.models.registry import make_spec

    spec = make_spec(name, 6)
    h, out = 56, []
    for s, depth in enumerate(spec.depths):
        for bi in range(depth):
            stride = spec.block_stride(s, bi)
            out.append((b, h, h, spec.inner_widths[s][bi][1], spec.groups, stride))
            h = (h - 1) // stride + 1
    return out


def coverage(p):
    """How often the blocks of plan p write each output, as factors: the
    (image, band) tiles, the rows of each image (bands less past Ho), x
    (runs x GC_P less past Wo) and channels (slabs x groups x Cg, less past
    G); every output is written once exactly when every factor is 1."""
    tiles = p.n * p.bands
    tile_hits = np.zeros(tiles, np.int64)
    for bx in range(p.grid[0]):
        tile_hits[bx * p.nb : min(bx * p.nb + p.nb, tiles)] += 1
    rows = np.zeros((p.n, p.ho), np.int64)
    for band in range(p.bands):
        oy = band * p.bh + np.arange(p.bh)
        rows[:, oy[oy < p.ho]] += tile_hits.reshape(p.n, p.bands)[:, band : band + 1]
    xs = np.zeros(p.wo, np.int64)
    ox = np.arange(-(-p.wo // tg.GC_P) * tg.GC_P)
    np.add.at(xs, ox[ox < p.wo], 1)
    groups = np.zeros(p.groups, np.int64)
    gg = np.arange(p.slabs * p.gs)
    np.add.at(groups, gg[gg < p.groups], 1)
    return tile_hits, rows, xs, groups


def check_plan(n, h, w, c, groups, stride, *, waves=False):
    p = tg.gconv_plan(n, h, w, c, groups, stride)
    assert (p.ho, p.wo) == ((h - 1) // stride + 1, (w - 1) // stride + 1)
    assert p.cg == c // groups and p.cg4 == -(-p.cg // 4) * 4
    assert p.gs == min(groups, max(1, tg.GC_MAX_SLAB // p.cg4)) and p.gs * p.cg4 <= 128
    assert p.slabs == -(-groups // p.gs) and 1 <= p.bh <= p.ho and p.bands == -(-p.ho // p.bh)
    assert 1 <= p.nb <= min(8, n * p.bands) and p.grid == (-(-n * p.bands // p.nb), p.slabs)
    assert p.rh == (p.bh - 1) * stride + 3
    assert p.wp == (-(-p.wo // tg.GC_P) * tg.GC_P - 1) * stride + 3 >= (p.wo - 1) * stride + 3
    cs = p.gs * p.cg4
    assert p.vec in (16, 8, 4, 1) and (p.vec == 1) == (p.cg % 4 != 0)
    if p.vec > 1:
        assert c % p.vec == 0 and cs % p.vec == 0
    assert tg.GC_THREADS >= cs // p.vec
    assert p.smem == tg.gconv_smem(p.gs, p.cg4, p.rh, p.wp, p.nb) <= tg.GC_SMEM_LIMIT
    assert tg.group_stride_words(p.cg4) % 32 == p.cg4 % 32
    assert tg.blocks_per_sm(p.smem) >= 1
    assert all((f == 1).all() for f in coverage(p))
    if waves:
        assert p.grid[0] * p.grid[1] >= 2 * NUM_SMS
    return p


@pytest.mark.parametrize("name", ["resnext26_32x4d", "resnext50_32x4d"])
def test_plan_at_resnext_calls(name):
    calls = resnext_calls(name)
    hcs = [(h, c, s) for _, h, _, c, _, s in calls]
    assert hcs[0] == (56, 128, 1) and [r for r in hcs if r[2] == 2] == [
        (56, 256, 2), (28, 512, 2), (14, 1024, 2)]
    for call in calls:
        check_plan(*call, waves=True)
    for call in resnext_calls(name, 1):
        check_plan(*call)


# pruned lanes: Cg 3, 7, 14, 28 (any Cg >= 1), at each map and stride class
PRUNED = [(BATCH, h, h, 32 * cg, 32, s) for cg in (1, 3, 7, 14, 28)
          for h, s in ((56, 1), (56, 2), (28, 1), (28, 2), (14, 1), (14, 2), (7, 1))]


@pytest.mark.parametrize("n,h,w,c,groups,stride", PRUNED)
def test_plan_at_pruned_widths(n, h, w, c, groups, stride):
    check_plan(n, h, w, c, groups, stride, waves=True)


@pytest.mark.parametrize("n,h,w,c,groups,stride", GC_ODD_SHAPES)
def test_plan_at_odd_shapes(n, h, w, c, groups, stride):
    check_plan(n, h, w, c, groups, stride)


# --------------------------------------------------------------------------
# a replay of the kernel's data path
# --------------------------------------------------------------------------


def thread_items(p):
    """Each thread's items (j, g, run, row) as the kernel steps through them
    (digits advanced by the block size, carries without a division),
    checked against divmod; every item of the tile visited once."""
    nch, runs = p.cg4 // 4, -(-p.wo // tg.GC_P)
    items = p.bh * runs * p.gs * nch
    nt = tg.GC_THREADS
    sj, sq = nt % nch, nt // nch
    sg, srun, srow = sq % p.gs, (sq // p.gs) % runs, sq // p.gs // runs
    seen = []
    for t in range(nt):
        j, rest = t % nch, t // nch
        g, run, row = rest % p.gs, (rest // p.gs) % runs, rest // p.gs // runs
        for it in range(t, items, nt):
            r1, jr = divmod(it, nch)
            r2, gr = divmod(r1, p.gs)
            rowr, runr = divmod(r2, runs)
            assert (j, g, run, row) == (jr, gr, runr, rowr)
            seen.append((j, g, run, row))
            j += sj
            carry = j >= nch
            j -= nch * carry
            g += sg + carry
            carry = g >= p.gs
            g -= p.gs * carry
            run += srun + carry
            carry = run >= runs
            run -= runs * carry
            row += srow + carry
    seen = np.array(seen, np.int64).reshape(-1, 4)
    assert len(seen) == items and len({tuple(r) for r in seen}) == items
    return seen


def stage_tile(x, p, n, g0, gsl, iy0, zp_s):
    """The loader's tile: rows iy0 .. iy0 + rh - 1, pixels -1 .. wp - 2, the
    slab's groups at Cg4 bytes each; zp_s outside the image, past gsl groups
    and in the pad channels."""
    cs = p.gs * p.cg4
    buf = np.full((p.rh, p.wp, cs), zp_s, np.int8)
    for r in range(p.rh):
        iy = iy0 + r
        if not 0 <= iy < p.h:
            continue
        for px in range(p.wp):
            ix = px - 1
            if not 0 <= ix < p.w:
                continue
            for g in range(gsl):
                src = x[n, iy, ix, (g0 + g) * p.cg : (g0 + g + 1) * p.cg]
                buf[r, px, g * p.cg4 : g * p.cg4 + p.cg] = src
    return buf


def replay(x, w, w_scale, bias, w_sum, p, *, in_zp, in_scale, out_scale, out_zp):
    """The kernel's output for plan p, block by block, item by item."""
    zp_s = int(in_zp) - 128
    words = w.words.numpy()
    gw, ws = 9 * p.cg4 * p.cg4 // 4, tg.group_stride_words(p.cg4)
    nch, runs, cs = p.cg4 // 4, -(-p.wo // tg.GC_P), p.gs * p.cg4
    items = thread_items(p)
    out = np.zeros((p.n, p.ho, p.wo, p.c), np.int8)
    hits = np.zeros(out.shape, np.int64)
    in_scale, rs = np.float32(in_scale), 1.0 / float(np.float32(out_scale))
    zpm = np.float32(np.float32(12582912.0) - np.float32(out_zp))
    for slab in range(p.slabs):
        g0 = slab * p.gs
        gsl = min(p.gs, p.groups - g0)
        wsm = np.zeros(p.gs * ws, np.int32)  # the slab's weights at the padded stride
        for g in range(gsl):
            wsm[g * ws : g * ws + gw] = words[(g0 + g) * gw : (g0 + g + 1) * gw]
        wb = wsm.view(np.int8).reshape(-1, 4).astype(np.int32)  # word -> its 4 bytes
        base, sc, bv = np.zeros(cs, np.int32), np.zeros(cs, np.float32), np.zeros(cs, np.float32)
        for i in range(cs):
            g, co = divmod(i, p.cg4)
            if g < gsl and co < p.cg:
                ch = (g0 + g) * p.cg + co
                base[i] = -zp_s * w_sum[ch]
                sc[i] = np.float32(w_scale[ch]) * in_scale
                bv[i] = bias[ch]
        for bx in range(p.grid[0]):
            for t in range(bx * p.nb, min(bx * p.nb + p.nb, p.n * p.bands)):
                n, band = divmod(t, p.bands)
                buf = stage_tile(x, p, n, g0, gsl, band * p.bh * p.stride - 1, zp_s)
                bw = buf.reshape(p.rh, p.wp, cs // 4, 4).astype(np.int32)
                for j, g, run, row in items:
                    oy = band * p.bh + row
                    if g >= gsl or oy >= p.ho:
                        continue
                    acc = np.zeros((tg.GC_P, 4), np.int64)
                    for dy in range(3):
                        for i in range(nch):
                            for dx in range(3):
                                wi = g * ws + ((dy * 3 + dx) * nch + i) * p.cg4 + 4 * j
                                w4 = wb[wi : wi + 4]  # (output o, byte k)
                                for pp in range(tg.GC_P):
                                    px = run * tg.GC_P * p.stride + pp * p.stride + dx
                                    v = bw[row * p.stride + dy, px, (g * p.cg4) // 4 + i]
                                    acc[pp] += w4 @ v  # dp4a, per output channel
                    for pp in range(tg.GC_P):
                        ox = run * tg.GC_P + pp
                        if ox >= p.wo:
                            continue
                        for o in range(4):
                            co = 4 * j + o
                            if co >= p.cg:
                                continue
                            cl = g * p.cg4 + co
                            s = np.float32(int(acc[pp, o]) + int(base[cl]))
                            y = max(np.float32(np.float32(s * sc[cl]) + bv[cl]), np.float32(0))
                            q = np.float32(float(y) * rs)
                            v = np.float32(np.float32(q + np.float32(12582912.0)) - zpm)
                            byte = int(min(max(v, 0.0), 255.0)) - 128
                            ch = (g0 + g) * p.cg + co
                            out[n, oy, ox, ch] = byte
                            hits[n, oy, ox, ch] += 1
    assert (hits == 1).all()
    return out


# (N, H, W, groups, Cg, stride, bh, nb): top, bottom and ragged bands, tiles
# of two images in a block, runs past Wo, a ragged last slab, byte copies
REPLAY = [(2, 9, 11, 4, 4, 1, 4, 2), (2, 9, 11, 4, 4, 2, 2, 3), (1, 6, 13, 40, 4, 1, 6, 1),
          (2, 7, 6, 3, 3, 2, 4, 2), (1, 5, 9, 11, 14, 1, 2, 3), (2, 4, 5, 2, 32, 2, 1, 2),
          (1, 7, 7, 9, 7, 1, 7, 1)]


@pytest.mark.parametrize("n,h,w,groups,cg,stride,bh,nb", REPLAY)
@pytest.mark.parametrize("in_zp,out_zp", [(0, 255), (128, 128), (255, 0)])
def test_replay_equals_plain(n, h, w, groups, cg, stride, bh, nb, in_zp, out_zp):
    rng = np.random.default_rng(h + w + groups + cg + in_zp)
    x, wq, w_scale, bias = case(rng, n, h, w, groups, cg)
    c = groups * cg
    p = tg.make_gconv_plan(n, h, w, c, groups, stride, bh=bh, nb=nb)
    w_sum = wq.sum(axis=(0, 1, 2), dtype=np.int32)
    kw = dict(in_zp=in_zp, in_scale=np.float32(0.03), out_scale=np.float32(0.021),
              out_zp=out_zp)
    got = replay(x, tg.pack_grouped_weight(torch.from_numpy(wq), groups), w_scale, bias, w_sum,
                 p, **kw)
    ref = tg.grouped_conv_int8_plain(
        torch.from_numpy(x), tg.pack_grouped_weight(torch.from_numpy(wq), groups),
        torch.from_numpy(w_scale), torch.from_numpy(bias), torch.from_numpy(w_sum),
        stride=stride, **kw).numpy()
    np.testing.assert_array_equal(got, ref)
