"""Kernel F (``ops/gconv_int8.py``, ``csrc/gconv_int8.cu``) on the CPU.

- ``grouped_conv_int8_plain`` against the JAX package's grouped branch run
  op by op (``qresnet._qconv_int8(groups=G)`` + ``_epilogue`` +
  ``_requant``): EQUAL, over Cg 1..32 (not a multiple of 4 among them),
  groups 2..32, stride 1 and 2, odd H and W, zero points 0, 128 and 255,
  and the requant at rint's ties (zero weights, the bias on and beside
  half-integer quotients).
- The packed B fragments against the weights, column by column of each
  window's block-diagonal K x N matrix, through the mma's lane mapping.
- ``gconv_plan`` at resnext26_32x4d's and resnext50_32x4d's grouped calls
  (224x224, batch 256 and 1), at pruned widths and at ``chip_smoke.py``'s
  odd shapes: every output covered exactly once, shared memory within 227
  KB, legal copy widths and pixel strides, two waves of blocks at batch 256.
- The kernel's fp32 quotient (``quotient_rn``: RN(y r), one fma
  correction) equal to the correctly rounded division at sampled quotients
  and at quotients constructed within 2^-24 ulp of a float midpoint, its
  fused multiply-add emulation against exact rational arithmetic.
- A numpy replay of the kernel's data path, lane by lane: the tile staged
  by cp.async pieces or by words gathered from two aligned loads and
  shifted by byte permutes (x at 1-byte alignment too), the pad bytes
  holding garbage, the A offsets table, the A and B fragments of
  mma.sync m16n8k32 and its C layout, warp items of 8 / ntw (or 7) m16
  tiles, the column records, the epilogue's fp32 steps and integer clip,
  the output tile and its copy-out, equal to the plain version at
  every border class, slab, tile arrangement and Cg 1..32 at both strides.
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


def window_matrix(wq, g, win):
    """Window win's (K, N) int8 matrix (K = 32 ks, N = 8 nt) in the order of
    its K words, straight from the (3, 3, Cg, C) kernel: row 4 kw + k holds
    tap kw // nwt, byte 4 (kw % nwt) + k of the window's pixel; zero past the
    taps, between groups and past Cg."""
    groups = wq.shape[3] // g.cg
    m = np.zeros((32 * g.ks, 8 * g.nt), np.int64)
    for row in range(9 * g.win):
        tap, byte = divmod(row, g.win)
        gi, ci = divmod(byte, g.slot)
        for col in range(g.win):
            go, co = divmod(col, g.slot)
            grp = win * g.gw + gi
            if gi == go and ci < g.cg and co < g.cg and grp < groups:
                m[row, col] = wq[tap // 3, tap % 3, ci, grp * g.cg + co]
    return m


def test_packed_words_hold_the_weights():
    """Lane 4 gid + tig of k step s, n8 tile j: word 0 is K word 8 s + 2 tig,
    word 1 K word 8 s + 2 tig + 1, of column 8 j + gid."""
    rng = np.random.default_rng(0)
    for groups, cg in ((4, 3), (2, 8), (3, 5), (5, 1), (2, 28), (3, 14), (2, 32), (2, 40)):
        wq = rng.integers(-127, 128, (3, 3, cg, groups * cg), dtype=np.int8)
        w = tg.pack_grouped_weight(torch.from_numpy(wq), groups)
        g = tg.gc_geom(groups * cg, groups)
        b = w.words.numpy().view(np.int8).reshape(g.nwin, g.ks, g.nt, 32, 2, 4)
        gid, tig = np.arange(32) >> 2, np.arange(32) & 3
        for win in range(g.nwin):
            m = window_matrix(wq, g, win)
            for s in range(g.ks):
                for j in range(g.nt):
                    for half in (0, 1):
                        rows = 4 * (8 * s + 2 * tig[:, None] + half) + np.arange(4)
                        want = m[rows, (8 * j + gid)[:, None]]
                        np.testing.assert_array_equal(b[win, s, j, :, half], want)
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
    (runs of 8 less past Wo), and channels (slabs x windows x groups, less
    past G); every output is written once exactly when every factor is 1."""
    g = p.geom
    tiles = p.n * p.bands
    tile_hits = np.zeros(tiles, np.int64)
    for bx in range(p.grid[0]):
        tile_hits[bx * p.nb : min(bx * p.nb + p.nb, tiles)] += 1
    rows = np.zeros((p.n, p.ho), np.int64)
    for band in range(p.bands):
        oy = band * p.bh + np.arange(p.bh)
        rows[:, oy[oy < p.ho]] += tile_hits.reshape(p.n, p.bands)[:, band : band + 1]
    xs = np.zeros(p.wo, np.int64)
    ox = np.arange(p.runs * 8)
    np.add.at(xs, ox[ox < p.wo], 1)
    groups = np.zeros(p.groups, np.int64)
    gg = np.arange(g.slabs * g.ws * g.gw)
    np.add.at(groups, gg[gg < p.groups], 1)
    return tile_hits, rows, xs, groups


def check_plan(n, h, w, c, groups, stride, *, waves=False):
    p = tg.gconv_plan(n, h, w, c, groups, stride)
    g = p.geom
    assert (p.ho, p.wo) == ((h - 1) // stride + 1, (w - 1) // stride + 1)
    assert g.cg == c // groups and g.slot == (4 if g.cg <= 4 else -(-g.cg // 8) * 8)
    assert g.win == (8 if g.cg <= 4 else g.slot) and g.gw * g.slot == g.win and g.nwt % 2 == 0
    assert g.ws * g.win <= 128 and g.gs == g.ws * g.gw and g.slabs == -(-g.nwin // g.ws)
    assert g.ks * 8 >= 9 * g.win // 4 > (g.ks - 1) * 8 and g.nt * 8 >= g.win
    assert g.ntw in (1, 2, 4) and g.nt % g.ntw == 0
    assert p.bh % 2 == 0 and 2 <= p.bh <= p.ho + 1 and p.bands == -(-p.ho // p.bh)
    assert 1 <= p.nb <= min(8, n * p.bands) and p.grid == (-(-n * p.bands // p.nb), g.slabs)
    assert p.rh == (p.bh - 1) * stride + 3 and p.runs == -(-p.wo // 8) and p.ow == 8 * p.runs
    assert p.wp == (p.ow - 1) * stride + 3
    assert p.vec in (16, 8, 4, 1) and (p.vec == 1) == (c % 4 != 0)
    cs = g.ws * g.win
    if p.vec > 1:
        assert c % p.vec == 0 and p.ps % p.vec == 0 and (g.cg != g.slot or cs % p.vec == 0)
        if g.cg != g.slot:
            assert p.ps >= tg.spread_extent(g, groups, c, p.vec) + 8
    assert p.ps >= cs and p.ps % 8 == 0 and p.cso >= g.gs * g.cg + 2 and p.cso % 32 == 16
    last = (groups - (g.slabs - 1) * g.gs) * g.cg
    assert all(v % p.vec_out == 0 for v in (c, g.gs * g.cg, last, p.cso))
    assert p.smem == tg.gconv_smem(g, p.rh, p.wp, p.ps, p.bh, p.ow, p.cso, p.nb)
    assert p.smem <= tg.GC_SMEM_LIMIT and tg.blocks_per_sm(p.smem) >= 1
    assert tg.a_wavefronts(g, stride, p.wp, p.ps) >= 4 * g.ks
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
        p = check_plan(*call, waves=True)
        assert p.vec > 1  # the served calls stage by cp.async
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
# the fp32 quotient
# --------------------------------------------------------------------------


def rn_div(y, s):
    """RN_f32(y / s): the float64 quotient rounded to float32 (a quotient of
    two float32 lies at least 2^-49 from every float32 midpoint, the float64
    one within 2^-53, so the double rounding is exact)."""
    return (np.asarray(y, np.float64) / np.asarray(s, np.float64)).astype(np.float32)


def test_fma_emulation_is_exact():
    from fractions import Fraction

    rng = np.random.default_rng(11)
    a = (rng.standard_normal(400) * 2.0 ** rng.integers(-20, 20, 400)).astype(np.float32)
    b = (rng.standard_normal(400) * 2.0 ** rng.integers(-20, 20, 400)).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.standard_normal(400) * 1e-7)).astype(np.float32)
    got = tg._fma32(a, b, c)
    for ai, bi, ci, gi in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        lo = np.float32(float(exact))  # a neighbour of the exact value
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        dist = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(dist)
        ties = [v for v, d in zip(cands, dist) if d == best]
        want = ties[0] if len(ties) == 1 else next(v for v in ties if not
                                                   (np.float32(v).view(np.uint32) & 1))
        assert gi == want, (ai, bi, ci)


@pytest.mark.parametrize("kind", ["mantissa_near_2", "mantissa_near_1", "uniform"])
def test_quotient_equals_division_sampled(kind):
    """q' = RN(RN(y r) + RN(y - RN(y r) s) r) equals RN(y / s) at quotients on,
    beside and away from rint's ties, s from 2^-14 to 2."""
    rng = np.random.default_rng(len(kind))
    n = 1 << 16
    e = np.exp2(rng.integers(-14, 1, n)).astype(np.float32)
    if kind == "mantissa_near_2":
        s = (np.float32(2) - rng.integers(1, 4096, n).astype(np.float32) * np.float32(2**-23)) * e
    elif kind == "mantissa_near_1":
        s = (np.float32(1) + rng.integers(0, 4096, n).astype(np.float32) * np.float32(2**-23)) * e
    else:
        s = rng.uniform(1, 2, n).astype(np.float32) * e
    s = s.astype(np.float32)
    v = rng.integers(0, 300, n) + 0.5 + np.where(rng.random(n) < 0.5, 0.0,
                                                  rng.uniform(-1e-5, 1e-5, n))
    v = np.where(rng.random(n) < 0.3, rng.uniform(0, 300, n), v)
    y = (v * s.astype(np.float64)).astype(np.float32)
    y = np.nextafter(y, np.where(rng.random(n) < 0.5, np.float32(np.inf),
                                 np.float32(0))).astype(np.float32)
    y = np.abs(y)
    np.testing.assert_array_equal(tg.quotient_rn(y, s), rn_div(y, s))


def near_midpoints(rng, count):
    """(y, s) whose quotient lies within a few 2^-48 (relative) of a float32
    midpoint M: s = S 2^a, M = K 2^b (S odd 24-bit, K odd 25-bit), y = (K S
    - c) 2^(a + b) with K S = c (mod 2^t), c odd and small: y / s - M = -c
    2^(a + b) / s."""
    ys, ss = [], []
    while len(ys) < count:
        S = int(rng.integers(2**22, 2**23)) * 2 + 1
        c = int(rng.integers(-4, 4)) * 2 + 1
        t = int(rng.integers(24, 26))
        m = 1 << t
        k = (c * pow(S, -1, m)) % m
        K = (1 << 24) + ((k - (1 << 24)) % m) + m * int(rng.integers(0, 4))
        if K >= 1 << 25 or (K * S - c) % m:
            continue
        Y = (K * S - c) >> t
        if not 2**23 <= Y < 2**24:
            continue
        es = int(rng.integers(-16, 1))
        em = int(rng.integers(-26, -15))
        ys.append(np.float32(np.ldexp(float(Y), em + es - 23 + t)))
        ss.append(np.float32(np.ldexp(float(S), es - 23)))
    return np.array(ys, np.float32), np.array(ss, np.float32)


def test_quotient_equals_division_near_midpoints():
    from fractions import Fraction

    y, s = near_midpoints(np.random.default_rng(5), 6000)
    # they are near midpoints: within 2^-20 ulp, most much closer
    for yi, si in zip(y[:50], s[:50]):
        v = Fraction(float(yi)) / Fraction(float(si))
        f = np.float32(float(v))
        up = np.nextafter(f, np.float32(np.inf))
        mid = (Fraction(float(f)) + Fraction(float(up))) / 2
        lo = np.nextafter(f, np.float32(0))
        mid = min((mid, (Fraction(float(f)) + Fraction(float(lo))) / 2),
                  key=lambda m: abs(v - m))
        assert abs(v - mid) < Fraction(float(np.spacing(f))) * 2**-20
    np.testing.assert_array_equal(tg.quotient_rn(y, s), rn_div(y, s))


# --------------------------------------------------------------------------
# a replay of the kernel's data path
# --------------------------------------------------------------------------

GID, TIG = np.arange(32) >> 2, np.arange(32) & 3


def mma(acc, a, b):
    """mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on the 32 lanes'
    registers: a (32, 4) words (a0: row gid, K bytes 4 tig..; a1: row gid +
    8; a2, a3: K bytes 16 + 4 tig..), b (32, 2) words (column gid, K bytes 4
    tig.. and 16 + 4 tig..), acc (32, 4): rows gid, gid, gid + 8, gid + 8 x
    columns 2 tig, 2 tig + 1."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    ab = a.astype(np.uint32).view(np.int8).reshape(32, 4, 4)
    for r, (ro, ko) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        A[GID[:, None] + ro, ko + 4 * TIG[:, None] + np.arange(4)] = ab[:, r]
    bb = b.astype(np.uint32).view(np.int8).reshape(32, 2, 4)
    for r, ko in enumerate((0, 16)):
        B[ko + 4 * TIG[:, None] + np.arange(4), GID[:, None]] = bb[:, r]
    d = A @ B
    out = acc.copy()
    for r in range(4):
        out[:, r] += d[GID + 8 * (r >= 2), 2 * TIG + (r & 1)]
    return out


def stage(mem, xoff, x, p, n, g0, gsl, iy0, zp_s, rng):
    """The input tile as the kernel stages it (bytes rh x wp x ps, garbage
    where nothing is written): cp.async pieces of vec bytes (the slab's, or
    the aligned bytes around them, then spread into the slots in place, each
    pixel's words read before any is written), or words from two aligned
    loads of the byte memory ``mem`` (x at offset ``xoff``) joined by a byte
    permute."""
    g = p.geom
    _, hh, ww, c = x.shape
    buf = rng.integers(0, 256, p.rh * p.wp * p.ps, dtype=np.uint8)
    zw = np.full(4, zp_s, np.int8).view(np.uint8)
    cs = g.ws * g.win
    last = (xoff + x.size - 1) & ~3
    if p.vec > 1 and g.cg != g.slot:
        lo = g0 * g.cg // p.vec * p.vec
        hi = min(c, -(-(g0 + gsl) * g.cg // p.vec) * p.vec)
        assert hi - lo + 8 <= p.ps
        for r in range(p.rh):
            for px in range(p.wp):
                iy, ix = iy0 + r, px - 1
                d0 = (r * p.wp + px) * p.ps
                if 0 <= iy < hh and 0 <= ix < ww:
                    pix = xoff + ((n * hh + iy) * ww + ix) * c
                    buf[d0 : d0 + hi - lo] = mem[pix + lo : pix + hi]
                else:
                    buf[d0 : d0 + hi - lo] = np.tile(zw, (hi - lo) // 4)
                words = []
                for dw in range(cs // 4):
                    wd, i = divmod(dw, g.nwt)
                    gi = 4 * i // g.slot
                    grp = wd * g.gw + gi
                    if 0 <= iy < hh and 0 <= ix < ww and grp < gsl:
                        o = (g0 + grp) * g.cg + 4 * i - gi * g.slot - lo
                        words.append(buf[d0 + (o & ~3) : d0 + (o & ~3) + 8][o & 3 :][:4].copy())
                    else:
                        words.append(zw)
                buf[d0 : d0 + cs] = np.concatenate(words)
        return buf
    for r in range(p.rh):
        iy = iy0 + r
        for px in range(p.wp):
            ix = px - 1
            inside = 0 <= iy < hh and 0 <= ix < ww
            d0 = (r * p.wp + px) * p.ps
            pix = xoff + ((n * hh + iy) * ww + ix) * c if inside else 0
            if p.vec > 1:
                for j in range(cs // p.vec):
                    ok = inside and j * p.vec < gsl * g.cg
                    src = mem[pix + g0 * g.cg + j * p.vec:][:p.vec] if ok else np.tile(zw, p.vec // 4)
                    buf[d0 + j * p.vec : d0 + (j + 1) * p.vec] = src
                continue
            for dw in range(cs // 4):
                wd, i = divmod(dw, g.nwt)
                gi = 4 * i // g.slot
                grp = wd * g.gw + gi
                if inside and grp < gsl:
                    a = pix + (g0 + grp) * g.cg + 4 * i - gi * g.slot
                    pa = a & ~3
                    pb = min(pa + 4, last)
                    word = np.concatenate([mem[pa : pa + 4], mem[pb : pb + 4]])[a & 3 :][:4]
                else:
                    word = zw
                buf[d0 + 4 * dw : d0 + 4 * dw + 4] = word
    return buf


def out_q(acc, col, s, zp):
    """The epilogue of csrc/gconv_int8.cu out_q for int32 sums acc and column
    records col = (base, s_in s_w bits, bias bits, out byte): rint(y / s) +
    zp clipped to [0, 255], from the bits of RINT_MAGIC + the quotient."""
    f = acc.astype(np.int64).astype(np.int32).astype(np.float32)
    sc, b = col[:, 1].astype(np.int32).view(np.float32), col[:, 2].astype(np.int32).view(np.float32)
    y = np.maximum((f * sc).astype(np.float32) + b, np.float32(0)).astype(np.float32)
    q = tg.quotient_rn(y, s)
    bits = (q + np.float32(12582912.0)).astype(np.float32).view(np.int32).astype(np.int64)
    t = (bits - (0x4B400000 - int(zp))) & 0xFFFFFFFF
    return np.minimum(t, 255)


def step(pp, mp, npairs):
    """A warp's next item (window chunk pp, m16 group mp): 8 items on, by
    digits without a division."""
    pp += tg.GC_WARPS % npairs
    if pp >= npairs:
        pp -= npairs
        mp += 1
    return pp, mp + tg.GC_WARPS // npairs


def replay(x, w, w_scale, bias, w_sum, p, *, in_zp, in_scale, out_scale, out_zp, xoff=0):
    """The kernel's output for plan p, block by block, warp item by warp
    item, lane by lane."""
    g = p.geom
    rng = np.random.default_rng(99)
    zp_s = int(in_zp) - 128
    mem = np.concatenate([rng.integers(0, 256, xoff, dtype=np.uint8), x.reshape(-1).view(np.uint8),
                          rng.integers(0, 256, 8, dtype=np.uint8)])
    frags = w.words.numpy().reshape(g.nwin, g.ks, g.nt, 32, 2)
    s, in_scale = np.float32(out_scale), np.float32(in_scale)
    out = np.zeros((p.n, p.ho, p.wo, p.c), np.int8)
    hits = np.zeros(out.shape, np.int64)
    sr = p.stride * p.wp * p.ps
    kof = np.array([[lo, lo + sr] for st in range(g.ks) for t in range(4)
                    for lo in [tg.koff(g, 8 * st + 2 * t, p.wp, p.ps)]], np.int64)
    nc = g.nt // g.ntw
    assert nc & (nc - 1) == 0  # the kernel splits a chunk index by a shift
    npairs = g.ws * nc
    mt_per = tg.item_tiles(g, p.runs)  # m16 tiles a warp item
    mtiles = p.bh // 2 * p.runs
    items = -(-mtiles // mt_per) * npairs
    orow = p.ow * p.cso
    for slab in range(g.slabs):
        w0, g0 = slab * g.ws, slab * g.gs
        wsl, gsl = min(g.ws, g.nwin - w0), min(g.gs, p.groups - g0)
        cols = np.zeros((g.ws * g.nt * 8, 4), np.int64)
        for i in range(len(cols)):
            wl, col = divmod(i, g.nt * 8)
            gi, co = divmod(col, g.slot)
            grp = wl * g.gw + gi
            ok = wl < wsl and col < g.win and co < g.cg and grp < gsl
            ch = (g0 + grp) * g.cg + co if ok else 0
            base = -zp_s * int(w_sum[ch]) if ok else 0
            sc = np.float32(w_scale[ch]) * in_scale if ok else np.float32(0)
            cols[i] = (base,
                       np.float32(sc).view(np.int32), np.float32(bias[ch] if ok else 0).view(np.int32),
                       grp * g.cg + co if ok else p.cso - 2)
        for bx in range(p.grid[0]):
            for t in range(bx * p.nb, min(bx * p.nb + p.nb, p.n * p.bands)):
                n, band = divmod(t, p.bands)
                buf = stage(mem, xoff, x, p, n, g0, gsl, band * p.bh * p.stride - 1, zp_s, rng)
                buf32 = buf.view(np.uint32)
                ob = rng.integers(0, 256, tg.out_rows(g, p.bh, p.runs) * p.ow * p.cso,
                                  dtype=np.uint8)
                seen = []
                for warp in range(tg.GC_WARPS):
                    pp, mg = warp % npairs, warp // npairs
                    for it in range(warp, items, tg.GC_WARPS):
                        assert divmod(it, npairs) == (mg, pp)
                        seen.append(it)
                        wi, c0 = pp // nc, (pp % nc) * g.ntw
                        if wi >= wsl:  # a ragged last slab's missing windows
                            pp, mg = step(pp, mg, npairs)
                            continue
                        m0 = mg * mt_per
                        nm = mtiles - m0
                        rp, run = divmod(m0, p.runs)
                        base, obase = [], []
                        for m in range(mt_per):
                            ox = run * 8 + GID
                            base.append((2 * rp * p.stride * p.wp + ox * p.stride) * p.ps
                                        + wi * g.win if m == 0 or m < nm else base[0])
                            obase.append((2 * rp * p.ow + ox) * p.cso)
                            run += 1
                            if run == p.runs:
                                run, rp = 0, rp + 1
                        cw = (wi * g.nt + c0) * 8 + 2 * TIG
                        acc = np.zeros((mt_per, g.ntw, 32, 4), np.int64)
                        for j in range(g.ntw):
                            b0, b1 = cols[cw + 8 * j, 0], cols[cw + 8 * j + 1, 0]
                            acc[:, j] = np.stack([b0, b1, b0, b1], 1)
                        for st in range(g.ks):
                            ko = kof[4 * st + TIG]
                            for m in range(mt_per):
                                addr = base[m][:, None] + ko  # (lane, row): 64-bit loads
                                assert (addr % 8 == 0).all() and (addr >= 0).all()
                                r0, r1 = buf32[addr[:, 0] // 4 + np.arange(2)[:, None]], \
                                    buf32[addr[:, 1] // 4 + np.arange(2)[:, None]]
                                af = np.stack([r0[0], r1[0], r0[1], r1[1]], 1)
                                for j in range(g.ntw):
                                    acc[m, j] = mma(acc[m, j], af, frags[w0 + wi, st, c0 + j])
                        for j in range(g.ntw):
                            k0, k1 = cols[cw + 8 * j], cols[cw + 8 * j + 1]
                            for m in range(mt_per):
                                for o, r0, r1 in ((obase[m], 0, 1), (obase[m] + orow, 2, 3)):
                                    for kk, r in ((k0, r0), (k1, r1)):
                                        q = out_q(acc[m, j, :, r], kk, s, out_zp)
                                        ob[o + kk[:, 3]] = (q ^ 0x80).astype(np.uint8)
                        pp, mg = step(pp, mg, npairs)
                assert sorted(seen) == list(range(items))
                # copy-out: rows below Ho, x below Wo, the slab's gsl Cg bytes
                oy0 = band * p.bh
                for r in range(min(p.bh, p.ho - oy0)):
                    for ox in range(p.wo):
                        src = ob[(r * p.ow + ox) * p.cso:][:gsl * g.cg]
                        out[n, oy0 + r, ox, g0 * g.cg : (g0 + gsl) * g.cg] = src.view(np.int8)
                        hits[n, oy0 + r, ox, g0 * g.cg : (g0 + gsl) * g.cg] += 1
    assert (hits == 1).all()
    return out


# (N, H, W, groups, Cg, stride, bh, nb, x offset): top, bottom and ragged
# bands, tiles of two images in a block, runs past Wo, a ragged last slab
# and window, staging spread into the slots (Cg 3, 7, 12, 14, 28 with C a
# multiple of 4, a ragged slab among them), word staging (C not a multiple
# of 4, or x at 1-byte alignment), Cg 1, 3, 7, 14, 28 and 32 at both
# strides, rows of 50 outputs (items of 7 m16 tiles)
REPLAY = [(2, 9, 11, 4, 4, 1, 4, 2, 0), (2, 9, 11, 4, 4, 2, 2, 3, 0), (1, 6, 13, 40, 4, 1, 6, 1, 0),
          (2, 7, 6, 3, 3, 2, 4, 2, 0), (1, 5, 9, 11, 14, 1, 2, 3, 0), (2, 4, 5, 2, 32, 2, 2, 2, 0),
          (1, 7, 7, 9, 7, 1, 8, 1, 0), (1, 5, 9, 8, 8, 1, 2, 2, 1), (1, 6, 5, 3, 16, 2, 2, 1, 3),
          (1, 5, 6, 5, 1, 1, 2, 2, 0), (1, 7, 5, 5, 1, 2, 2, 1, 0),
          (1, 6, 7, 3, 3, 1, 2, 3, 0), (1, 5, 9, 4, 7, 2, 2, 1, 0),
          (1, 5, 4, 2, 14, 2, 4, 1, 0), (1, 4, 5, 2, 28, 1, 2, 2, 0),
          (1, 5, 5, 2, 28, 2, 2, 2, 0), (1, 4, 6, 2, 32, 1, 4, 1, 0),
          (1, 6, 7, 20, 7, 1, 2, 2, 0), (1, 5, 6, 12, 3, 2, 2, 1, 0), (1, 6, 6, 6, 12, 1, 2, 2, 0),
          (1, 3, 50, 2, 4, 1, 4, 1, 0), (1, 5, 99, 2, 8, 2, 2, 2, 0)]


@pytest.mark.parametrize("n,h,w,groups,cg,stride,bh,nb,xoff", REPLAY)
@pytest.mark.parametrize("in_zp,out_zp", [(0, 255), (128, 128), (255, 0)])
def test_replay_equals_plain(n, h, w, groups, cg, stride, bh, nb, xoff, in_zp, out_zp):
    rng = np.random.default_rng(h + w + groups + cg + in_zp)
    x, wq, w_scale, bias = case(rng, n, h, w, groups, cg)
    c = groups * cg
    align = 16 if xoff == 0 else next(v for v in (8, 4, 1) if xoff % v == 0)
    vec = tg._vecs(c, tg.gc_geom(c, groups), align)[0]
    p = tg.make_gconv_plan(n, h, w, c, groups, stride, bh=bh, nb=nb, vec=vec)
    assert (p.vec == 1) == (c % 4 != 0 or align < 4)
    w_sum = wq.sum(axis=(0, 1, 2), dtype=np.int32)
    kw = dict(in_zp=in_zp, in_scale=np.float32(0.03), out_scale=np.float32(0.021),
              out_zp=out_zp)
    packed = tg.pack_grouped_weight(torch.from_numpy(wq), groups)
    got = replay(x, packed, w_scale, bias, w_sum, p, xoff=xoff, **kw)
    ref = tg.grouped_conv_int8_plain(
        torch.from_numpy(x), packed, torch.from_numpy(w_scale), torch.from_numpy(bias),
        torch.from_numpy(w_sum), stride=stride, **kw).numpy()
    np.testing.assert_array_equal(got, ref)


# narrower slabs than the widest (small calls: more blocks): (N, H, W, groups,
# Cg, stride, windows a slab), the last slab ragged
NARROW = [(1, 6, 7, 10, 4, 1, 2), (1, 5, 6, 5, 8, 2, 3), (1, 6, 5, 3, 14, 1, 2)]


@pytest.mark.parametrize("n,h,w,groups,cg,stride,ws", NARROW)
@pytest.mark.parametrize("in_zp,out_zp", [(0, 255), (128, 128)])
def test_replay_narrow_slab_equals_plain(n, h, w, groups, cg, stride, ws, in_zp, out_zp):
    rng = np.random.default_rng(h + groups + cg + ws + in_zp)
    x, wq, w_scale, bias = case(rng, n, h, w, groups, cg)
    c = groups * cg
    vec = tg._vecs(c, tg.slab_geom(tg.gc_geom(c, groups), ws), 16)[0]
    p = tg.make_gconv_plan(n, h, w, c, groups, stride, bh=2, nb=2, vec=vec, ws=ws)
    assert p.geom.ws == ws < tg.gc_geom(c, groups).ws and p.geom.slabs == -(-p.geom.nwin // ws)
    w_sum = wq.sum(axis=(0, 1, 2), dtype=np.int32)
    kw = dict(in_zp=in_zp, in_scale=np.float32(0.03), out_scale=np.float32(0.021),
              out_zp=out_zp)
    packed = tg.pack_grouped_weight(torch.from_numpy(wq), groups)
    got = replay(x, packed, w_scale, bias, w_sum, p, **kw)
    ref = tg.grouped_conv_int8_plain(
        torch.from_numpy(x), packed, torch.from_numpy(w_scale), torch.from_numpy(bias),
        torch.from_numpy(w_sum), stride=stride, **kw).numpy()
    np.testing.assert_array_equal(got, ref)
