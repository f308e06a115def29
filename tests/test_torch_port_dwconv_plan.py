"""Kernel E (``csrc/dwconv_int8.cu``) around the CUDA code, on the CPU.

- ``ops/dwconv_int8.py:dw_plan``, the tiles the kernel takes, at
  EfficientNet-B0's 16 depthwise calls (batch 256), at pruned widths (C 8,
  24, 40 and 920 at each of B0's map, kernel and stride classes) and at
  ``chip_smoke.py``'s odd shapes: every output covered exactly once, shared
  memory within 227 KB, a thread for every copy of a pixel, legal copy
  widths, at least two waves of blocks on 132 SMs at batch 256.
- A replay in torch of the kernel's data path: the tile staged by the
  loader's threads (each byte written once, the halo and the channels past
  C at zp_s), the window of words each thread loads once per staged row,
  its input pairs (two horizontally adjacent signed bytes of a channel, as
  16-bit lanes) that serve its outputs' taps in both of its rows, the tap
  pairs of weights as the kernel packs them, dp2a in the kernel's order,
  the int-to-float magic constant that carries - zp_s * sum(w), and the
  items each thread walks (the mixed-radix stepping against a division),
  equal to the plain version's int32 sums (``depthwise_acc_int32`` less
  zp_s * sum(w)) at every border class at stride 1 and 2: top, bottom and
  ragged bands, odd bands, tiles of several images in one block, left and
  right halos, runs past Wo, a ragged channel group, byte copies for odd C.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import E_ODD_SHAPES, EFF_ARTIFACT, dw_calls
from inference_efficient_vision_models_tpu_torch.compress.quant.qeffnet import load_static_int8
from inference_efficient_vision_models_tpu_torch.ops.dwconv_int8 import (
    DW_MAX_GROUP,
    DW_SMEM_LIMIT,
    DW_THREADS,
    NUM_SMS,
    ROWS_PER_THREAD,
    blocks_per_sm,
    depthwise_acc_int32,
    dw_plan,
    dw_smem,
    make_dw_plan,
)

BATCH = 256
_B0_CALLS = []


def b0_calls():
    """(H, W, C, k, stride) of the committed B0's 16 depthwise calls."""
    if not _B0_CALLS:
        model = load_static_int8(EFF_ARTIFACT, "cpu")
        _B0_CALLS.extend((shape[1], shape[2], shape[3], leaf["w_q"].shape[0], stride)
                         for _, shape, leaf, stride, _, _ in dw_calls(model, BATCH))
    return _B0_CALLS


# B0's (H, k, stride) classes at 224x224
B0_CLASSES = [(112, 3, 1), (112, 3, 2), (56, 3, 1), (56, 5, 2), (28, 5, 1), (28, 3, 2),
              (14, 3, 1), (14, 5, 1), (14, 5, 2), (7, 5, 1), (7, 3, 1)]
PRUNED = [(n, h, h, c, k, s) for c in (8, 24, 40, 920) for h, k, s in B0_CLASSES
          for n in (BATCH,)]


def coverage(p):
    """How often the blocks of plan p write each output, as the factors of a
    product: the (image, band) tiles (blocks x tiles per block), the rows of
    each image (its bands' rows less those past Ho), x (runs x p, less past
    Wo) and channels (groups x words x 4, less past C). A tile's items are
    the full product of its rows, runs and channel words (``thread_items``
    checks that the threads visit each once), so every output is written
    once exactly when every factor is 1 everywhere."""
    tiles = p.n * p.bands
    tile_hits = np.zeros(tiles, np.int64)
    for bx in range(p.grid[0]):
        tile_hits[bx * p.nb : min(bx * p.nb + p.nb, tiles)] += 1
    rows = np.zeros((p.n, p.ho), np.int64)
    for band in range(p.bands):
        oy = band * p.bh + np.arange(p.bh)
        rows[:, oy[oy < p.ho]] += tile_hits.reshape(p.n, p.bands)[:, band : band + 1]
    xs = np.zeros(p.wo, np.int64)
    ox = np.arange(-(-p.wo // p.p) * p.p)
    np.add.at(xs, ox[ox < p.wo], 1)
    chans = np.zeros(p.c, np.int64)
    cc = np.arange(p.grid[1] * p.cg)
    np.add.at(chans, cc[cc < p.c], 1)
    return tile_hits, rows, xs, chans


def covered_once(p) -> bool:
    return all((f == 1).all() for f in coverage(p))


def check_plan(n, h, w, c, k, stride, *, waves=False):
    p = dw_plan(n, h, w, c, k, stride)
    pad = (k - 1) // 2
    assert (p.ho, p.wo) == ((h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1)
    assert p.cg % 4 == 0 and 4 <= p.cg <= DW_MAX_GROUP and p.p in (2, 4)
    assert p.groups == -(-c // p.cg) and (p.groups - 1) * p.cg < c
    assert 1 <= p.bh <= p.ho and p.bands == -(-p.ho // p.bh)
    assert 1 <= p.nb <= min(4, n * p.bands) and p.grid == (-(-n * p.bands // p.nb), p.groups)
    # the rows of the band's last pair of output rows (one past the band for odd bh)
    assert p.rh == (-(-p.bh // ROWS_PER_THREAD) * ROWS_PER_THREAD - 1) * stride + k
    # the padded width holds every window, the last run's past Wo included
    assert p.wp == (-(-p.wo // p.p) * p.p - 1) * stride + k >= (p.wo - 1) * stride + k
    # copies: 16, 8 or 4 bytes dividing C and the group (cp.async), bytes for other C
    assert p.vec in (16, 8, 4, 1)
    if p.vec > 1:
        assert c % p.vec == 0 and p.cg % p.vec == 0
    assert (p.vec == 1) == (c % 4 != 0)
    assert DW_THREADS >= p.cg // p.vec
    assert p.smem == dw_smem(k, p.cg, p.rh, p.wp, p.nb) <= DW_SMEM_LIMIT == 227 * 1024
    assert blocks_per_sm(p.smem) >= 1
    if waves:
        assert p.grid[0] * p.grid[1] >= 2 * NUM_SMS
    return p


def test_plan_at_b0_calls():
    calls = b0_calls()
    assert len(calls) == 16
    for h, w, c, k, stride in calls:
        p = check_plan(BATCH, h, w, c, k, stride, waves=True)
        assert covered_once(p), (h, c, k, stride)
        thread_items(p)


@pytest.mark.parametrize("n,h,w,c,k,stride", PRUNED)
def test_plan_at_pruned_widths(n, h, w, c, k, stride):
    p = check_plan(n, h, w, c, k, stride, waves=True)
    assert covered_once(p)


@pytest.mark.parametrize("n,h,w,c,k,stride", E_ODD_SHAPES)
def test_plan_at_odd_shapes(n, h, w, c, k, stride):
    p = check_plan(n, h, w, c, k, stride)
    assert covered_once(p)


# --------------------------------------------------------------------------
# the replay
# --------------------------------------------------------------------------


def stage_band(x: np.ndarray, p, n: int, by: int, band: int, zp_s: int) -> np.ndarray:
    """The band buffer (rh, wp, cg) as the kernel's stage_band threads write
    it: thread t copies piece t % (cg / vec) of pixels t / (cg / vec), + lanes,
    ...; a piece inside the image and below C is x's bytes, any other zp_s.
    Asserts that every byte is written exactly once."""
    _, hh, ww, c = x.shape
    pad = (p.k - 1) // 2
    cpp = p.cg // p.vec
    lanes = DW_THREADS // cpp
    c0, iy0 = by * p.cg, band * p.bh * p.stride - pad
    buf = np.zeros((p.rh, p.wp, p.cg), np.uint8)
    writes = np.zeros(buf.shape, np.int64)
    for t in range(lanes * cpp):
        j, pl = t % cpp, t // cpp
        cc = c0 + j * p.vec
        for r in range(p.rh):
            iy = iy0 + r
            for px in range(pl, p.wp, lanes):
                ix = px - pad
                sl = slice(j * p.vec, (j + 1) * p.vec)
                writes[r, px, sl] += 1
                if 0 <= iy < hh and 0 <= ix < ww and cc < c:
                    buf[r, px, sl] = x[n, iy, ix, cc : cc + p.vec].view(np.uint8)
                else:
                    buf[r, px, sl] = np.uint8(zp_s & 0xFF)
    assert (writes == 1).all()
    return buf


def thread_items(p):
    """Each thread's items as the kernel steps through them (cw, run, pair
    digits advanced by the block size without a division), checked against
    divmod; every
    item of the band visited once."""
    cwn, runs = p.cg // 4, -(-p.wo // p.p)
    items = -(-p.bh // ROWS_PER_THREAD) * runs * cwn
    nt = DW_THREADS
    dcw, drest = nt % cwn, nt // cwn
    d0, d1 = divmod(drest, runs), divmod(drest + 1, runs)
    seen = []
    for t in range(nt):
        cw, rest = t % cwn, t // cwn
        run, pair = rest % runs, rest // runs
        for it in range(t, items, nt):
            rest_ref, cw_ref = divmod(it, cwn)
            assert (cw, run, pair) == (cw_ref, rest_ref % runs, rest_ref // runs)
            seen.append((cw, run, pair))
            cw += dcw
            carry = cw >= cwn
            if carry:
                cw -= cwn
            dpair, drun = d1 if carry else d0
            run, pair = run + drun, pair + dpair
            if run >= runs:
                run, pair = run - runs, pair + 1
    seen = np.array(seen, np.int64).reshape(-1, 3)
    assert len(seen) == items and len({tuple(r) for r in seen}) == items
    return seen


def pair_words(w_q: np.ndarray, c0: int, cg: int) -> np.ndarray:
    """The block's tap-pair words as the kernel packs them, (2k, cg) int32:
    word dy = bytes (w[dy][0], w[dy][1], w[dy][2], w[dy][3] or 0), word k +
    dy = (w[dy][4], 0, 0, 0) for k 5; zeros past C."""
    k, c = w_q.shape[0], w_q.shape[-1]
    wb = np.zeros((k, 5, cg), np.int64)
    live = min(cg, c - c0)
    wb[:, :k, :live] = w_q[:, :, 0, c0 : c0 + live].astype(np.uint8)
    lo = wb[:, 0] | wb[:, 1] << 8 | wb[:, 2] << 16 | wb[:, 3] << 24
    return np.concatenate([lo, wb[:, 4]]).astype(np.uint32).view(np.int32)


def sbytes(words: torch.Tensor, first: int) -> torch.Tensor:
    """Bytes first and first + 1 of int32 words, as signed values (..., 2)."""
    b = torch.stack([(words >> (8 * (first + i))) & 0xFF for i in (0, 1)], dim=-1)
    return torch.where(b > 127, b - 256, b)


def dp2a(pair: torch.Tensor, words: torch.Tensor, first: int, acc: torch.Tensor) -> torch.Tensor:
    """__dp2a_lo (first 0) or __dp2a_hi (first 2): acc plus the pair's two
    16-bit lanes times bytes first, first + 1 of the weight words."""
    return acc + (pair * sbytes(words, first)).sum(-1)


def replay(x: np.ndarray, w_q: np.ndarray, p, zp_in: int) -> np.ndarray:
    """The kernel's sums less zp_s * sum(w), through its staging, windows,
    input pairs, dp2a and int-to-float magic; asserts each output is written
    once."""
    nn, _, _, c = x.shape
    k, s, pp, rr = p.k, p.stride, p.p, ROWS_PER_THREAD
    nw, nr = (pp - 1) * s + k, (rr - 1) * s + k
    npr, step = (nw, 2) if s == 1 else ((nw + 1) // 2, 1)
    zp_s = zp_in - 128
    out = np.zeros((nn, p.ho, p.wo, c), np.float64)
    hits = np.zeros(out.shape, np.int64)
    items = thread_items(p)
    cw, run, pair = (torch.from_numpy(items[:, i]) for i in range(3))
    chans = cw[:, None] * 4 + torch.arange(4)[None, :]  # (items, 4) within the group
    for by in range(p.groups):
        c0 = by * p.cg
        wpair = torch.from_numpy(pair_words(w_q, c0, p.cg).astype(np.int64))
        live = min(p.cg, c - c0)
        sw = np.zeros(p.cg, np.int64)
        sw[:live] = w_q[..., c0 : c0 + live].astype(np.int64).sum(axis=(0, 1, 2))
        base = torch.from_numpy(0x4B400000 - zp_s * sw)[chans]  # (items, 4)
        for bx in range(p.grid[0]):
            for tile in range(bx * p.nb, min(bx * p.nb + p.nb, nn * p.bands)):
                n, band = divmod(tile, p.bands)
                buf = torch.from_numpy(stage_band(x, p, n, by, band, zp_s).view(np.int8))
                buf = buf.reshape(-1).to(torch.int64)
                acc = torch.zeros((len(items), rr, pp, 4), dtype=torch.int64)
                for sr in range(nr):
                    at = (pair * rr * s + sr) * p.wp * p.cg + run * pp * s * p.cg + cw * 4
                    # the window: nw words of the staged row, each loaded once
                    wd = buf[at[:, None, None] + torch.arange(nw)[None, :, None] * p.cg
                             + torch.arange(4)[None, None, :]]  # (items, nw, 4) signed bytes
                    # pair i: pixels i s and i s + 1 (the last one's second: itself, weight 0)
                    pr = torch.stack([torch.stack([wd[:, i * s], wd[:, min(i * s + 1, nw - 1)]], -1)
                                      for i in range(npr)], 1)  # (items, npr, 4, 2)
                    for r in range(rr):
                        dy = sr - r * s
                        if not 0 <= dy < k:
                            continue
                        wa, wb = wpair[dy][chans], wpair[k + dy][chans]  # (items, 4)
                        for o in range(pp):
                            v = dp2a(pr[:, o], wa, 0, acc[:, r, o])
                            v = dp2a(pr[:, o + step], wa, 2, v)
                            if k == 5:
                                v = dp2a(pr[:, o + 2 * step], wb, 0, v)
                            acc[:, r, o] = v
                # (1.5 * 2^23 + sum) as float bits, less 1.5 * 2^23: exact for |sum| < 2^22
                bits = (base[:, None, None, :] + acc).to(torch.int32)
                sums = bits.view(torch.float32) - torch.tensor(12582912.0)
                for r in range(rr):
                    oy = band * p.bh + pair * rr + r
                    for o in range(pp):
                        ox = run * pp + o
                        for ch in range(4):
                            cc = c0 + cw * 4 + ch
                            ok = (pair * rr + r < p.bh) & (oy < p.ho) & (ox < p.wo) & (cc < c)
                            sel = ok.nonzero().flatten()
                            out[n, oy[sel], ox[sel], cc[sel]] = sums[sel, r, o, ch].double().numpy()
                            hits[n, oy[sel], ox[sel], cc[sel]] += 1
    assert (hits == 1).all()
    return out


def plain_acc(x: np.ndarray, w_q: np.ndarray, stride: int, zp_in: int) -> np.ndarray:
    k = w_q.shape[0]
    pad, zp_s = (k - 1) // 2, zp_in - 128
    xp = F.pad(torch.from_numpy(x), (0, 0, pad, pad, pad, pad), value=zp_s)
    wt = torch.from_numpy(w_q)
    acc = depthwise_acc_int32(xp, wt, stride) - zp_s * wt.to(torch.int32).sum(dim=(0, 1, 2))
    return acc.numpy()


# (n, h, w, c, k, stride, cg, bh, nb, p): top, bottom and ragged bands, odd
# bands (a pair's second row skipped), tiles of two images in one block, a
# ragged last block, left and right halos, runs past Wo, ragged channel
# groups, each copy width (16: C 32; 8: C 24, 40; 4: C 20; bytes: C 13 and 1)
REPLAY = [
    (2, 9, 11, 13, 3, 1, 8, 2, 2, 4),
    (2, 9, 11, 13, 3, 2, 8, 3, 3, 2),
    (1, 10, 10, 24, 5, 1, 16, 3, 2, 4),
    (2, 11, 13, 40, 5, 2, 16, 4, 4, 4),
    (1, 12, 9, 20, 5, 2, 12, 3, 2, 2),
    (3, 7, 7, 32, 5, 1, 32, 7, 2, 4),
    (1, 14, 15, 32, 3, 2, 16, 5, 2, 2),
    (2, 8, 6, 1, 5, 1, 4, 3, 4, 2),
]


@pytest.mark.parametrize("n,h,w,c,k,stride,cg,bh,nb,p", REPLAY)
@pytest.mark.parametrize("in_zp", [0, 128, 255])
def test_replay_equals_plain_sums(n, h, w, c, k, stride, cg, bh, nb, p, in_zp):
    rng = np.random.default_rng(h * 31 + c + k + stride + in_zp)
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    w_q = rng.integers(-128, 128, (k, k, 1, c), dtype=np.int8)
    plan = make_dw_plan(n, h, w, c, k, stride, cg=cg, bh=bh, nb=nb, p=p)
    np.testing.assert_array_equal(replay(x, w_q, plan, in_zp),
                                  plain_acc(x, w_q, stride, in_zp).astype(np.float64))


@pytest.mark.parametrize("n,h,w,c,k,stride", E_ODD_SHAPES[:4])
def test_replay_of_dw_plan_equals_plain_sums(n, h, w, c, k, stride):
    rng = np.random.default_rng(c + k)
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    w_q = rng.integers(-128, 128, (k, k, 1, c), dtype=np.int8)
    plan = dw_plan(n, h, w, c, k, stride)
    np.testing.assert_array_equal(replay(x, w_q, plan, 117),
                                  plain_acc(x, w_q, stride, 117).astype(np.float64))


def mbv2_calls():
    """MobileNetV2's 17 depthwise calls at 224x224: (H, W, C, k, stride)."""
    from inference_efficient_vision_models_tpu_torch.models.mobilenet import mobilenet_v2_spec

    spec, h, calls = mobilenet_v2_spec("mobilenet_v2", 6), 112, []
    for s, depth in enumerate(spec.depths):
        for b in range(depth):
            stride = spec.block_stride(s, b)
            calls.append((h, h, spec.hidden_widths[s][b], 3, stride))
            h = (h - 1) // stride + 1
    return calls


def test_plan_at_mbv2_calls():
    """Kernel E's plan takes MobileNetV2's 17 calls at batch 256, C 32 at 112^2
    (s0b0) and the 7^2 maps with C 960 among them."""
    calls = mbv2_calls()
    assert len(calls) == 17
    assert calls[0] == (112, 112, 32, 3, 1) and calls[-1] == (7, 7, 960, 3, 1)
    for h, w, c, k, stride in calls:
        p = check_plan(BATCH, h, w, c, k, stride, waves=True)
        assert covered_once(p), (h, c, stride)
        thread_items(p)
