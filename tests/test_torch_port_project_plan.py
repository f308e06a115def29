"""Kernel C's launches 2 and 3 (``csrc/fused_mbconv.cu``) around the CUDA
code, on the CPU.

- ``ops/fused_mbconv.py:project_plan``, the project launch's tiles, at
  EfficientNet-B0's 16 blocks and MobileNetV2's 17 (batch 256 and 1), at
  the stage chains' pruned widths and at odd shapes: shared memory within
  227 KB and equal to the layout's sum, widths the s8 wgmma takes, the
  block columns covering Co once, the gate rows of every panel's images
  (gi), the blocks that fit on an SM at once, and a grid that fills the card
  where the panels allow.
- A replay in torch of the project launch's data path, equal bit for bit to
  ``_project_plain``: the transform once per byte (the 256-entry table
  without SE; with SE, the gate of the row's image found by the kernel's
  multiply-shift division, from the panel's gate rows, and q - d_zp as
  (2^23 + q) - (2^23 + d_zp)), K padded to 32 with stale bytes against the
  packed weight's zeros, N padded to the plan's widths, int32 sums by K
  slice, the accumulator's conversion by a magic constant where Ce <= 256,
  the residual byte by another, and the requant in the integer domain (the
  bits of y * inv + 1.5 * 2^23, less a constant, clipped).
- A replay of the SE-gate launch as the kernel groups it (images per block,
  weight chunks, FC1's row groups and their partial sums in order), equal
  to ``se_gate_plain``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import EFF_ARTIFACT, PROJECT_TINY_SCALE, TINY_SCALE, project_inputs, random_block
from inference_efficient_vision_models_tpu_torch.compress.quant.fusedpath import (
    block_plan,
    load_static_int8_fused,
)
from inference_efficient_vision_models_tpu_torch.ops import fused_mbconv as fm
from inference_efficient_vision_models_tpu_torch.ops.fused_mbconv import (
    DW_SMEM_LIMIT,
    NUM_SMS,
    PJ_BM,
    PJ_KS,
    PJ_NARROW,
    PJ_SM_SMEM,
    PJ_THREADS,
    PJ_TNS,
    SE_CHUNK,
    SE_GROUPS,
    SE_THREADS,
    project_plan,
    project_smem,
    se_gate_group,
    se_gate_plain,
    se_gate_smem,
    to_device_packed,
)
from port_block_launches import C_ABLATIONS, MBV2_BLOCKS, SE_ABLATIONS

MAGIC = 12582912.0  # 1.5 * 2^23
MAGIC_BITS = 0x4B400000

_B0 = []


def b0_blocks():
    """(name, output side, Ce, Co, residual, packed) of the committed
    EfficientNet-B0's 16 blocks at 224 x 224 (all with SE)."""
    if not _B0:
        model = load_static_int8_fused(EFF_ARTIFACT, device="cpu")
        h = model.q["stem"]["e"].shape[1]
        for name, k, stride, residual in block_plan(model.spec):
            h = (h - 1) // stride + 1
            packed = model.qf[name]
            _B0.append((name, h, packed["wdw"].shape[-1], packed["wp"].n, residual, packed))
    return _B0


def mbv2_blocks():
    """(name, output side, Ce, Co, residual) of MobileNetV2's 17 blocks (no SE)."""
    return [(name, (h - 1) // s + 1, ce, co, res) for name, h, _, ce, co, _, s, res in MBV2_BLOCKS]


# the stage chains' pruned widths at 224 x 224 (round_to 8): (output side, Ce, Co, residual)
B0_PRUNED = [(112, 24, 16, False), (56, 80, 16, False), (56, 112, 16, True),
             (28, 112, 32, False), (28, 192, 32, True), (14, 192, 64, False),
             (14, 384, 64, True), (14, 384, 88, False), (14, 536, 88, True),
             (7, 536, 152, False), (7, 920, 152, True), (7, 920, 256, False)]
MBV2_PRUNED = [(112, 24, 16, False), (56, 80, 16, False), (56, 112, 16, True),
               (28, 112, 24, False), (28, 152, 24, True), (14, 152, 48, False),
               (14, 304, 48, True), (14, 304, 80, False), (14, 464, 80, True),
               (7, 464, 128, False), (7, 768, 128, True), (7, 768, 256, False)]
# (M, HWo, Ce, Co): Ce not a multiple of 4 or 8, Co not a multiple of 8,
# 7 x 7 maps whose images straddle panels, 1 x 1 maps, Co past 320, tiny M
ODD = [(2 * 63, 63, 37, 20), (3 * 49, 49, 38, 30), (5 * 49, 49, 100, 37), (225, 225, 24, 16),
       (200, 1, 96, 24), (2 * 49, 49, 200, 330), (49, 49, 1152, 320), (8, 4, 40, 8),
       (7 * 49, 49, 1000, 41), (81, 81, 64, 8)]


def served_shapes(batch):
    """(M, HWo, Ce, Co, se, residual) of every B0 and MobileNetV2 block and of
    both chains' blocks at ``batch``."""
    out = [(batch * h * h, h * h, ce, co, True, res) for _, h, ce, co, res, _ in b0_blocks()]
    out += [(batch * h * h, h * h, ce, co, False, res) for _, h, ce, co, res in mbv2_blocks()]
    out += [(batch * h * h, h * h, ce, co, True, res) for h, ce, co, res in B0_PRUNED]
    out += [(batch * h * h, h * h, ce, co, False, res) for h, ce, co, res in MBV2_PRUNED]
    return out


def check_plan(m, hwo, ce, co, se, residual):
    p = project_plan(m, hwo, ce, co, se, residual)
    assert p.tn in PJ_TNS and p.tn % 8 == 0 and (p.tn <= 32 or p.tn % 16 == 0)
    assert p.wg_n >= 1 and p.threads == 128 * p.wg_n <= PJ_THREADS and p.nb == p.wg_n * p.tn
    # the block columns cover Co once: no block is empty, tn the narrowest width that covers
    assert p.nb * p.nsplit >= co > p.nb * (p.nsplit - 1)
    assert all(t * p.wg_n * p.nsplit < co for t in PJ_TNS if t < p.tn)
    assert p.kc % 32 == 0 and ce <= p.kc < ce + 32 and p.nch == -(-ce // PJ_KS)
    assert 2 <= p.stages <= 6
    assert p.smem == project_smem(p.nb, p.nch, p.stages, p.resident, p.gi, co, se,
                                  residual) <= DW_SMEM_LIMIT
    # blocks that fit at once: shared memory and the registers the kernel is built for
    assert p.blocks_per_sm * (p.smem + 1024) <= PJ_SM_SMEM
    assert p.blocks_per_sm * p.threads <= (1024 if p.tn <= PJ_NARROW else 512)
    assert p.panels == -(-m // PJ_BM) and 1 <= p.grid <= p.panels
    assert p.grid * p.nsplit >= min(NUM_SMS, p.panels * p.nsplit)  # the grid fills the card
    assert p.grid * p.nsplit <= NUM_SMS * p.blocks_per_sm  # and every block is resident at once
    # gi holds the images of every panel
    first = np.arange(p.panels, dtype=np.int64) * PJ_BM
    last = np.minimum(first + PJ_BM, m) - 1
    assert int((last // hwo - first // hwo).max()) + 1 <= p.gi <= m // hwo
    return p


@pytest.mark.parametrize("batch", [256, 1])
def test_plans_at_the_served_and_pruned_blocks(batch):
    shapes = served_shapes(batch)
    assert len(shapes) == 16 + 17 + 12 + 12
    plans = [check_plan(*s) for s in shapes]
    if batch == 256:
        # one warpgroup along N up to Co 160, two at 192 and 320; none split across blocks
        assert {(co, p.wg_n, p.nsplit) for (_, _, _, co, _, _), p in zip(shapes, plans)
                if co in (16, 160, 192, 320)} == {(16, 1, 1), (160, 1, 1), (192, 2, 1),
                                                  (320, 2, 1)}
        assert all(p.grid * p.nsplit >= NUM_SMS for p in plans)
    else:  # batch 1: 7 x 7 maps are one panel; Co split in two
        assert all(p.nsplit == 2 for (m, _, _, co, _, _), p in zip(shapes, plans)
                   if m == 49 and co > 8)


def test_plans_at_odd_shapes():
    for m, hwo, ce, co in ODD:
        for se in (False, True):
            for residual in (False, True):
                check_plan(m, hwo, ce, co, se, residual)
    with pytest.raises(ValueError):
        project_plan(100, 7, 32, 16, True, False)  # M not a multiple of HWo


def test_se_gate_groups():
    for n in (1, 2, 7, 132, 133, 256):
        for _, h, ce, co, _, packed in b0_blocks()[::3]:
            se = packed["srw"].shape[1]
            g = se_gate_group(n, ce, se)
            assert g in SE_GROUPS and se_gate_smem(g, ce, se) <= DW_SMEM_LIMIT
            assert -(-n // g) <= NUM_SMS or g == SE_GROUPS[-1]
    assert se_gate_group(256, 1152, 48) == 2 and se_gate_group(1, 1152, 48) == 1


# --------------------------------------------------------------------------
# the project launch's data path


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.float32)


def requant_u8(y: torch.Tensor, inv: float, zp: float) -> torch.Tensor:
    """int8_gemm.cuh requant_u8: clip(((y * inv) + M) - (M - zp), 0, 255), M = 1.5 * 2^23."""
    v = ((y * np.float32(inv)) + np.float32(MAGIC)) - (np.float32(MAGIC) - np.float32(zp))
    return (_i32(v.clamp(0.0, 255.0) + np.float32(8388608.0)).long() & 255)


def requant_zi(y: torch.Tensor, inv: float, zp: float, floor: bool = True) -> torch.Tensor:
    """The kernel's requant: bits(max(y * inv, -2^22) + 1.5 * 2^23) - (bits(1.5 * 2^23) - zp)
    in int32 arithmetic (wrapping as the GPU's does), clipped; ``floor=False``
    leaves out the raise to -2^22."""
    v = y * np.float32(inv)
    if floor:
        v = torch.clamp(v, min=-4194304.0)
    d = _i32(v + np.float32(MAGIC)) - torch.tensor(MAGIC_BITS - int(zp), dtype=torch.int32)
    assert d.dtype == torch.int32
    return d.long().clamp(0, 255)


def image_of(rows: torch.Tensor, hwo: int) -> torch.Tensor:
    """The kernel's m / HWo: (m * ceil(2^(31 + l) / HWo)) >> (31 + l)."""
    l = max(0, (hwo - 1).bit_length())
    mul = -(-(1 << (31 + l)) // hwo)
    assert mul < 2**32
    return (rows.long() * mul) >> (31 + l)


def replay_project(yq, g, wp, vp, x_res, sc, plan, gen, floor=True):
    """Launch 3 as the kernel computes it -> (N, Ho, Wo, Co) int8; ``floor=False``:
    the output requant without its raise to -2^22."""
    n, ho, wo, ce = yq.shape
    m, hwo, co = n * ho * wo, ho * wo, wp.n
    u = yq.reshape(m, ce).long() & 255  # the bytes as stored
    q = (u ^ 128).float()  # the quint8 values
    if g is None:  # the table, built by the same fp32 operations
        t = torch.arange(256)
        h = ((t ^ 128).float() - np.float32(sc[fm.D_ZP])) * np.float32(sc[fm.D_SCALE])
        lut = requant_u8(h, sc[fm.INV_Q], sc[fm.Q_ZP]) ^ 128
        a = lut[u]
    else:
        rows = torch.arange(m)
        img = image_of(rows, hwo)
        assert torch.equal(img, rows // hwo)
        # the gate row comes from the panel's slots n_a .. n_a + gi - 1
        n_a = image_of((rows // PJ_BM) * PJ_BM, hwo)
        assert int((img - n_a).max()) < plan.gi
        gate = g[img]
        # (2^23 + q) from the byte's bits, less 2^23 + d_zp
        dzm = torch.tensor(8388608.0, dtype=torch.float32) + np.float32(sc[fm.D_ZP])
        x = _f32((u ^ 128).to(torch.int32) + 0x4B000000) - dzm
        assert torch.equal(x, q - np.float32(sc[fm.D_ZP]))
        h = (x * np.float32(sc[fm.D_SCALE])) * gate
        a = requant_zi(h, sc[fm.INV_Q], sc[fm.Q_ZP]) ^ 128
    a = (a ^ 128) - 128  # the signed project input bytes
    # K padded to 32: whatever the stage held past Ce, against the weight's zeros there
    a = torch.cat([a, torch.randint(-128, 128, (m, plan.kc - ce), generator=gen)], 1)
    # N padded to the plan's columns: the packed rows, then whatever past Np
    ncols = plan.nb * plan.nsplit
    wt = wp.wt[:, : plan.kc].long()
    w = torch.cat([wt, torch.randint(-128, 128, (max(0, ncols - wt.shape[0]), plan.kc),
                                     generator=gen)])[:ncols]
    assert not wt[:, ce:].any()
    # int32 sums, K slice by K slice (k32 steps of 128-byte chunks)
    acc = torch.zeros((m, ncols), dtype=torch.float64)
    for k0 in range(0, plan.kc, 32):
        acc += a[:, k0 : k0 + 32].double() @ w[:, k0 : k0 + 32].double().t()
        assert float(acc[:, :co].abs().max()) < 2**31
    acc = acc[:, :co].long()
    if ce <= 256:  # 1.5 * 2^23 + acc in the float's bits, less 1.5 * 2^23
        assert int(acc.abs().max()) <= 2**22
        af = _f32((acc + MAGIC_BITS).to(torch.int32)) - np.float32(MAGIC)
        assert torch.equal(af, acc.float())
    else:
        af = acc.float()
    y = (af * vp[0]) + vp[1]
    if x_res is not None:
        xb = x_res.reshape(m, co).long() & 255
        xr = _f32(((xb ^ 128) + 0x4B000000).to(torch.int32)) - np.float32(8388736.0)
        y = y + (xr - np.float32(sc[fm.RES_ZP_S])) * np.float32(sc[fm.RES_SCALE])
    out = requant_zi(y, sc[fm.INV_O], sc[fm.O_ZP], floor) - 128
    return out.to(torch.int8).reshape(n, ho, wo, co)


def _launch3_inputs(rng, n, hwo_shape, ce, co, se, residual, packed=None):
    ho, wo = hwo_shape
    if packed is None:
        p_np, _ = random_block(rng, cin=8, ce=ce, co=co, se=4 if se else 0, k=3, expand=True)
        packed = to_device_packed(p_np, "cpu")
    yq = torch.from_numpy(np.clip(np.rint(rng.normal(-100, 40, (n, ho, wo, ce))), -128,
                                  127).astype(np.int8))
    g = (torch.from_numpy(rng.uniform(0.05, 0.95, (n, ce)).astype(np.float32)) if se else None)
    x_res = (torch.from_numpy(rng.integers(-128, 128, (n, ho, wo, co), dtype=np.int8))
             if residual else None)
    return packed, yq, g, x_res


def _check_launch3(packed, yq, g, x_res, seed, floor=True):
    n, ho, wo, ce = yq.shape
    sc, wp = list(packed["scal"]), packed["wp"]
    plan = project_plan(n * ho * wo, ho * wo, ce, wp.n, g is not None, x_res is not None)
    ref = fm._project_plain(yq, g, wp.wt, list(wp.shape), packed["vp"], x_res, sc)
    got = replay_project(yq, g, wp, packed["vp"], x_res, sc, plan,
                         torch.Generator().manual_seed(seed), floor)
    assert got.float().std() > 2  # the requants land mid-range, not on a clip
    return torch.equal(got, ref)


@pytest.mark.parametrize("net", ["efficientnet_b0", "mobilenet_v2"])
def test_project_replay_at_every_block_shape(net):
    """Batch 2 at each block's (Ho, Wo, Ce, Co): B0's packed blocks (SE), or
    MobileNetV2's shapes on random blocks (the table path)."""
    rng = np.random.default_rng(0)
    blocks = ([(name, h, ce, co, res, packed) for name, h, ce, co, res, packed in b0_blocks()]
              if net == "efficientnet_b0" else
              [(name, h, ce, co, res, None) for name, h, ce, co, res in mbv2_blocks()])
    for i, (name, h, ce, co, res, packed) in enumerate(blocks):
        se = net == "efficientnet_b0"
        packed, yq, g, x_res = _launch3_inputs(rng, 2, (h, h), ce, co, se, res, packed)
        if se:  # the served gate lies in (0, 1): a sigmoid
            g = torch.sigmoid(g * 8 - 4)
        assert _check_launch3(packed, yq, g, x_res, i)


@pytest.mark.parametrize("case", ODD, ids=lambda c: "m{}_hw{}_ce{}_co{}".format(*c))
def test_project_replay_at_odd_shapes(case):
    m, hwo, ce, co = case
    side = {63: (7, 9), 49: (7, 7), 225: (15, 15), 1: (1, 1), 4: (2, 2), 81: (9, 9)}[hwo]
    rng = np.random.default_rng(m + ce + co)
    for se, residual in ((True, True), (False, False)):
        packed, yq, g, x_res = _launch3_inputs(rng, m // hwo, side, ce, co, se, residual)
        assert _check_launch3(packed, yq, g, x_res, ce)


def test_project_replay_pruned_chain_shapes():
    rng = np.random.default_rng(1)
    for (h, ce, co, res), se in ([(s, True) for s in B0_PRUNED[::2]]
                                 + [(s, False) for s in MBV2_PRUNED[1::2]]):
        packed, yq, g, x_res = _launch3_inputs(rng, 2, (h, h), ce, co, se, res)
        assert _check_launch3(packed, yq, g, x_res, ce)


@pytest.mark.parametrize("case", PROJECT_TINY_SCALE, ids=["gate", "table"])
def test_project_replay_at_a_tiny_output_scale(case):
    """``chip_smoke.PROJECT_TINY_SCALE``: y * inv_o spans about +-2.4e7, so
    some outputs fall in (-3 * 2^23, -1.5 * 2^23), where the bits of y * inv_o
    + 1.5 * 2^23 less the constant wrap round in int32; the kernel's raise
    to -2^22 keeps them at 0, as the plain version clips them."""
    rng = np.random.default_rng(sum(case[:5]))
    inputs = project_inputs(rng, *case, inv_o_mul=TINY_SCALE, device="cpu")
    assert _check_launch3(*inputs, 0)
    assert not _check_launch3(*inputs, 0, floor=False)  # the window is reached


def test_requant_zi_across_the_float_range():
    """The integer-domain requant equals the plain clip(rint(y * inv) + zp)
    for y * inv from -1e30 to 1e30, rounding ties and the edges of its exact
    range included; without the raise to -2^22 it gives 255 in (-3 * 2^23,
    -1.5 * 2^23)."""
    rng = np.random.default_rng(0)
    mag = 10.0 ** rng.uniform(-3, 30, 20000)
    v = np.concatenate([mag, -mag, np.arange(-300, 300) + 0.5, [0.0, -0.0],
                        [2.0**22, -(2.0**22), 2.0**22 + 1, -(2.0**22) - 1, 1.5 * 2**23,
                         -1.5 * 2**23, 3 * 2**23, -3 * 2**23, 2.0**24, -(2.0**24)]])
    y = torch.from_numpy(v.astype(np.float32))
    for zp in (0, 12, 128, 255):
        ref = fm._requant_q(y, 1.0, float(zp)).long()
        assert torch.equal(requant_zi(y, 1.0, zp), ref)
    window = (y > -3 * 2**23) & (y < -1.5 * 2**23)
    assert int(window.sum()) > 100
    raw = requant_zi(y, 1.0, 12, floor=False)
    assert bool((raw[window] == 255).all()) and torch.equal(raw[~window], requant_zi(y, 1.0, 12)[~window])


# --------------------------------------------------------------------------
# the SE gate


def replay_se_gate(pool, srw, srb, sew, seb, pool_scale):
    """Launch 2 as the kernel groups it: per block of G images, FC1's rows in
    chunks (block b from chunk b mod chunks on, wrapping around), row group q
    of R = 512 / Se summing rows q, q + R, ... of each chunk into its own
    partial sums, added in group order; FC2's rows in chunks in the same
    rotation, each channel's sums carried across them; float64 throughout."""
    n, ce = pool.shape
    se = srw.shape[1]
    group = se_gate_group(n, ce, se)
    r_groups = SE_THREADS // se
    rows1 = SE_CHUNK // se // 4 * 4 if SE_CHUNK // se >= 8 else 4
    rows2 = max(1, SE_CHUNK // ce)
    w1, w2 = srw.double(), sew.double()
    out = torch.empty((n, ce), dtype=torch.float32)
    def rotated(nrows, rows, block):
        nck = -(-nrows // rows)
        return [((k + block) % nck) * rows for k in range(nck)]

    for n0 in range(0, n, group):
        pooled = pool[n0 : n0 + group].double() * pool_scale  # (G, Ce)
        part = torch.zeros((r_groups, pooled.shape[0], se), dtype=torch.float64)
        for c0 in rotated(ce, rows1, n0 // group):
            for q in range(r_groups):
                for c in range(c0 + q, min(c0 + rows1, ce), r_groups):
                    part[q] += pooled[:, c : c + 1] * w1[c]
        s = torch.zeros_like(part[0])
        for q in range(r_groups):
            s = s + part[q]
        v = s + srb.double()
        r = v * (1.0 / (1.0 + torch.exp(-v)))
        acc2 = torch.zeros_like(pooled)
        for j0 in rotated(se, rows2, n0 // group):
            for j in range(j0, min(j0 + rows2, se)):
                acc2 += r[:, j : j + 1] * w2[j]
        out[n0 : n0 + group] = (1.0 / (1.0 + torch.exp(-(acc2 + seb.double())))).float()
    return out


@pytest.mark.parametrize("n,ce,se", [(256, 32, 8), (133, 240, 10), (5, 1152, 48), (3, 100, 5),
                                     (2, 37, 256), (9, 920, 40), (4, 24, 4)])
def test_se_gate_replay(n, ce, se):
    rng = np.random.default_rng(n + ce + se)
    p_np, _ = random_block(rng, cin=8, ce=ce, co=8, se=se, k=3, expand=True)
    packed = to_device_packed(p_np, "cpu")
    pool = torch.from_numpy(rng.integers(-2000, 20000, (n, ce)).astype(np.int32))
    got = replay_se_gate(pool, packed["srw"], packed["srb"], packed["sew"], packed["seb"], 0.01 / 49)
    ref = se_gate_plain(pool, packed, 0.01 / 49)
    assert torch.equal(got, ref)
    assert 0.05 < float(ref.mean()) < 0.95


def test_project_zero_points_the_kernel_takes():
    """The integer-domain requant needs integer zero points in [0, 255]: o_zp
    always, d_zp and q_zp with SE (the table path takes any q_zp and d_zp).
    The CUDA wrapper refuses others before it launches."""
    p_np, _ = random_block(np.random.default_rng(0), cin=8, ce=16, co=8, se=2, k=3, expand=True)
    sc = list(to_device_packed(p_np, "cpu")["scal"])
    fm.check_project_zero_points(sc, gated=True)
    for i, gated in ((fm.O_ZP, False), (fm.D_ZP, True), (fm.Q_ZP, True)):
        bad = list(sc)
        bad[i] = 12.5
        with pytest.raises(ValueError):
            fm.check_project_zero_points(bad, gated)
        bad[i] = 256.0
        with pytest.raises(ValueError):
            fm.check_project_zero_points(bad, gated)
    for i in (fm.D_ZP, fm.Q_ZP):
        ok = list(sc)
        ok[i] = 12.5
        fm.check_project_zero_points(ok, gated=False)


def test_ablation_edits_apply_to_the_kernel_source():
    """``port_block_launches.py --ablate`` builds copies of kernel C with one
    text edit each: every edit must find its line, once."""
    import os

    from inference_efficient_vision_models_tpu_torch.ops import _lib

    src = open(os.path.join(_lib.CSRC, "fused_mbconv.cu")).read()
    for name, (old, new) in {**C_ABLATIONS, **SE_ABLATIONS}.items():
        assert src.count(old) == 1, name
        assert src.replace(old, new) != src, name
