"""Kernel C's first launch (expand + depthwise, ``csrc/fused_mbconv.cu``) as
the CUDA kernel computes it, on the CPU.

The kernel keeps the hidden map as one byte per value (the requantized
quint8 q, or the shifted input without expand), pads it with the hidden zero
point, and takes the depthwise sum as an integer, tile by tile of
``expand_dw_plan``. ``launch1_by_tiles`` does the same in PyTorch (the sum as
``sum(w * q) - zp * sum(w)`` in int32) and the block's remaining steps as the
plain version takes them; the result must equal ``fused_mbconv_block_plain``
bit for bit, and every output must come from exactly one tile. The plan is
checked for every EfficientNet-B0 block at batch 256 and 1 and at the odd
shapes of ``chip_smoke.py``: shared memory within 227 KB, the grid within
CUDA's limits, the channel tile from Ce.
"""

import numpy as np
import pytest
import torch

from chip_smoke import EFF_ARTIFACT, random_block
from inference_efficient_vision_models_tpu_torch.compress.quant.fusedpath import (
    block_plan,
    load_static_int8_fused,
)
from inference_efficient_vision_models_tpu_torch.ops import fused_mbconv as fm
from inference_efficient_vision_models_tpu_torch.ops.fused_mbconv import (
    DW_MAP_LIMIT,
    DW_SMEM_LIMIT,
    MAP_PAD,
    ExpandDwPlan,
    act_plain,
    expand_dw_plan,
    expand_dw_smem,
    fused_mbconv_block,
    fused_mbconv_block_plain,
    se_gate_plain,
    to_device_packed,
)


def launch1_by_tiles(x, packed, kernel, stride, act, plan):
    """-> (yq (N, Ho, Wo, Ce) int8, how often each output was written)."""
    sc = packed["scal"]
    n, h, w, cin = x.shape
    pad, ho, wo = fm._out_hw(h, w, kernel, stride)
    if "we" in packed:
        acc = x.reshape(-1, cin).double() @ packed["we"].kn().double()
        y = act_plain(acc.float() * packed["ve"][0] + packed["ve"][1], act)
        q = fm._requant_q(y, sc[fm.INV_E], sc[fm.E_ZP]).reshape(n, h, w, -1).to(torch.uint8)
        zp = int(sc[fm.E_ZP])
    else:
        q = (x.int() + 128).to(torch.uint8)
        zp = int(sc[fm.ZP_S_IN]) + 128
    ce = q.shape[-1]
    wdw = packed["wdw"].round().int()
    wsum = wdw.sum(0)
    yq = torch.zeros((n, ho, wo, ce), dtype=torch.int8)
    seen = torch.zeros((n, ho, wo, ce), dtype=torch.int32)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            for ctile in range(plan.ctiles):
                oy0, ox0, c0 = ty * plan.th, tx * plan.tw, ctile * plan.ct
                c1 = min(c0 + plan.ct, ce)
                iy0, ix0 = oy0 * stride - pad, ox0 * stride - pad
                # the tile's byte map, the hidden zero outside the image
                region = torch.full((n, plan.rh, plan.rw, c1 - c0), zp, dtype=torch.uint8)
                ys, xs = max(iy0, 0), max(ix0, 0)
                ye, xe = min(iy0 + plan.rh, h), min(ix0 + plan.rw, w)
                region[:, ys - iy0 : ye - iy0, xs - ix0 : xe - ix0] = q[:, ys:ye, xs:xe, c0:c1]
                th, tw = min(plan.th, ho - oy0), min(plan.tw, wo - ox0)
                acc = torch.zeros((n, th, tw, c1 - c0), dtype=torch.int32)
                for dy in range(kernel):
                    for dx in range(kernel):
                        sl = region[:, dy : dy + (th - 1) * stride + 1 : stride,
                                    dx : dx + (tw - 1) * stride + 1 : stride].int()
                        acc += sl * wdw[dy * kernel + dx, c0:c1]
                acc -= zp * wsum[c0:c1]
                y = act_plain(acc.float() * packed["vdw"][0][c0:c1] + packed["vdw"][1][c0:c1], act)
                yq[:, oy0 : oy0 + th, ox0 : ox0 + tw, c0:c1] = (
                    fm._requant_q(y, sc[fm.INV_D], sc[fm.D_ZP]) - 128.0).to(torch.int8)
                seen[:, oy0 : oy0 + th, ox0 : ox0 + tw, c0:c1] += 1
    return yq, seen


def block_from_launch1(yq, packed, x_res):
    """The block's remaining steps (SE gate, project, residual, requant) on
    launch 1's output, as ``fused_mbconv_block_plain`` takes them."""
    sc = packed["scal"]
    n, ho, wo, ce = yq.shape
    yq_d = (yq.float() + 128.0) - sc[fm.D_ZP]
    hf = yq_d * sc[fm.D_SCALE]
    if "srw" in packed:
        g = se_gate_plain(yq_d.double().sum(dim=(1, 2)), packed, sc[fm.D_SCALE] / (ho * wo))
        hf = hf * g[:, None, None, :]
    hq = (fm._requant_q(hf, sc[fm.INV_Q], sc[fm.Q_ZP]) - 128.0).to(torch.int8)
    wp = packed["wp"]
    accp = hq.reshape(-1, ce).double() @ wp.kn().double()
    yp = (accp.float() * packed["vp"][0] + packed["vp"][1]).reshape(n, ho, wo, wp.n)
    if x_res is not None:
        yp = yp + (x_res.float() - sc[fm.RES_ZP_S]) * sc[fm.RES_SCALE]
    return (fm._requant_q(yp, sc[fm.INV_O], sc[fm.O_ZP]) - 128.0).to(torch.int8)


# (n, h, w, cin, ce, co, se, k, stride, expand, act): Ce of 32, 96, 144 and
# one that no channel tile divides, Cin of 16, k5 at stride 2, no expand
CASES = [
    (2, 20, 20, 32, 32, 16, 8, 3, 1, False, "silu"),
    (2, 24, 24, 16, 96, 24, 4, 3, 2, True, "silu"),
    (1, 14, 14, 24, 144, 40, 6, 5, 2, True, "silu"),
    (2, 9, 11, 24, 100, 24, 0, 5, 1, True, "relu6"),
    (1, 17, 13, 8, 8, 16, 2, 3, 2, False, "silu"),
    (2, 7, 7, 40, 240, 40, 10, 5, 1, True, "silu"),
    (2, 9, 9, 32, 200, 48, 8, 1, 1, True, "silu"),
]


def _block(case, seed):
    n, h, w, cin, ce, co, se, k, stride, expand, act = case
    rng = np.random.default_rng(seed)
    p_np, in_zp = random_block(rng, cin=cin, ce=ce, co=co, se=se, k=k, expand=expand)
    packed = to_device_packed(p_np, "cpu")
    x = torch.from_numpy(np.clip(np.rint(rng.normal(in_zp - 118, 30, (n, h, w, cin))), -128,
                                 127).astype(np.int8))
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    res = x if (stride, cin) == (1, co) else None
    return packed, x, res, ho, wo


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:5])) + f"_k{c[7]}s{c[8]}")
def test_byte_map_launch_equals_plain_block(case):
    n, h, w, cin, ce, co, se, k, stride, expand, act = case
    packed, x, res, ho, wo = _block(case, sum(case[:8]))
    plan = expand_dw_plan(h, w, cin, ce, k, stride, expand)
    small = ExpandDwPlan(plan.ct, min(5, ho), min(3, wo), (min(5, ho) - 1) * stride + k,
                         (min(3, wo) - 1) * stride + k, -(-ho // min(5, ho)), -(-wo // min(3, wo)),
                         plan.ctiles, plan.kc, 0)
    ref = fused_mbconv_block_plain(x, packed, kernel=k, stride=stride, act=act, x_res=res)
    for p in (plan, small):  # the served plan, and many ragged tiles
        yq, seen = launch1_by_tiles(x, packed, k, stride, act, p)
        assert bool((seen == 1).all())
        got = block_from_launch1(yq, packed, res)
        assert torch.equal(got, ref)
    assert got.float().std() > 2  # the requants land mid-range, not on a clip


def test_byte_map_launch_on_the_artifact_blocks():
    """Every block of the committed EfficientNet-B0, at 12 x 12 and batch 2."""
    model = load_static_int8_fused(EFF_ARTIFACT, device="cpu")
    rng = np.random.default_rng(0)
    for name, k, stride, residual in block_plan(model.spec):
        packed = model.qf[name]
        cin = packed["we"].k if "we" in packed else packed["wdw"].shape[-1]
        zp = int(packed["scal"][fm.ZP_S_IN]) + 128
        x = torch.from_numpy(np.clip(np.rint(rng.normal(zp - 118, 30, (2, 12, 12, cin))), -128,
                                     127).astype(np.int8))
        res = x if residual else None
        plan = expand_dw_plan(12, 12, cin, packed["wdw"].shape[-1], k, stride, "we" in packed)
        yq, seen = launch1_by_tiles(x, packed, k, stride, "silu", plan)
        assert bool((seen == 1).all()), name
        ref = fused_mbconv_block_plain(x, packed, kernel=k, stride=stride, act="silu", x_res=res)
        assert torch.equal(block_from_launch1(yq, packed, res), ref), name
        # on a CPU tensor the wrapper takes the plain version
        assert torch.equal(fused_mbconv_block(x, packed, kernel=k, stride=stride, act="silu",
                                              x_res=res), ref)


def b0_blocks():
    """(name, h, cin, ce, k, stride, expand) of every block of the served
    EfficientNet-B0 at 224 x 224."""
    model = load_static_int8_fused(EFF_ARTIFACT, device="cpu")
    h = model.q["stem"]["e"].shape[1]
    out = []
    for name, k, stride, _ in block_plan(model.spec):
        packed = model.qf[name]
        ce = packed["wdw"].shape[-1]
        cin = packed["we"].k if "we" in packed else ce
        out.append((name, h, cin, ce, k, stride, "we" in packed, packed))
        h = (h - 1) // stride + 1
    return out


def check_plan(n, h, w, cin, ce, k, stride, expand, kp_e=None):
    p = expand_dw_plan(h, w, cin, ce, k, stride, expand)
    _, ho, wo = fm._out_hw(h, w, k, stride)
    assert p.ct in (32, 48)
    assert p.ct == min((32, 48), key=lambda c: (-(-ce // c) * c, c))
    assert 1 <= p.th <= ho and 1 <= p.tw <= wo
    assert (p.rh, p.rw) == ((p.th - 1) * stride + k, (p.tw - 1) * stride + k)
    # the tiles cover the output once: the last one ragged at most
    assert (p.tiles_y - 1) * p.th < ho <= p.tiles_y * p.th
    assert (p.tiles_x - 1) * p.tw < wo <= p.tiles_x * p.tw
    assert (p.ctiles - 1) * p.ct < ce <= p.ctiles * p.ct
    assert p.rh * p.rw * (p.ct + MAP_PAD) <= DW_MAP_LIMIT
    assert p.smem == expand_dw_smem(p.rh * p.rw, p.ct, p.kc, k, expand) <= DW_SMEM_LIMIT
    assert DW_SMEM_LIMIT == 227 * 1024
    # the grid: (tiles, channel tiles, images)
    assert p.tiles_y * p.tiles_x < 2**31 and p.ctiles <= 65535 and n <= 65535
    if expand:
        assert p.kc % 32 == 0 and cin <= p.kc < cin + 32
        if kp_e is not None:
            assert p.kc <= kp_e  # the kernel reads the packed weight's first kc bytes
    else:
        assert p.kc == 0 and cin == ce
    return p


@pytest.mark.parametrize("batch", [256, 1])
def test_b0_blocks_have_a_valid_plan(batch):
    blocks = b0_blocks()
    assert len(blocks) == 16
    for name, h, cin, ce, k, stride, expand, packed in blocks:
        p = check_plan(batch, h, h, cin, ce, k, stride, expand,
                       packed["we"].wt.shape[1] if expand else None)
        # three blocks of at most 227 KB / 3 fit on an SM
        assert 3 * p.smem <= DW_SMEM_LIMIT, name
    cts = {ce: expand_dw_plan(h, h, cin, ce, k, s, e).ct for _, h, cin, ce, k, s, e, _ in blocks}
    assert cts == {32: 32, 96: 32, 144: 48, 240: 48, 480: 32, 672: 32, 1152: 32}


def test_odd_shapes_have_a_valid_plan():
    odd = [(3, 12, 12, 24, 36, 3, 1, True), (2, 10, 10, 40, 40, 3, 1, False),
           (2, 7, 9, 24, 36, 5, 1, True), (2, 15, 15, 16, 100, 3, 2, True),
           (3, 13, 11, 22, 38, 5, 2, True), (2, 20, 20, 72, 72, 5, 1, False),
           (2, 9, 9, 32, 200, 1, 1, True), (1, 33, 31, 8, 8, 3, 2, False),
           (1, 40, 38, 8, 8, 3, 2, False), (2, 112, 112, 32, 32, 3, 1, False),
           (1, 1, 1, 8, 48, 3, 1, True), (4, 300, 5, 16, 1000, 5, 2, True)]
    for case in odd:
        check_plan(*case)


def test_plan_trades_halo_against_ragged_tiles():
    # s1b0 (112 -> 56, k3 s2): 14 x 14 outputs from 29 x 29 inputs, 16 tiles
    p = expand_dw_plan(112, 112, 16, 96, 3, 2, True)
    assert (p.ct, p.th, p.rh, p.tiles_y * p.tiles_x, p.ctiles, p.kc) == (32, 14, 29, 16, 3, 32)
    # s0b0 (no expand, 112^2, k3): 28 x 28 tiles, the input copied once
    p = expand_dw_plan(112, 112, 32, 32, 3, 1, False)
    assert (p.th, p.tw, p.kc) == (28, 28, 0)
    # 7 x 7 maps: one tile per image and channel tile
    p = expand_dw_plan(7, 7, 192, 1152, 5, 1, True)
    assert (p.th, p.tw, p.ctiles, p.kc) == (7, 7, 36, 192)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    """Non-integer depthwise weights break the exact integer sums: refused at load."""
    p_np, _ = random_block(np.random.default_rng(0), cin=8, ce=16, co=8, se=0, k=3, expand=True)
    p_np["wdw"] = p_np["wdw"] + 0.5
    with pytest.raises(ValueError):
        to_device_packed(p_np, "cpu")


@pytest.mark.parametrize("batch", [256, 1])
def test_mbv2_blocks_have_a_valid_plan(batch):
    """Kernel C's first launch takes MobileNetV2's 17 blocks (k 3, stride 1
    or 2, 112^2 down to 7^2; s0b0 without expand at Cin = Ce = 32, s1b0
    expanding 16 -> 96 at 112^2 with stride 2), three blocks to an SM."""
    from inference_efficient_vision_models_tpu_torch.models.mobilenet import mobilenet_v2_spec

    spec, h, n = mobilenet_v2_spec("mobilenet_v2", 6), 112, 0
    for s, depth in enumerate(spec.depths):
        for b in range(depth):
            stride, cin, ce = spec.block_stride(s, b), spec.block_in_width(s, b), \
                spec.hidden_widths[s][b]
            p = check_plan(batch, h, h, cin, ce, 3, stride, spec.has_expand[s][b])
            assert 3 * p.smem <= DW_SMEM_LIMIT, (s, b)
            h, n = (h - 1) // stride + 1, n + 1
    assert n == 17 and h == 7
