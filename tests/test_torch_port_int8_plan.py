"""The tile plan of kernel A (``ops/int8_matmul.py:tile_plan``), on the CPU.

The CUDA kernel takes its grid, tile width, N groups, ring depth and panel
window from this function and lays out its shared memory by the same
formula as ``smem_bytes``. Checked for every kernel-A call the served models
make (ResNet18, EfficientNet-B0, ViT-Tiny on both activation carriers, batch
256 and 1, the shapes ``chip_smoke.py`` drives) and for the odd shapes the
card tests use: the block's shared memory fits in 227 KB, every output tile
is computed by exactly one block, and M = 50,432 rows take one N group.
"""

import os

import pytest
import torch

from chip_smoke import (
    ARTIFACT,
    EFF_ARTIFACT,
    VIT_ARTIFACT,
    eff_kernel_a_calls,
    main_path_calls,
    vit_kernel_a_calls,
)
from inference_efficient_vision_models_tpu_torch.compress.quant import qvit
from inference_efficient_vision_models_tpu_torch.compress.quant.fusedpath import (
    load_static_int8_fused,
)
from inference_efficient_vision_models_tpu_torch.compress.quant.qresnet import load_static_int8
from inference_efficient_vision_models_tpu_torch.ops.int8_matmul import (
    K_CHUNK,
    MAX_STAGES,
    SMEM_LIMIT,
    TilePlan,
    smem_bytes,
    tile_plan,
)

_ACT = {None: 0, "relu": 1, "gelu": 2, "gelu_tanh": 3}
_OUT = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def kinds(kw: dict):
    """(out_kind, act) of a call's keyword arguments, as the wrapper reads them."""
    act = "relu" if kw.get("relu") else kw.get("act")
    out = torch.int8 if kw.get("out_scale") is not None else kw.get("out_dtype", torch.float32)
    return _OUT[out], _ACT[act]


def check_plan(m: int, k: int, n: int, out_kind: int, act: int) -> TilePlan:
    p = tile_plan(m, k, n, out_kind, act)
    assert p.bn in (64, 128, 192, 256)
    assert 2 <= p.stages <= MAX_STAGES
    assert p.nchunks == -(-k // K_CHUNK) and 1 <= p.window <= p.nchunks
    assert p.smem == smem_bytes(p.bn, p.stages, p.window, out_kind, p.tiles_per_group * p.bn)
    assert p.smem <= SMEM_LIMIT == 227 * 1024
    # the columns: tiles of bn cover [0, n), the last one ragged at most
    assert p.tiles == -(-n // p.bn) and (p.tiles - 1) * p.bn < n <= p.tiles * p.bn
    assert p.groups * p.tiles_per_group >= p.tiles > (p.groups - 1) * p.tiles_per_group
    # the rows: block x takes slices x, x + grid_m, ...; every (slice, tile) once
    assert p.mblocks == -(-m // 128) and 1 <= p.grid_m <= p.mblocks
    seen = {}
    for bx in range(p.grid_m):
        for mb in range(bx, p.mblocks, p.grid_m):
            for g in range(p.groups):
                for t in range(g * p.tiles_per_group, min((g + 1) * p.tiles_per_group, p.tiles)):
                    seen[mb, t] = seen.get((mb, t), 0) + 1
    assert len(seen) == p.mblocks * p.tiles and set(seen.values()) == {1}
    if m >= 128 * 132:
        assert p.groups == 1
    return p


def served_calls():
    """(path, batch, label, (M, K), x dtype, N, out_kind, act) of every kernel-A call
    of one forward of each served model, at batch 256 and 1."""
    resnet = load_static_int8(ARTIFACT, device="cpu")
    effnet = load_static_int8_fused(EFF_ARTIFACT, device="cpu")
    vits = {"vit_tiny_int8": qvit.load_static_int8(VIT_ARTIFACT, "cpu", act_dtype=torch.float32),
            "vit_tiny_int8_bf16": qvit.load_static_int8(VIT_ARTIFACT, "cpu",
                                                        act_dtype=torch.bfloat16)}
    out = []
    for b in (256, 1):
        for kernel, label, shape, dt, leaf, kw in main_path_calls(resnet, b):
            if kernel == "int8_matmul_requant":
                out.append(("resnet18", b, label, shape, dt, leaf["w"].n, *kinds(kw)))
        for _, label, shape, dt, leaf, kw in eff_kernel_a_calls(effnet, b):
            out.append(("efficientnet_b0", b, label, shape, dt, leaf["w"].n, *kinds(kw)))
        for path, model in vits.items():
            for label, shape, dt, leaf, kw, _ in vit_kernel_a_calls(model, b):
                out.append((path, b, label, shape, dt, leaf["w"].n, *kinds(kw)))
    return out


@pytest.fixture(scope="module")
def calls():
    return served_calls()


@pytest.mark.parametrize("path", ["resnet18", "efficientnet_b0", "vit_tiny_int8",
                                  "vit_tiny_int8_bf16"])
@pytest.mark.parametrize("batch", [256, 1])
def test_served_calls_have_a_valid_plan(calls, path, batch):
    mine = [c for c in calls if c[0] == path and c[1] == batch]
    assert len(mine) == {"resnet18": 8, "efficientnet_b0": 3}.get(path, 6)
    for _, _, label, (m, k), dtype, n, out_kind, act in mine:
        p = check_plan(m, k, n, out_kind, act)
        if p.stream:
            # only an int8 input with a long K (im2col of a stride-2 conv)
            # streams A in windows; a float input is quantized once per group
            assert dtype == torch.int8 and k >= 1008, (path, label, p)


@pytest.mark.parametrize("k", [13, 27, 192, 504, 768, 1280, 2016, 4104])
def test_odd_shapes_have_a_valid_plan(k):
    for n in (6, 37, 192, 456, 576, 768, 1000, 1280):
        for m in (1, 197, 50432):
            for out_kind in (0, 1, 2):
                for act in (0, 1, 2, 3):
                    check_plan(m, k, n, out_kind, act)


def test_plan_follows_the_grid_and_the_panel_budget():
    # M = 50,432 (ViT-Tiny, batch 256): one N group, one persistent block per SM
    p = tile_plan(50432, 192, 576, 2)
    assert (p.groups, p.grid_m, p.bn, p.tiles, p.stream) == (1, 132, 192, 3, False)
    # batch 1 (M = 197): 64-wide tiles in N groups, so the grid has 18 blocks
    p = tile_plan(197, 192, 576, 1)
    assert (p.bn, p.groups, p.grid_m) == (64, 9, 2)
    # a K too long for the panel streams A in windows
    p = tile_plan(12544, 4104, 1000, 1)
    assert p.stream and p.window >= 1
    # two blocks per SM at a 64-wide tile when half the shared memory holds one
    p = tile_plan(3211264, 27, 32, 0, 1)
    assert p.bn == 64 and p.grid_m == 264 and 2 * p.smem <= SMEM_LIMIT
    assert os.path.exists(ARTIFACT)
