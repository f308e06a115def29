"""Kernel D's route and grid (``ops/fused_dense.py:dense_plan``), on the CPU.

The CUDA kernel takes its route and grid from this function and lays out the
Hopper route's shared memory by the same formula as ``wgmma_smem_bytes``.
Checked at the float ViT-Tiny's mlp1 (batch 256 and 1) and at the odd shapes
``chip_smoke.py`` drives: shared memory within 227 KB, one block per SM, and
every 64-row tile taken by exactly one consumer warpgroup.
"""

import pytest
import torch

from inference_efficient_vision_models_tpu_torch.ops.fused_dense import (
    NUM_SMS,
    SMEM_LIMIT,
    WGMMA_CONSUMERS,
    WGMMA_TM,
    dense_plan,
    wgmma_smem_bytes,
)

ODD = [(77, 40, 24), (300, 72, 168), (333, 13, 37), (1000, 768, 192), (129, 8, 8),
       (5, 200, 130), (4097, 72, 24), (50, 16, 1000), (3000, 192, 8), (64, 192, 136),
       (65, 184, 200)]


def check_wgmma_plan(m, k, n):
    p = dense_plan(m, k, n, torch.bfloat16, True)
    assert p.route == 1
    assert p.smem == wgmma_smem_bytes(k) <= SMEM_LIMIT == 227 * 1024
    assert p.grid_n == -(-n // 128) and p.grid_m * p.grid_n <= NUM_SMS
    # block x's warpgroup g takes tiles c x + g, c x + g + c grid_m, ... (c warpgroups)
    c = WGMMA_CONSUMERS
    mtiles = -(-m // WGMMA_TM)
    seen = [0] * mtiles
    for bx in range(p.grid_m):
        for g in range(c):
            for t in range(c * bx + g, mtiles, c * p.grid_m):
                seen[t] += 1
    assert seen == [1] * mtiles
    # no block without a tile (the C entry refuses such a grid)
    assert c * (p.grid_m - 1) < mtiles
    return p


@pytest.mark.parametrize("m", [256 * 197, 197])
def test_served_mlp1_takes_the_hopper_route(m):
    p = check_wgmma_plan(m, 192, 768)
    if m == 256 * 197:  # one block per SM: 22 M groups x 6 column slices
        assert (p.grid_m, p.grid_n) == (22, 6)
    else:
        assert (p.grid_m, p.grid_n) == (2, 6)


@pytest.mark.parametrize("m,k,n", ODD)
def test_odd_shapes_route(m, k, n):
    hopper = k % 8 == 0 and n % 8 == 0 and k <= 192
    assert dense_plan(m, k, n, torch.bfloat16, True).route == int(hopper)
    if hopper:
        check_wgmma_plan(m, k, n)
    # fp32 (exact FMAs on the CUDA cores) and unaligned pointers take the general route
    assert dense_plan(m, k, n, torch.float32, True).route == 0
    assert dense_plan(m, k, n, torch.bfloat16, False).route == 0
