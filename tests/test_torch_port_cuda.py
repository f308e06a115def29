"""The CUDA kernels against their plain versions, on the GPU (marked ``cuda``;
they skip on a machine without one). On a GPU machine without JAX, skip
``tests/conftest.py`` (it sets up the JAX CPU backend):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -m cuda``."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import VIT_SEED, random_block, vit_params_from_seed
from inference_efficient_vision_models_tpu_torch.compress.quant import qvit
from inference_efficient_vision_models_tpu_torch.compress.quant.fusedpath import (
    load_static_int8_fused,
)
from inference_efficient_vision_models_tpu_torch.compress.quant.qresnet import load_static_int8
from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images
from inference_efficient_vision_models_tpu_torch.models import vit
from inference_efficient_vision_models_tpu_torch.ops import (
    _lib,
    conv3x3_s1_int8,
    conv3x3_s1_int8_plain,
    dense_gelu,
    dense_gelu_plain,
    dynamic_qparams,
    fused_mbconv_block,
    fused_mbconv_block_plain,
    int8_matmul_requant,
    int8_matmul_requant_dynamic,
    int8_matmul_requant_dynamic_plain,
    int8_matmul_requant_plain,
    pack_weight,
    to_device_packed,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "bench", "quantization", "r2", "fold_0")
EFF_ARTIFACT = os.path.join(ROOT, "inference_efficient_vision_models_tpu_torch", "testdata",
                            "effnet_b0_int8")
VIT_ARTIFACT = os.path.join(ROOT, "inference_efficient_vision_models_tpu_torch", "testdata",
                            "vit_tiny_int8")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _leaf(rng, shape, dev):
    w = rng.integers(-128, 128, shape, dtype=np.int8)
    n = shape[-1]
    return (pack_weight(torch.from_numpy(w).to(dev)),
            torch.from_numpy(rng.uniform(0.001, 0.01, n).astype(np.float32)).to(dev),
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev),
            torch.from_numpy(w.reshape(-1, n).astype(np.int32).sum(0, dtype=np.int32)).to(dev))


@pytest.mark.parametrize("m,k,n,xin,kw", [
    (77, 56, 6, torch.int8, dict(relu=True, out_scale=0.07, out_zp=122)),
    (1000, 504, 112, torch.int8, dict()),
    (300, 72, 160, torch.float32, dict(act="gelu")),
    (333, 13, 37, torch.bfloat16, dict(act="gelu_tanh", out_dtype=torch.bfloat16)),
])
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n, xin, kw):
    """Kernel A equals its plain version bit for bit (int8, fp32 and bf16 out)."""
    rng = np.random.default_rng(m + k + n)
    w, ws, b, wsum = _leaf(rng, (k, n), cuda)
    if xin == torch.int8:
        x = torch.from_numpy(rng.integers(-128, 128, (m, k), dtype=np.int8)).to(cuda)
    else:
        x = (torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)) * 3).to(cuda, xin)
    before = _lib.launches["int8_matmul_requant"]
    got = int8_matmul_requant(x, w, ws, b, wsum, in_scale=0.05, in_zp=113, **kw)
    ref = int8_matmul_requant_plain(x, w, ws, b, wsum, in_scale=0.05, in_zp=113, **kw)
    torch.cuda.synchronize()
    assert _lib.launches["int8_matmul_requant"] == before + 1
    assert got.dtype == ref.dtype and torch.equal(got, ref)


# every (input dtype, activation, output) of kernel A: 3 x 4 x 3
_A_ROUTES = [(xd, act, out) for xd in (torch.int8, torch.float32, torch.bfloat16)
             for act in (None, "relu", "gelu", "gelu_tanh")
             for out in (torch.int8, torch.float32, torch.bfloat16)]
_A_NS = (6, 37, 192, 456, 576, 768, 1000, 1280)


def _a_input(gen, m, k, dtype, dev):
    if dtype == torch.int8:
        return torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    return (torch.randn((m, k), generator=gen, device=dev) * 3).to(dtype)


def _a_kwargs(act, out):
    kw = dict(in_scale=0.05, in_zp=113, act=act)
    if out == torch.int8:
        return dict(kw, out_scale=0.04, out_zp=120)
    return dict(kw, out_dtype=out)


@pytest.mark.parametrize("m", [1, 197, 50432])
@pytest.mark.parametrize("k", [13, 27, 192, 504, 768, 1280, 2016, 4104])
def test_int8_matmul_kernel_exact_over_shapes(cuda, k, m):
    """Bit-exact against the plain version at every N of the list; three of
    the 36 routes per N, rotating with (K, M) so that the 24 (K, M) cases
    cover every route at every M (panel and windowed A, vector, 4-byte,
    element and contiguous-row loads, N groups, ragged N and K)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k * 1000 + m)
    rng = np.random.default_rng(k + m)
    for i, n in enumerate(_A_NS):
        lf = _leaf(rng, (k, n), cuda)
        for j in range(3):
            xd, act, out = _A_ROUTES[(3 * i + j + 5 * k + m) % len(_A_ROUTES)]
            x = _a_input(gen, m, k, xd, cuda)
            kw = _a_kwargs(act, out)
            got = int8_matmul_requant(x, *lf, **kw)
            ref = int8_matmul_requant_plain(x, *lf, **kw)
            torch.cuda.synchronize()
            assert got.dtype == out and torch.equal(got, ref), (m, k, n, xd, act, out)


@pytest.mark.parametrize("xd", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [13, 27, 504])
def test_int8_matmul_kernel_exact_on_offset_views(cuda, xd, k):
    """Activations that start at an odd element offset, and a view that
    starts one row of odd K into its buffer (no aligned vector loads)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    m, n = 300, 37
    lf = _leaf(np.random.default_rng(k), (k, n), cuda)
    flat = _a_input(gen, 1, (m + 1) * k + 1, xd, cuda)[0]
    for x in (flat[1 : 1 + m * k].view(m, k), flat[k : k + m * k].view(m, k)):
        for act, out in [("gelu", torch.int8), (None, torch.float32), ("relu", torch.bfloat16)]:
            kw = _a_kwargs(act, out)
            got = int8_matmul_requant(x, *lf, **kw)
            ref = int8_matmul_requant_plain(x, *lf, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (xd, k, x.storage_offset(), act, out)


@pytest.mark.parametrize("in_scale", [0.05, 0.1, 0.0123, 1 / 255])
def test_int8_matmul_quantize_exact_at_rounding_ties(cuda, in_scale):
    """The kernel's quantize rounds x / s as a correctly rounded division:
    inputs whose quotient is a half-integer, one float either side of it,
    zeros, denormals and huge values quantize as the plain version does."""
    s = torch.tensor(in_scale, dtype=torch.float32, device=cuda)
    j = torch.arange(-300, 300, device=cuda, dtype=torch.float32)
    ties = ((j + 0.5) * s).float()
    vals = torch.cat([ties, torch.nextafter(ties, ties + 1), torch.nextafter(ties, ties - 1),
                      torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1e-30, 3e38, -3e38], device=cuda)])
    x = vals[: vals.numel() // 64 * 64].reshape(-1, 64)
    lf = _leaf(np.random.default_rng(1), (64, 24), cuda)
    for xx in (x, x.bfloat16()):
        kw = dict(in_scale=in_scale, in_zp=128)
        got = int8_matmul_requant(xx, *lf, **kw)
        ref = int8_matmul_requant_plain(xx, *lf, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


@pytest.mark.parametrize("m,k,n,xin,act", [
    (197, 192, 576, torch.float32, None), (50432, 768, 192, torch.float32, None),
    (1, 13, 37, torch.float32, None), (197, 1000, 6, torch.float32, "gelu"),
    (333, 192, 768, torch.bfloat16, None), (77, 56, 6, torch.float32, "relu"),
])
def test_int8_matmul_dynamic_route_matches_plain(cuda, m, k, n, xin, act):
    """Kernel A's dynamic route (qparams read from the device buffer) equals
    its plain version bit for bit, and the static route at the same qparams."""
    rng = np.random.default_rng(m + k + n)
    w, ws, b, wsum = _leaf(rng, (k, n), cuda)
    x = (torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)) * 3 - 1).to(cuda, xin)
    qp = dynamic_qparams(x)
    for out in (torch.float32, torch.bfloat16):
        before = _lib.launches["int8_matmul_requant"]
        got = int8_matmul_requant_dynamic(x, w, ws, b, wsum, qp, act=act, out_dtype=out)
        ref = int8_matmul_requant_dynamic_plain(x, w, ws, b, wsum, qp, act=act, out_dtype=out)
        torch.cuda.synchronize()
        assert _lib.launches["int8_matmul_requant"] == before + 1
        assert got.dtype == ref.dtype == out and torch.equal(got, ref)
    s, zp = float(qp[1]), int(qp[2]) + 128
    static = int8_matmul_requant(x, w, ws, b, wsum, in_scale=s, in_zp=zp, act=act)
    assert torch.equal(int8_matmul_requant_dynamic(x, w, ws, b, wsum, qp, act=act), static)


def test_int8_matmul_dynamic_route_reads_a_buffer_written_on_the_stream(cuda):
    """The qparams buffer a previous kernel wrote on the same stream, with no
    sync between: the kernel reads what that kernel wrote (the dynamic
    ViT's dense layers follow one another this way), and a forward of such
    calls makes no host sync."""
    rng = np.random.default_rng(3)
    w, ws, b, wsum = _leaf(rng, (192, 576), cuda)
    x = torch.from_numpy(rng.standard_normal((197 * 64, 192)).astype(np.float32)).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = []
        qp = torch.empty(4, dtype=torch.float64, device=cuda)
        for scale in (1.0, 40.0, 0.01):
            torch.cuda._sleep(2_000_000)  # the writes land well after the launch is queued
            qp.copy_(dynamic_qparams(x * scale))
            outs.append((scale, qp.clone(), int8_matmul_requant_dynamic(x * scale, w, ws, b,
                                                                          wsum, qp)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for scale, q, got in outs:
        ref = int8_matmul_requant_dynamic_plain(x * scale, w, ws, b, wsum, q)
        assert torch.equal(got, ref), scale


def test_served_vit_dynamic_kernel_path_matches_plain_path(cuda):
    """A seeded ViT-Tiny's dynamic INT8 forward: 49 kernel-A launches, equal
    to its plain path (the integer work and every epilogue are the plain
    version's), no host sync."""
    spec = vit.vit_spec("vit_tiny_patch16_224", num_classes=6)
    q = qvit.convert_dynamic_int8(spec, vit_params_from_seed(spec, VIT_SEED))
    model = qvit.from_dynamic_qmodel(spec, q, cuda)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 224, 224, 3),
                                                           dtype=np.uint8)).to(cuda)
    with torch.inference_mode():
        model(x)  # first call: the tensor maps and the normalization constants
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = model(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        counts = dict(_lib.launches)
        ref = model(x, impl="plain")
    assert counts == {"int8_matmul_requant": 49}
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape,o", [((2, 12, 14, 8), 72), ((4, 56, 56, 56), 56),
                                     ((2, 7, 7, 456), 456), ((2, 5, 6, 3), 8)])
@pytest.mark.parametrize("requant", [False, True])
def test_conv3x3_kernel_matches_plain(cuda, shape, o, requant):
    """Kernel B equals its plain version bit for bit (fp32 out, requant + ReLU)."""
    rng = np.random.default_rng(sum(shape) + o)
    w, ws, b, wsum = _leaf(rng, (3, 3, shape[-1], o), cuda)
    x = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(cuda)
    kw = dict(in_scale=0.03, in_zp=150, relu=requant,
              out_scale=0.5 if requant else None, out_zp=110 if requant else None)
    before = _lib.launches["conv3x3_s1_int8"]
    got = conv3x3_s1_int8(x, w, ws, b, wsum, **kw)
    ref = conv3x3_s1_int8_plain(x, w, ws, b, wsum, **kw)
    torch.cuda.synchronize()
    assert _lib.launches["conv3x3_s1_int8"] == before + 1
    assert got.dtype == ref.dtype and torch.equal(got, ref)


def _identity(rng, kind, shape, dev):
    if kind == "int8":
        return ("int8", torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(dev),
                0.04, 120)
    return torch.from_numpy((rng.standard_normal(shape) * 2).astype(np.float32)).to(dev)


@pytest.mark.parametrize("shape,o", [((256, 56, 56, 56), 56), ((256, 28, 28, 112), 112),
                                     ((256, 14, 14, 224), 224), ((256, 7, 7, 456), 456),
                                     ((2, 12, 14, 8), 72), ((3, 7, 9, 40), 56),
                                     ((2, 5, 6, 3), 6)])
@pytest.mark.parametrize("kind", ["int8", "float32"])
def test_conv3x3_residual_kernel_matches_plain(cuda, shape, o, kind):
    """The residual epilogue (conv + identity, ReLU, requant by division)
    equals its plain version bit for bit at the four served widths (batch
    256) and at odd shapes (C 3 and 40, O not a multiple of 4)."""
    rng = np.random.default_rng(sum(shape) + o)
    w, ws, b, wsum = _leaf(rng, (3, 3, shape[-1], o), cuda)
    x = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(cuda)
    kw = dict(in_scale=0.03, in_zp=150, out_scale=0.07, out_zp=100,
              residual=_identity(rng, kind, (*shape[:3], o), cuda))
    before = _lib.launches["conv3x3_s1_int8"]
    got = conv3x3_s1_int8(x, w, ws, b, wsum, **kw)
    ref = conv3x3_s1_int8_plain(x, w, ws, b, wsum, **kw)
    torch.cuda.synchronize()
    assert _lib.launches["conv3x3_s1_int8"] == before + 1
    assert got.dtype == torch.int8 and torch.equal(got, ref)
    assert got.float().std() > 2  # the requant lands mid-range, not on a clip


@pytest.mark.parametrize("out_scale", [0.05, 0.1, 0.0123, 1 / 255])
@pytest.mark.parametrize("o", [30, 32])
def test_conv3x3_residual_requant_exact_at_rounding_ties(cuda, out_scale, o):
    """With zero weights and bias the block's sum is the identity itself, so
    its quotients by s_out sit on rint's ties, one float beside them, at 0,
    a denormal and near overflow: the kernel divides as the plain version."""
    s = torch.tensor(out_scale, dtype=torch.float32, device=cuda)
    ties = ((torch.arange(0, 300, device=cuda, dtype=torch.float32) + 0.5) * s).float()
    vals = torch.cat([ties, torch.nextafter(ties, ties + 1), torch.nextafter(ties, ties - 1),
                      torch.tensor([0.0, -0.0, 1e-40, 3e38], device=cuda)])
    ident = vals.repeat(-(-2 * 5 * 6 * o // vals.numel()))[: 2 * 5 * 6 * o].reshape(2, 5, 6, o)
    w = pack_weight(torch.zeros((3, 3, 8, o), dtype=torch.int8, device=cuda))
    ws, b = torch.full((o,), 0.01, device=cuda), torch.zeros(o, device=cuda)
    wsum = torch.zeros(o, dtype=torch.int32, device=cuda)
    x = torch.zeros((2, 5, 6, 8), dtype=torch.int8, device=cuda)
    kw = dict(in_scale=0.03, in_zp=150, residual=ident, out_scale=out_scale, out_zp=3)
    got = conv3x3_s1_int8(x, w, ws, b, wsum, **kw)
    ref = conv3x3_s1_int8_plain(x, w, ws, b, wsum, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_served_forward_kernel_path_matches_plain_path(cuda):
    model = load_static_int8(ARTIFACT, device=cuda)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 224, 224, 3),
                                                           dtype=np.uint8)).to(cuda)
    _lib.reset_launch_counts()
    with torch.inference_mode():
        got = model(x)
        counts = dict(_lib.launches)
        ref = model(x, impl="plain")
    assert counts == {"int8_matmul_requant": 8, "conv3x3_s1_int8": 13}
    assert torch.equal(got.argmax(1), ref.argmax(1))
    assert torch.allclose(got, ref, rtol=0.02, atol=0.02)
    assert torch.equal(got, ref)  # both kernels are bit-exact, so is the forward


@pytest.mark.parametrize("n,h,w,cin,ce,co,se,k,stride,expand,act,residual", [
    (2, 8, 8, 16, 64, 16, 4, 3, 1, True, "silu", True),        # residual, SE, one Ce tile
    (2, 12, 12, 24, 36, 20, 0, 3, 1, True, "relu6", False),    # relu6, no SE
    (2, 10, 10, 40, 40, 40, 0, 3, 1, False, "relu6", True),    # no expand
    (2, 7, 9, 24, 36, 24, 6, 5, 1, True, "silu", True),        # ragged H/W, k5, Ce % 8 != 0
    (2, 15, 15, 16, 100, 24, 4, 3, 2, True, "silu", False),    # stride 2 on odd H, 2 Ce tiles
    (3, 13, 11, 22, 38, 30, 5, 5, 2, True, "silu", False),     # Cin, Ce % 4 != 0 (byte paths)
    (2, 20, 20, 72, 72, 72, 18, 5, 1, False, "silu", True),    # no expand, several tiles
    (2, 9, 9, 32, 200, 48, 8, 1, 1, True, "silu", False),      # k1
    (1, 40, 38, 8, 8, 16, 2, 3, 2, False, "silu", False),      # many stride-2 tiles
    (2, 30, 30, 32, 32, 16, 8, 3, 1, False, "silu", True),     # Ce 32, one channel tile
    (2, 31, 29, 16, 96, 24, 4, 3, 2, True, "silu", False),     # Cin 16, Ce 96
    (2, 23, 23, 24, 144, 40, 6, 5, 2, True, "silu", False),    # k5 at stride 2, Ce 144
    (2, 16, 16, 40, 200, 40, 10, 5, 1, True, "relu6", True),   # Ce not a multiple of the tile
    (1, 60, 60, 16, 96, 24, 4, 3, 2, True, "silu", False),     # several tiles of the largest map
])
def test_fused_mbconv_kernel_matches_plain(cuda, n, h, w, cin, ce, co, se, k, stride, expand,
                                           act, residual):
    rng = np.random.default_rng(n + h + w + cin + ce + co + k)
    p_np, in_zp = random_block(rng, cin=cin, ce=ce, co=co, se=se, k=k, expand=expand)
    packed = to_device_packed(p_np, cuda)
    x = torch.from_numpy(np.clip(np.rint(rng.normal(in_zp - 118, 30, (n, h, w, cin))), -128,
                                 127).astype(np.int8)).to(cuda)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    res = None
    if residual:
        res = x if (cin, h) == (co, ho) else torch.from_numpy(
            rng.integers(-128, 128, (n, ho, wo, co), dtype=np.int8)).to(cuda)
    kw = dict(kernel=k, stride=stride, act=act, x_res=res)
    before = _lib.launches["fused_mbconv_block"]
    got = fused_mbconv_block(x, packed, **kw)
    torch.cuda.synchronize()
    assert _lib.launches["fused_mbconv_block"] == before + (3 if se else 2)
    ref = fused_mbconv_block_plain(x, packed, **kw)
    assert got.shape == ref.shape == (n, ho, wo, co)
    assert torch.equal(got, ref)  # the depthwise sums are exact integers in any order
    assert got.float().std() > 2  # the requants land mid-range, not on a clip


def test_served_effnet_kernel_path_matches_plain_path(cuda):
    model = load_static_int8_fused(EFF_ARTIFACT, device=cuda)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 224, 224, 3),
                                                           dtype=np.uint8)).to(cuda)
    _lib.reset_launch_counts()
    with torch.inference_mode():
        got = model(x)
        counts = dict(_lib.launches)
        ref = model(x, impl="plain")
    assert counts == {"int8_matmul_requant": 3, "fused_mbconv_block": 48}
    assert torch.allclose(got, ref, rtol=0, atol=0.05 * float(ref.abs().max()))


def _assert_dense_close(got, ref, dtype):
    """bf16 within one bf16 ulp (or 1e-4 near GELU's zero), fp32 rtol/atol 1e-5."""
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    d = (got.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        mag = torch.maximum(got.float().abs(), ref.float().abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool((d <= ulp.clamp_min(1e-4)).all())
    else:
        assert torch.allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,n", [(197, 192, 768), (77, 40, 24), (300, 72, 168), (333, 13, 37),
                                   (1000, 768, 192), (3000, 192, 8), (64, 192, 136),
                                   (65, 184, 200), (50432, 192, 768)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_gelu_kernel_matches_plain(cuda, m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    x, w, b = (torch.from_numpy(a.astype(np.float32)).to(cuda, dtype) for a in (
        rng.standard_normal((m, k)), rng.standard_normal((k, n)) / np.sqrt(k),
        rng.standard_normal(n)))
    before = _lib.launches["dense_gelu"]
    got = dense_gelu(x, w, b)
    torch.cuda.synchronize()
    assert _lib.launches["dense_gelu"] == before + 1
    _assert_dense_close(got, dense_gelu_plain(x, w, b), dtype)


@pytest.mark.parametrize("offset", [8, 1, 64])
def test_dense_gelu_kernel_on_offset_views(cuda, offset):
    """Rows that start 16 bytes (8, 64 elements) or 2 bytes (1) into their
    buffer: the Hopper route and the general one, with ragged M."""
    m, k, n = 777, 192, 768
    rng = np.random.default_rng(offset)
    flat = torch.from_numpy(rng.standard_normal(m * k + offset).astype(np.float32)).to(
        cuda, torch.bfloat16)
    x = flat[offset : offset + m * k].view(m, k)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda, torch.bfloat16)
    got = dense_gelu(x, w, b)
    torch.cuda.synchronize()
    _assert_dense_close(got, dense_gelu_plain(x, w, b), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_float_vit_fused_mlp_kernel_matches_plain(cuda, dtype):
    spec = vit.vit_spec("vit_tiny_patch16_224", num_classes=6)
    params = vit.params_from_jax(vit_params_from_seed(spec, VIT_SEED), cuda)
    x = normalize_images(torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 224, 224, 3), dtype=np.uint8)).to(cuda))
    _lib.reset_launch_counts()
    with torch.inference_mode():
        got, _ = vit.apply(spec, params, {}, x, compute_dtype=dtype, fused_mlp=True)
        counts = dict(_lib.launches)
        ref, _ = vit.apply(spec, params, {}, x, compute_dtype=dtype, fused_mlp=True,
                           impl="plain")
    assert counts == {"dense_gelu": 12}
    tol = 1e-5 if dtype == torch.float32 else 0.05
    assert torch.allclose(got, ref, rtol=0, atol=tol * float(ref.abs().max()))


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
def test_served_vit_kernel_path_matches_plain_path(cuda, act):
    model = qvit.load_static_int8(VIT_ARTIFACT, device=cuda, act_dtype=act)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 224, 224, 3),
                                                           dtype=np.uint8)).to(cuda)
    _lib.reset_launch_counts()
    with torch.inference_mode():
        got = model(x)
        counts = dict(_lib.launches)
        ref = model(x, impl="plain")
    assert counts == {"int8_matmul_requant": 50}
    assert torch.allclose(got, ref, rtol=0, atol=0.05 * float(ref.abs().max()))


def test_vit_init_defaults_to_the_gpu(cuda):
    """``vit.init`` runs on the GPU unless asked; a CPU generator still serves it."""
    spec = vit.vit_spec("vit_tiny_patch16_224", num_classes=6)
    params, state = vit.init(spec, torch.Generator().manual_seed(0))
    assert params["blocks"]["0"]["qkv"]["w"].device.type == "cuda" and state == {}
    assert params["norm"]["scale"].device.type == "cuda"
    ref, _ = vit.init(spec, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(params["blocks"]["0"]["qkv"]["w"].cpu(), ref["blocks"]["0"]["qkv"]["w"])


# B0's 16 depthwise calls (H, C, k, stride) at 224x224, and odd shapes:
# byte loads (C 13, 1), odd H and W, k 5 s 2 at every border class; then the
# edges of kernel E's tiles (ops/dwconv_int8.py:dw_plan at the test's N): Wo
# not a multiple of the outputs per thread (59 at 2, 31 at 4), Ho not a
# multiple of the band (7 at 2), C not a multiple of the channel group (920
# at 116, 260 at 88), two bands per block with a ragged last block (15 bands),
# and pruned widths C 24, 40 and 920
DW_SHAPES = [(112, 32, 3, 1), (112, 96, 3, 2), (56, 144, 3, 1), (56, 144, 5, 2),
             (28, 240, 5, 1), (28, 240, 3, 2), (14, 480, 3, 1), (14, 480, 5, 1),
             (14, 672, 5, 1), (14, 672, 5, 2), (7, 1152, 5, 1), (7, 1152, 3, 1),
             (13, 13, 5, 2), (9, 8, 3, 1), (11, 1, 5, 2), (10, 1152, 5, 2), (7, 40, 5, 2),
             (57, 24, 3, 1), (14, 920, 3, 2), (56, 40, 5, 2), (29, 260, 3, 1), (15, 520, 3, 1),
             (28, 920, 5, 1)]


@pytest.mark.parametrize("h,c,k,stride", DW_SHAPES)
@pytest.mark.parametrize("in_zp,out_zp", [(0, 255), (128, 128), (255, 0), (117, 31)])
def test_dwconv_int8_kernel_matches_plain(cuda, h, c, k, stride, in_zp, out_zp):
    """Kernel E equals its plain version bit for bit (SiLU epilogue)."""
    from inference_efficient_vision_models_tpu_torch.ops import (
        depthwise_conv_int8, depthwise_conv_int8_plain)

    rng = np.random.default_rng(h * c + k + stride + in_zp)
    n = 4 if h > 28 else 16
    w_dim = h + 2 if h % 2 else h  # a ragged width beside the height
    x = torch.from_numpy(rng.integers(-128, 128, (n, h, w_dim, c), dtype=np.int8)).to(cuda)
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, 1, c), dtype=np.int8)).to(cuda)
    ws = torch.from_numpy(rng.uniform(0.002, 0.02, c).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(cuda)
    kw = dict(stride=stride, in_scale=0.043, in_zp=in_zp, out_scale=0.031, out_zp=out_zp)
    before = _lib.launches["dwconv_int8"]
    got = depthwise_conv_int8(x, wq, ws, b, **kw)
    ref = depthwise_conv_int8_plain(x, wq, ws, b, **kw)
    torch.cuda.synchronize()
    assert _lib.launches["dwconv_int8"] == before + 1
    assert got.shape == ref.shape and torch.equal(got, ref)


def test_dwconv_int8_kernel_matches_plain_at_1e7_outputs(cuda):
    """Kernel E bit for bit at 16 M output values, so that rcp_ge1_fast's
    rare unsettled reciprocals (about one in 10^6) are redone: three-row
    bands at stride 2 (56 rows, a ragged band), four bands per block (19
    bands, a ragged last block), Wo 57 at 4 outputs per thread."""
    from inference_efficient_vision_models_tpu_torch.ops import (
        depthwise_conv_int8, depthwise_conv_int8_plain)

    rng = np.random.default_rng(11)
    n, h, w, c, k = 128, 111, 113, 40, 5
    x = torch.from_numpy(rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)).to(cuda)
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, 1, c), dtype=np.int8)).to(cuda)
    ws = torch.from_numpy(rng.uniform(0.002, 0.02, c).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(cuda)
    kw = dict(stride=2, in_scale=0.043, in_zp=117, out_scale=0.031, out_zp=31)
    got = depthwise_conv_int8(x, wq, ws, b, **kw)
    ref = depthwise_conv_int8_plain(x, wq, ws, b, **kw)
    torch.cuda.synchronize()
    assert got.numel() >= 10**7 and torch.equal(got, ref)


# MobileNetV2's 17 depthwise calls at 224x224 (H, C, stride; k 3), their 10
# distinct shapes, and odd ones: C 32 at 112 (s0b0), C not a multiple of 4
# (13, 6), odd H and W, stride 2 on odd H (13, 7), a 7x7 map with C 960
MBV2_DW_SHAPES = [(112, 32, 1), (112, 96, 2), (56, 144, 1), (56, 144, 2), (28, 192, 1),
                  (28, 192, 2), (14, 384, 1), (14, 576, 1), (14, 576, 2), (7, 960, 1),
                  (13, 13, 2), (9, 6, 1), (7, 960, 2), (15, 52, 2), (11, 96, 1)]


@pytest.mark.parametrize("h,c,stride", MBV2_DW_SHAPES)
@pytest.mark.parametrize("in_zp,out_zp", [(0, 255), (128, 128), (255, 0), (117, 31)])
def test_dwconv_int8_relu6_kernel_matches_plain(cuda, h, c, stride, in_zp, out_zp):
    """Kernel E with its ReLU6 epilogue equals its plain version bit for bit."""
    from inference_efficient_vision_models_tpu_torch.ops import (
        depthwise_conv_int8, depthwise_conv_int8_plain)

    rng = np.random.default_rng(h * c + stride + in_zp + 3)
    n = 4 if h > 28 else 16
    w_dim = h + 2 if h % 2 else h  # a ragged width beside the height
    x = torch.from_numpy(rng.integers(-128, 128, (n, h, w_dim, c), dtype=np.int8)).to(cuda)
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, 1, c), dtype=np.int8)).to(cuda)
    ws = torch.from_numpy(rng.uniform(0.002, 0.02, c).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(cuda)
    kw = dict(stride=stride, in_scale=0.043, in_zp=in_zp, out_scale=0.031, out_zp=out_zp,
              act="relu6")
    before = _lib.launches["dwconv_int8"]
    got = depthwise_conv_int8(x, wq, ws, b, **kw)
    ref = depthwise_conv_int8_plain(x, wq, ws, b, **kw)
    torch.cuda.synchronize()
    assert _lib.launches["dwconv_int8"] == before + 1
    assert got.shape == ref.shape and torch.equal(got, ref)


@pytest.mark.parametrize("stride", [1, 2])
def test_dwconv_int8_relu6_exact_at_rounding_ties(cuda, stride):
    """s_in * s_w = 2^-12 and s_out = 2^-9: y / s_out = acc / 8, a requant tie
    wherever acc = 4 (mod 8); rint rounds them to even as the plain version."""
    from inference_efficient_vision_models_tpu_torch.ops import (
        depthwise_conv_int8, depthwise_conv_int8_plain)

    rng = np.random.default_rng(stride)
    n, h, c = 8, 28, 40
    x = torch.from_numpy(rng.integers(-128, 128, (n, h, h, c), dtype=np.int8)).to(cuda)
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, 1, c), dtype=np.int8)).to(cuda)
    ws = torch.full((c,), 1 / 64, device=cuda)
    b = torch.zeros(c, device=cuda)
    kw = dict(stride=stride, in_scale=1 / 64, in_zp=128, out_scale=1 / 512, out_zp=0,
              act="relu6")
    got = depthwise_conv_int8(x, wq, ws, b, **kw)
    ref = depthwise_conv_int8_plain(x, wq, ws, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_dwconv_int8_refuses_an_unknown_act(cuda):
    from inference_efficient_vision_models_tpu_torch.ops import depthwise_conv_int8

    x = torch.zeros((1, 8, 8, 8), dtype=torch.int8, device=cuda)
    wq = torch.zeros((3, 3, 1, 8), dtype=torch.int8, device=cuda)
    ws, b = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    with pytest.raises(ValueError):
        depthwise_conv_int8(x, wq, ws, b, stride=1, in_scale=0.1, in_zp=128, out_scale=0.1,
                            out_zp=0, act="gelu")


def test_served_effnet_unfused_kernel_path_matches_plain_path(cuda):
    """The unfused executor (kernels A and E) on the committed artifact equals
    its plain path; 34 kernel-A and 16 kernel-E launches per forward."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.qeffnet import (
        load_static_int8 as load_effnet)

    model = load_effnet(EFF_ARTIFACT, "cuda")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 224, 224, 3),
                                                          dtype=np.uint8)).to(cuda)
    _lib.reset_launch_counts()
    with torch.inference_mode():
        got = model(x)
        counts = dict(_lib.launches)
        ref = model(x, impl="plain")
    torch.cuda.synchronize()
    assert counts == {"int8_matmul_requant": 34, "dwconv_int8": 16}
    assert torch.equal(got, ref)
