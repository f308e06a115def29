"""The CUDA kernels against their plain versions, on the GPU (marked ``cuda``;
they skip on a machine without one). On a GPU machine without JAX, skip
``tests/conftest.py`` (it sets up the JAX CPU backend):
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -m cuda``."""

import os

import numpy as np
import pytest
import torch

from inference_efficient_vision_models_tpu_torch.compress.quant.qresnet import load_static_int8
from inference_efficient_vision_models_tpu_torch.ops import (
    _lib,
    conv3x3_s1_int8,
    conv3x3_s1_int8_plain,
    int8_matmul_requant,
    int8_matmul_requant_plain,
    pack_weight,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "bench", "quantization", "r2", "fold_0")

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
    d = (got.float() - ref.float()).abs()
    if got.dtype == torch.int8:
        assert d.max() <= 1 and (d == 0).float().mean() >= 0.99
    else:
        # bf16: within one bf16 ulp (2^-7 relative at most)
        assert torch.allclose(got.float(), ref.float(), rtol=2**-7 if got.dtype == torch.bfloat16
                              else 1e-5, atol=1e-3)


@pytest.mark.parametrize("shape,o", [((2, 12, 14, 8), 72), ((4, 56, 56, 56), 56),
                                     ((2, 7, 7, 456), 456), ((2, 5, 6, 3), 8)])
@pytest.mark.parametrize("requant", [False, True])
def test_conv3x3_kernel_matches_plain(cuda, shape, o, requant):
    rng = np.random.default_rng(sum(shape) + o)
    w, ws, b, wsum = _leaf(rng, (3, 3, shape[-1], o), cuda)
    x = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).to(cuda)
    kw = dict(in_scale=0.03, in_zp=150, relu=requant,
              out_scale=0.5 if requant else None, out_zp=110 if requant else None)
    got = conv3x3_s1_int8(x, w, ws, b, wsum, **kw)
    ref = conv3x3_s1_int8_plain(x, w, ws, b, wsum, **kw)
    torch.cuda.synchronize()
    d = (got.float() - ref.float()).abs()
    if requant:
        assert d.max() <= 1 and (d == 0).float().mean() >= 0.99
    else:
        assert torch.allclose(got, ref, rtol=1e-5, atol=1e-3)


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
