"""Kernel E's plain version (``ops/dwconv_int8.py``) against the JAX package
on the CPU: the int32 shift lowering against JAX ``depthwise_conv_int8``
(equal, as tests/test_ops.py holds it against the grouped conv), and the
whole conv with its epilogue against JAX ``qeffnet._conv_q(groups=C)``.

The epilogue takes SiLU as y * (1 / (1 + exp(-y))) (the kernels' formula,
``ops.fused_mbconv.act_plain``), JAX as y * sigmoid(y): the two differ by
ulps, which moves a value across a requant rounding edge now and then, so
the outputs agree within one quantum with at least 99% of them exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inference_efficient_vision_models_tpu.compress.quant import qeffnet as jqe
from inference_efficient_vision_models_tpu.ops.dwconv_int8 import depthwise_conv_int8 as j_dw
from inference_efficient_vision_models_tpu_torch.ops import dwconv_int8 as tdw


def case(rng, n, h, w, c, k):
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    wq = rng.integers(-127, 128, (k, k, 1, c), dtype=np.int8)
    w_scale = (rng.random(c) * 0.02 + 0.002).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.5).astype(np.float32)
    return x, wq, w_scale, bias


SHAPES = [(2, 9, 11, 13, 3, 1), (2, 9, 11, 13, 3, 2), (1, 10, 7, 8, 5, 1),
          (1, 11, 13, 8, 5, 2), (3, 6, 6, 1, 3, 2), (1, 7, 9, 40, 5, 2)]


@pytest.mark.parametrize("n,h,w,c,k,stride", SHAPES)
def test_shift_lowering_equals_jax(n, h, w, c, k, stride):
    rng = np.random.default_rng(h * 100 + c + k + stride)
    x, wq, _, _ = case(rng, n, h, w, c, k)
    ref = np.asarray(j_dw(jnp.asarray(x), jnp.asarray(wq), stride))
    got = tdw.depthwise_acc_int32(torch.from_numpy(x), torch.from_numpy(wq), stride).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,h,w,c,k,stride", SHAPES)
@pytest.mark.parametrize("in_zp", [0, 128, 255])
def test_conv_and_epilogue_against_jax(n, h, w, c, k, stride, in_zp):
    rng = np.random.default_rng(7 * h + c + in_zp)
    x, wq, w_scale, bias = case(rng, n, h, w, c, k)
    in_scale, out_scale, out_zp = np.float32(0.037), np.float32(0.051), np.int32(101)
    qc = {"w_q": jnp.asarray(wq), "w_scale": jnp.asarray(w_scale), "bias": jnp.asarray(bias),
          "w_sum": jnp.asarray(wq.astype(np.int32).sum(axis=(0, 1, 2))),
          "out_scale": out_scale, "out_zp": out_zp}
    ref = np.asarray(jqe._conv_q(jnp.asarray(x), jnp.int32(in_zp), in_scale, qc, stride,
                                 (k - 1) // 2, groups=c, act=True, requant=True))
    got = tdw.depthwise_conv_int8(
        torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(w_scale),
        torch.from_numpy(bias), stride=stride, in_scale=in_scale, in_zp=in_zp,
        out_scale=out_scale, out_zp=out_zp).numpy()
    assert got.shape == ref.shape and got.dtype == np.int8
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())


def test_vector_width():
    """16-, 8- and 4-byte loads where C and every address allow, else bytes."""
    base = torch.zeros(4096, dtype=torch.int8)
    assert tdw.vector_width(32, base) == 16
    assert tdw.vector_width(24, base) == 8
    assert tdw.vector_width(20, base) == 4
    assert tdw.vector_width(13, base) == 1
    assert tdw.vector_width(32, base, base[8:]) == 8
    assert tdw.vector_width(32, base[1:]) == 1


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((3, 3, 1, 8), dtype=torch.int8)
    v = torch.zeros(8)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        tdw.depthwise_conv_int8(x.to("meta"), w, v, v, stride=1, in_scale=1.0, in_zp=128,
                                out_scale=1.0, out_zp=0)
