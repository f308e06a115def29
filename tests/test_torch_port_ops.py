"""The port's int8 kernels' plain versions and layout helpers against the
JAX package (Pallas kernels in interpret mode, the lax int8 path), on the CPU.

Same inputs from numpy seeds on both sides. Tolerances as in
tests/test_ops.py: int8 within one quantum with >= 99% exact (rounding ties
differ: the kernels multiply by 1/s_y, lax divides); fp32 rtol 1e-5 /
atol 1e-3; bf16 within one bf16 ulp or that atol, whichever is larger.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from inference_efficient_vision_models_tpu.compress.quant import observers as jobs
from inference_efficient_vision_models_tpu.compress.quant.qresnet import (
    _epilogue,
    _qconv_int8,
    _requant,
)
from inference_efficient_vision_models_tpu.ops import conv3x3_s1_int8 as j_conv3x3
from inference_efficient_vision_models_tpu.ops import conv_int8_im2col as j_im2col
from inference_efficient_vision_models_tpu.ops import int8_matmul_requant as j_matmul
from inference_efficient_vision_models_tpu.ops import space_to_depth as jsd
from inference_efficient_vision_models_tpu_torch.compress.quant import observers as tobs
from inference_efficient_vision_models_tpu_torch.ops import (
    _lib,
    conv3x3_s1_int8,
    conv3x3_s1_int8_plain,
    conv_int8_im2col,
    int8_matmul_requant,
    pack_weight,
)
from inference_efficient_vision_models_tpu_torch.ops import space_to_depth as tsd


def _assert_close(got, ref):
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.shape, ref.shape,
                                                              got.dtype, ref.dtype)
    if got.dtype == np.int8:
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())
    elif got.dtype == np.float32:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    else:  # bfloat16 (ml_dtypes on the JAX side): one bf16 ulp, and the fp32
        # atol where fp32 tanh/erf cancellation near zero dominates
        g, r = got.astype(np.float32), ref.astype(np.float32)
        mag = np.maximum(np.abs(g), np.abs(r))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert (np.abs(g - r) <= np.maximum(ulp, 1e-3)).all()


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_np(t):
    if t.dtype == torch.bfloat16:
        return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
    return t.numpy()


def _qparams(rng, k, n):
    w_q = rng.integers(-128, 128, (k, n), dtype=np.int8)
    return (w_q, rng.uniform(0.001, 0.01, n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32), w_q.astype(np.int32).sum(axis=0))


MATMUL_CASES = [
    # (M, K, N, input, kwargs)
    (96, 72, 160, "int8", dict()),
    (96, 72, 160, "int8", dict(relu=True, out_scale=0.07, out_zp=122)),
    (77, 56, 6, "int8", dict(out_scale=0.07, out_zp=122)),
    (33, 504, 112, "int8", dict(relu=True, out_scale=0.2, out_zp=3)),
    (40, 456, 6, "float32", dict()),
    (40, 456, 6, "float32", dict(act="relu", out_scale=0.05, out_zp=0)),
    (50, 56, 37, "float32", dict(act="gelu")),
    (50, 56, 37, "bfloat16", dict(act="gelu", out_dtype="bfloat16")),
    (50, 56, 37, "float32", dict(act="gelu_tanh")),
    (50, 56, 37, "bfloat16", dict(act="gelu_tanh", out_dtype="bfloat16")),
    (64, 72, 160, "int8", dict(act="gelu", out_dtype="bfloat16")),
]


@pytest.mark.parametrize("m,k,n,xin,kw", MATMUL_CASES)
def test_int8_matmul_plain_matches_pallas(m, k, n, xin, kw):
    rng = np.random.default_rng(m * k + n)
    w_q, w_scale, bias, w_sum = _qparams(rng, k, n)
    if xin == "int8":
        x = rng.integers(-128, 128, (m, k), dtype=np.int8)
        xj, xt = jnp.asarray(x), _t(x)
    else:
        x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
        xj = jnp.asarray(x, getattr(jnp, xin))
        xt = _t(xj.astype(jnp.float32)).to(getattr(torch, xin))
    jkw = dict(kw)
    tkw = dict(kw)
    if "out_dtype" in kw:
        jkw["out_dtype"] = getattr(jnp, kw["out_dtype"])
        tkw["out_dtype"] = getattr(torch, kw["out_dtype"])
    in_scale, in_zp = 0.05, 113
    ref = j_matmul(xj, jnp.asarray(w_q), jnp.asarray(w_scale), jnp.asarray(bias),
                   jnp.asarray(w_sum), in_scale=in_scale, in_zp=in_zp, interpret=True, **jkw)
    before = _lib.launches["int8_matmul_requant"]
    got = int8_matmul_requant(xt, _t(w_q), _t(w_scale), _t(bias), _t(w_sum),
                              in_scale=in_scale, in_zp=in_zp, **tkw)
    assert _lib.launches["int8_matmul_requant"] == before  # a CPU tensor never launches
    _assert_close(_to_np(got), ref)


@pytest.mark.parametrize("stride,padding,k,requant",
                         [(1, 1, 3, False), (2, 1, 3, True), (1, 0, 1, False), (2, 0, 1, True)])
def test_conv_im2col_plain_matches_pallas(stride, padding, k, requant):
    rng = np.random.default_rng(1)
    x_s = rng.integers(-128, 128, (2, 14, 14, 56), dtype=np.int8)
    w_q = rng.integers(-128, 128, (k, k, 56, 72), dtype=np.int8)
    w_scale = rng.uniform(0.001, 0.01, 72).astype(np.float32)
    bias = rng.standard_normal(72).astype(np.float32)
    w_sum = w_q.astype(np.int32).sum(axis=(0, 1, 2))
    kw = dict(stride=stride, padding=padding, in_scale=0.04, in_zp=140, relu=True,
              out_scale=0.3 if requant else None, out_zp=120 if requant else None)
    ref = j_im2col(jnp.asarray(x_s), jnp.asarray(w_q), jnp.asarray(w_scale), jnp.asarray(bias),
                   jnp.asarray(w_sum), interpret=True, **kw)
    got = conv_int8_im2col(_t(x_s), pack_weight(_t(w_q)), _t(w_scale), _t(bias), _t(w_sum),
                           **kw)
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("c,o", [(8, 56), (56, 56), (72, 8), (56, 72)])
@pytest.mark.parametrize("requant", [False, True])
def test_conv3x3_plain_matches_pallas_and_lax(c, o, requant):
    rng = np.random.default_rng(c * 100 + o)
    x_s = rng.integers(-128, 128, (2, 6, 7, c), dtype=np.int8)
    w_q = rng.integers(-128, 128, (3, 3, c, o), dtype=np.int8)
    w_scale = rng.uniform(0.001, 0.01, o).astype(np.float32)
    bias = rng.standard_normal(o).astype(np.float32)
    w_sum = w_q.astype(np.int32).sum(axis=(0, 1, 2))
    in_scale, in_zp = 0.03, 150
    out_scale, out_zp = (0.6, 110) if requant else (None, None)
    pallas = j_conv3x3(jnp.asarray(x_s), jnp.asarray(w_q), jnp.asarray(w_scale),
                       jnp.asarray(bias), jnp.asarray(w_sum), in_scale=in_scale, in_zp=in_zp,
                       relu=True, out_scale=out_scale, out_zp=out_zp, interpret=True)
    qc = {"w_q": jnp.asarray(w_q), "w_scale": jnp.asarray(w_scale),
          "w_sum": jnp.asarray(w_sum), "bias": jnp.asarray(bias)}
    lax = _epilogue(_qconv_int8(jnp.asarray(x_s), jnp.asarray(in_zp), qc, 1, 1),
                    jnp.asarray(in_scale, jnp.float32), qc, relu=True)
    if requant:
        lax = _requant(lax, out_scale, out_zp)
    before = _lib.launches["conv3x3_s1_int8"]
    got = conv3x3_s1_int8(_t(x_s), _t(w_q), _t(w_scale), _t(bias), _t(w_sum),
                          in_scale=in_scale, in_zp=in_zp, relu=True, out_scale=out_scale,
                          out_zp=out_zp)
    assert _lib.launches["conv3x3_s1_int8"] == before
    _assert_close(got.numpy(), pallas)
    _assert_close(got.numpy(), lax)
    # the packed layout is what the model hands the kernel
    packed = conv3x3_s1_int8_plain(_t(x_s), pack_weight(_t(w_q)), _t(w_scale), _t(bias),
                                   _t(w_sum), in_scale=in_scale, in_zp=in_zp, relu=True,
                                   out_scale=out_scale, out_zp=out_zp)
    assert torch.equal(packed, got)


def test_pack_weight_roundtrip_and_padding():
    rng = np.random.default_rng(3)
    for shape in [(3, 3, 56, 112), (456, 6), (4, 4, 12, 56)]:
        w = _t(rng.integers(-128, 128, shape, dtype=np.int8))
        p = pack_weight(w)
        assert p.wt.shape[0] % _lib.TILE_N == 0 and p.wt.shape[1] % _lib.TILE_K == 0
        assert p.wt.is_contiguous() and torch.equal(p.unpack(), w)
        assert int(p.wt.abs().sum()) == int(w.abs().sum())  # padding is zero


def test_space_to_depth_and_stem_remap_byte_equal():
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (3, 16, 12, 3), dtype=np.uint8)
    host = tsd.space_to_depth_u8(imgs)
    np.testing.assert_array_equal(host, jsd.space_to_depth_u8(imgs))
    np.testing.assert_array_equal(tsd.space_to_depth_device(_t(imgs)).numpy(), host)
    w = rng.standard_normal((7, 7, 3, 56)).astype(np.float32)
    got = tsd.remap_stem_weights_s2d(_t(w)).numpy()
    ref = jsd.remap_stem_weights_s2d(w)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


def test_observers_match_jax():
    rng = np.random.default_rng(5)
    for lo, hi in [(-1.3, 4.2), (0.5, 2.0), (-3.0, -1.0), (0.0, 0.0)]:
        assert tobs.minmax_qparams_affine(lo, hi) == jobs.minmax_qparams_affine(lo, hi)
    for axis, shape in [(3, (3, 3, 8, 16)), (1, (40, 6))]:
        w = rng.standard_normal(shape).astype(np.float32) * 0.2
        q_t, s_t = tobs.quantize_weight_per_channel(w, axis)
        q_j, s_j = jobs.quantize_weight_per_channel(w, axis)
        assert q_t.dtype == np.int8 and s_t.dtype == np.float32
        np.testing.assert_array_equal(q_t, q_j)
        np.testing.assert_array_equal(s_t, s_j)
    x = (rng.standard_normal((4, 33)) * 5).astype(np.float32)
    qx = tobs.quantize_affine_shifted(_t(x), np.float32(0.043), 117)
    np.testing.assert_array_equal(
        qx.numpy(), np.asarray(jobs.quantize_affine_shifted(jnp.asarray(x), np.float32(0.043),
                                                            np.int32(117))))
    np.testing.assert_array_equal(
        tobs.dequantize_affine_shifted(qx, np.float32(0.043), 117).numpy(),
        np.asarray(jobs.dequantize_affine_shifted(jnp.asarray(qx.numpy()), np.float32(0.043),
                                                  np.int32(117))))


def test_unknown_act_is_refused():
    """An act the kernel does not have raises on the CPU path too."""
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 3), dtype=torch.int8)
    v = torch.zeros(3)
    with pytest.raises(ValueError):
        int8_matmul_requant(x, w, v, v, torch.zeros(3, dtype=torch.int32), in_scale=1.0,
                            in_zp=128, act="swish")
