"""The hand-written kernels as ``torch.library`` ops (``ievm::*``, ``ops/_lib``)
on the CPU: ``torch.library.opcheck`` on each op's CPU implementation at
small shapes (kernels A static and dynamic, B with each residual kind, C's
three launches with and without SE and expand, D, E and F), each op equal
to its plain version, kernel C's launch-by-launch plain version equal to the
whole block, and the wrappers emitting the ops under ``torch.export``.

The checks named in ``CHECKS`` are all four of opcheck's: ``test_schema``
(the schema states every mutation and alias: none), ``test_faketensor``
(the fake implementation's shapes and dtypes are the real ones),
``test_aot_dispatch_dynamic`` (the op traces under AOT dispatch with dynamic
shapes) and ``test_autograd_registration``, which int8 ops pass with inputs
that need no gradient: the kernels are inference kernels, and no op has an
autograd formula.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import random_block  # noqa: E402
from inference_efficient_vision_models_tpu_torch.ops import (  # noqa: E402
    _lib,
    conv3x3_s1_int8_plain,
    dense_gelu_plain,
    depthwise_conv_int8_plain,
    dynamic_qparams,
    fused_mbconv_block,
    fused_mbconv_block_plain,
    grouped_conv_int8_plain,
    int8_matmul_requant,
    int8_matmul_requant_dynamic_plain,
    int8_matmul_requant_plain,
    pack_grouped_weight,
    pack_weight,
    to_device_packed,
)

CHECKS = ("test_schema", "test_autograd_registration", "test_faketensor",
          "test_aot_dispatch_dynamic")
OPS = ("int8_matmul_requant", "int8_matmul_requant_dynamic", "conv3x3_s1_int8",
       "fused_mbconv_expand_dw", "fused_mbconv_se_gate", "fused_mbconv_project", "dwconv_int8",
       "gconv_int8", "dense_gelu")


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def i8(shape, seed=0):
    return torch.randint(-128, 128, shape, generator=_g(seed), dtype=torch.int8)


def f32(shape, seed=0, scale=1.0):
    return torch.randn(shape, generator=_g(seed)) * scale


def vecs(n, seed=1):
    return f32(n, seed, 0.01).abs() + 1e-3, f32(n, seed + 1)


def a_case(x_kind, act, out):
    w = pack_weight(i8((20, 6), 1))
    ws, b = vecs(6)
    w_sum = w.kn().to(torch.int32).sum(0).to(torch.int32)
    x = i8((5, 20), 2) if x_kind == "int8" else f32((5, 20), 2, 3.0).to(x_kind)
    out_scale, out_zp, dt = (0.1, 3, torch.float32) if out == "int8" else (None, None, out)
    args = (x, w.wt, list(w.shape), ws, b, w_sum, 0.05, 130, act, out_scale, out_zp, dt)
    plain = int8_matmul_requant_plain(x, w, ws, b, w_sum, in_scale=0.05, in_zp=130,
                                      act=None if act == "none" else act, out_scale=out_scale,
                                      out_zp=out_zp, out_dtype=dt)
    return "int8_matmul_requant", args, plain


def dyn_case():
    w = pack_weight(i8((20, 6), 1))
    ws, b = vecs(6)
    w_sum = w.kn().to(torch.int32).sum(0).to(torch.int32)
    x = f32((5, 20), 3, 2.0)
    qp = dynamic_qparams(x)
    plain = int8_matmul_requant_dynamic_plain(x, w, ws, b, w_sum, qp, act="gelu")
    return ("int8_matmul_requant_dynamic", (x, w.wt, list(w.shape), ws, b, w_sum, qp, "gelu",
                                            torch.float32), plain)


def b_case(res_kind):
    w = pack_weight(i8((3, 3, 8, 6), 1))
    ws, b = vecs(6)
    w_sum = w.kn().to(torch.int32).sum(0).to(torch.int32)
    x = i8((2, 5, 6, 8), 2)
    res, rs, rz, residual = None, 0.0, 0, None
    if res_kind == "int8":
        res, rs, rz = i8((2, 5, 6, 6), 4), 0.07, 120
        residual = ("int8", res, rs, rz)
    elif res_kind == "fp32":
        res = residual = f32((2, 5, 6, 6), 4)
    relu = res_kind == "none"
    out_scale, out_zp = 0.2, 5
    args = (x, w.wt, list(w.shape), ws, b, w_sum, 0.04, 125, relu, out_scale, out_zp, res, rs, rz)
    plain = conv3x3_s1_int8_plain(x, w, ws, b, w_sum, in_scale=0.04, in_zp=125, relu=relu,
                                  out_scale=out_scale, out_zp=out_zp, residual=residual)
    return "conv3x3_s1_int8", args, plain


def block(se, expand, seed=3):
    p, in_zp = random_block(np.random.default_rng(seed), cin=8, ce=16, co=8, se=se, k=3,
                            expand=expand)
    x = i8((2, 7, 7, 8), seed)  # without expand the block keeps Ce = Cin = 8
    return to_device_packed(p, "cpu"), x


def c_cases(se, expand):
    """The three launches' args, chained through the plain versions."""
    pk, x = block(se, expand)
    sc = list(pk["scal"])
    we = pk.get("we")
    a1 = (x, we.wt if we else None, list(we.shape) if we else [], pk.get("ve"), pk["wdw"],
          pk["vdw"], sc, 3, 2, "silu", bool(se))
    yq, pool = torch.ops.ievm.fused_mbconv_expand_dw(*a1)
    cases = [("fused_mbconv_expand_dw", a1)]
    g = None
    if se:
        a2 = (pool, pk["srw"], pk["srb"], pk["sew"], pk["seb"], sc[5] / 16)
        g = torch.ops.ievm.fused_mbconv_se_gate(*a2)
        cases.append(("fused_mbconv_se_gate", a2))
    wp = pk["wp"]
    cases.append(("fused_mbconv_project", (yq, g, wp.wt, list(wp.shape), pk["vp"], None, sc)))
    return cases


def e_case():
    x, w = i8((2, 7, 7, 8), 1), i8((3, 3, 1, 8), 2)
    ws, b = vecs(8)
    args = (x, w, ws, b, 2, 0.05, 120, 0.1, 7.0, "relu6")
    plain = depthwise_conv_int8_plain(x, w, ws, b, stride=2, in_scale=0.05, in_zp=120,
                                      out_scale=0.1, out_zp=7, act="relu6")
    return "dwconv_int8", args, plain


def f_case():
    gw = pack_grouped_weight(i8((3, 3, 4, 16), 1), 4)
    ws, b = vecs(16)
    w_sum = gw.hwio.to(torch.int32).sum((0, 1, 2)).to(torch.int32)
    x = i8((2, 6, 6, 16), 2)
    args = (x, gw.words, gw.hwio, 4, ws, b, w_sum, 1, 0.05, 128, 0.1, 3.0, True)
    plain = grouped_conv_int8_plain(x, gw, ws, b, w_sum, stride=1, in_scale=0.05, in_zp=128,
                                    out_scale=0.1, out_zp=3)
    return "gconv_int8", args, plain


def d_case(dtype):
    x, w, b = f32((5, 16), 1).to(dtype), f32((16, 8), 2, 0.3).to(dtype), f32(8, 3).to(dtype)
    return "dense_gelu", (x, w, b), dense_gelu_plain(x, w, b)


CASES = {
    "a_int8_relu_requant": lambda: a_case("int8", "relu", "int8"),
    "a_fp32_gelu_fp32": lambda: a_case(torch.float32, "gelu", torch.float32),
    "a_bf16_none_bf16": lambda: a_case(torch.bfloat16, "none", torch.bfloat16),
    "a_dynamic": dyn_case,
    "b_relu_requant": lambda: b_case("none"),
    "b_residual_int8": lambda: b_case("int8"),
    "b_residual_fp32": lambda: b_case("fp32"),
    "e_relu6_stride2": e_case,
    "f_cg4": f_case,
    "d_fp32": lambda: d_case(torch.float32),
    "d_bf16": lambda: d_case(torch.bfloat16),
}


def test_every_kernel_entry_point_is_an_op():
    assert set(OPS) == set(_lib._impls)
    for name in OPS:
        assert hasattr(torch.ops.ievm, name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck_and_plain(case):
    name, args, plain = CASES[case]()
    op = getattr(torch.ops.ievm, name)
    torch.library.opcheck(op, args, test_utils=CHECKS)
    got = op(*args)
    assert got.dtype == plain.dtype and got.shape == plain.shape
    assert torch.equal(got, plain)


@pytest.mark.parametrize("se,expand", [(4, True), (0, True), (4, False)],
                         ids=["se_expand", "expand", "se"])
def test_opcheck_fused_mbconv_launches(se, expand):
    for name, args in c_cases(se, expand):
        torch.library.opcheck(getattr(torch.ops.ievm, name), args, test_utils=CHECKS)


@pytest.mark.parametrize("se,expand", [(4, True), (0, True), (4, False)],
                         ids=["se_expand", "expand", "se"])
def test_fused_mbconv_ops_equal_whole_block_plain(se, expand):
    """The three ops in turn equal the block's plain version (the launches'
    intermediate yq, pool and gate are exact), with and without a residual."""
    pk, x = block(se, expand, seed=5)
    for x_res in (None, i8((2, 4, 4, 8), 6)):
        want = fused_mbconv_block_plain(x, pk, kernel=3, stride=2, act="silu", x_res=x_res)
        with_ops = torch.compiler.is_compiling  # the wrapper's switch, forced to the ops
        try:
            _lib.via_op = lambda: True
            got = fused_mbconv_block(x, pk, kernel=3, stride=2, act="silu", x_res=x_res)
        finally:
            _lib.via_op = with_ops
        assert torch.equal(got, want)


def test_export_captures_the_ops():
    """A traced forward holds the ievm op, never a ctypes call."""
    w = pack_weight(i8((20, 6), 1))
    ws, b = vecs(6)
    w_sum = w.kn().to(torch.int32).sum(0).to(torch.int32)

    class M(torch.nn.Module):
        def forward(self, x):
            return int8_matmul_requant(x, w, ws, b, w_sum, in_scale=0.05, in_zp=130,
                                       relu=True)

    x = i8((5, 20), 2)
    ep = torch.export.export(M(), (x,), strict=False)
    targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert "ievm.int8_matmul_requant.default" in targets
    assert torch.equal(ep.module()(x), M()(x))


def test_op_refuses_a_device_without_an_implementation():
    name, args, _ = CASES["a_int8_relu_requant"]()
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        _lib.call(name, *meta)
