"""The port's fused MBConv block and executor against the JAX package, on the CPU.

JAX runs ``fused_mbconv_block(interpret=True)`` / ``apply_int8_fused(interpret=True)``
(the Pallas kernel in interpret mode, as tests/test_fused_mbconv.py runs it);
the port runs its kernels' plain PyTorch versions. The models are
``create_model`` + BN recalibration + ``calibrate`` + ``convert_static_int8``
at 64x64, carried over leaf for leaf. Block outputs agree within one requant
quantum with >= 98% of values exact: the only differences are the SE gate
(fp32 mean and FCs in JAX, float64 from the exact integer sum in the port)
and the SiLU/sigmoid ulps, which move a value across a rounding edge now and
then.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inference_efficient_vision_models_tpu.compress.quant import fusedpath as jfp
from inference_efficient_vision_models_tpu.compress.quant import qeffnet as jqe
from inference_efficient_vision_models_tpu.compress.quant import stemfold as jsf
from inference_efficient_vision_models_tpu.compress.quant.engine import quant_module
from inference_efficient_vision_models_tpu.data.pipeline import Batches
from inference_efficient_vision_models_tpu.data.synthetic import make_synthetic_neudet
from inference_efficient_vision_models_tpu.models import create_model
from inference_efficient_vision_models_tpu.ops.fused_mbconv import fused_mbconv_block as j_block
from inference_efficient_vision_models_tpu.train.bn_recal import recalibrate_bn
from inference_efficient_vision_models_tpu_torch.compress.quant import fusedpath as tfp
from inference_efficient_vision_models_tpu_torch.models.registry import (
    spec_from_dict as t_spec_from_dict,
)
from inference_efficient_vision_models_tpu_torch.ops.fused_mbconv import (
    fused_mbconv_block,
    fused_mbconv_block_plain,
    to_device_packed,
)

SIZE = 64
# Logits: |port - JAX| <= TAU * max|JAX|, with the same argmax where JAX's
# top-2 margin exceeds twice that. Twice the largest deviation measured on the
# committed artifact's goldens (0.13 of the logit scale, PERF.md): a single
# one-quantum flip in an early block (1 of 65,536 values, from an ulp of the SE
# gate) grows to tens of quanta over the 16 blocks of a random-init network,
# so the per-block checks, not the logits, decide correctness.
TAU = 0.26


def quantized_jax_model(name: str, size: int):
    """create_model -> BN recalibration on 48 surrogate images -> fold ->
    calibrate on 32 -> convert_static_int8 (u8-folded stem); numpy leaves.
    Without the recalibration a fresh init's activations collapse and its
    logits are ~1e-4, too small to check anything against."""
    spec, params, state = create_model(name, num_classes=6, key=jax.random.PRNGKey(0))
    imgs, labels = make_synthetic_neudet(8, image_size=size, seed=7)
    state = recalibrate_bn(spec, params, state, imgs)
    qmod = quant_module(spec)
    folded = qmod.fold(spec, params, state)
    obs = qmod.calibrate(spec, folded, Batches(imgs[:32], labels[:32], 8), max_images=32)
    q = qmod.convert_static_int8(spec, folded, obs, fold_input=True, image_size=(size, size))
    return spec, jax.tree.map(np.asarray, q)


def assert_within_one_quantum(got, ref, min_exact=0.98):
    got, ref = np.asarray(got, np.int32), np.asarray(ref, np.int32)
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    assert d.max() <= 1, (d.max(), (d > 1).mean())
    assert (d == 0).mean() >= min_exact, (d == 0).mean()


def assert_logits_close(got, ref, tau=TAU):
    """Scale-relative: |got - ref| <= tau * max|ref|, and the same argmax
    wherever the reference's top-2 margin exceeds twice that."""
    assert got.shape == ref.shape and np.isfinite(got).all()
    atol = tau * np.abs(ref).max()
    assert np.abs(got - ref).max() <= atol, (np.abs(got - ref).max(), atol)
    top2 = np.sort(ref, axis=1)[:, -2:]
    wide = top2[:, 1] - top2[:, 0] > 2 * atol
    np.testing.assert_array_equal(got.argmax(1)[wide], ref.argmax(1)[wide])


@pytest.fixture(scope="module")
def effnet64():
    return quantized_jax_model("efficientnet_b0", SIZE)


@pytest.fixture(scope="module")
def mbv2_64():
    return quantized_jax_model("mobilenet_v2_050", SIZE)


def _block_io(spec, q, s, b, n=2, seed=0):
    """Shapes and domains of block (s, b) at SIZE: (x, x_res or None, in_scale, in_zp)."""
    prev = q["stem"] if (s, b) == (0, 0) else (
        q[f"stage{s}"][str(b - 1)] if b else q[f"stage{s - 1}"][str(spec.depths[s - 1] - 1)])
    in_scale, in_zp = prev["out_scale"], int(prev["out_zp"])
    h = SIZE // 2
    for ss in range(s + 1):
        for bb in range(spec.depths[ss]):
            if (ss, bb) == (s, b):
                break
            h = (h - 1) // spec.block_stride(ss, bb) + 1
    rng = np.random.default_rng(seed + 10 * s + b)
    x = np.clip(np.rint(rng.normal(in_zp - 128 + 10, 30, (n, h, h, spec.block_in_width(s, b)))),
                -128, 127).astype(np.int8)
    return x, (x if spec.has_residual(s, b) else None), in_scale, in_zp


def _check_block(spec, q, s, b, act):
    x, res, in_scale, in_zp = _block_io(spec, q, s, b)
    kern = spec.stage_kernels[s] if hasattr(spec, "stage_kernels") else 3
    stride = spec.block_stride(s, b)
    j_packed = jfp.pack_fused(spec, q)[f"s{s}b{b}"]
    ref = np.asarray(j_block(jnp.asarray(x), j_packed, kernel=kern, stride=stride, act=act,
                             x_res=None if res is None else jnp.asarray(res), interpret=True))
    se = "se_reduce" in q[f"stage{s}"][str(b)]
    t_np = tfp._pack_block(q[f"stage{s}"][str(b)], in_scale, in_zp, se=se)
    for k, v in j_packed.items():
        np.testing.assert_array_equal(t_np[k], v, err_msg=k)
    packed = to_device_packed(t_np, "cpu")
    xt = torch.from_numpy(x)
    rt = None if res is None else torch.from_numpy(res)
    got = fused_mbconv_block_plain(xt, packed, kernel=kern, stride=stride, act=act, x_res=rt)
    # on a CPU tensor the wrapper takes the plain version
    same = fused_mbconv_block(xt, packed, kernel=kern, stride=stride, act=act, x_res=rt)
    assert torch.equal(got, same)
    assert_within_one_quantum(got.numpy(), ref)
    return t_np


@pytest.mark.parametrize("s,b", [(0, 0), (1, 0), (2, 0), (1, 1)],
                         ids=["s0b0_no_expand", "s1b0_stride2_k3", "s2b0_stride2_k5",
                              "s1b1_residual"])
def test_effnet_block_plain_matches_jax_kernel(effnet64, s, b):
    spec, q = effnet64
    t_np = _check_block(spec, q, s, b, "silu")
    assert ("we" in t_np) == spec.has_expand[s][b] and "srw" in t_np


@pytest.mark.parametrize("s,b", [(0, 0), (2, 1)], ids=["s0b0_no_expand", "s2b1_residual"])
def test_mobilenet_block_plain_matches_jax_kernel(mbv2_64, s, b):
    """relu6 and no SE gate (MobileNetV2), with and without expand."""
    spec, q = mbv2_64
    t_np = _check_block(spec, q, s, b, "relu6")
    assert "srw" not in t_np


def test_pack_fused_matches_jax_leaf_for_leaf(effnet64):
    spec, q = effnet64
    ref = jfp.pack_fused(spec, q)
    got = tfp.pack_fused(t_spec_from_dict(spec.to_dict()), q)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name].keys() == ref[name].keys(), name
        for k, v in ref[name].items():
            assert got[name][k].dtype == np.asarray(v).dtype, (name, k)
            np.testing.assert_array_equal(got[name][k], v, err_msg=f"{name}.{k}")


def _jax_stem(q, x):
    stem = q["stem"]
    y = jsf.apply_u8_stem(stem, jnp.asarray(x), stride=2, pad=1, act="silu")
    return jqe._requant(y, stem["out_scale"], stem["out_zp"])


def test_whole_model_blockwise_then_end_to_end(effnet64):
    """Each block fed JAX's own input to that block: within one quantum.
    Then the port (plain) end to end against JAX apply_int8_fused."""
    spec, q = effnet64
    imgs = np.random.default_rng(5).integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    model = tfp.from_jax_qmodel(spec.to_dict(), q, device="cpu")
    qj = jax.tree.map(jnp.asarray, q)
    j_packed = jfp.pack_fused(spec, q)

    cur_j = _jax_stem(qj, imgs)
    with torch.inference_mode():
        cur_t = tfp.stem_int8(model.q, torch.from_numpy(imgs), impl="plain")
    assert_within_one_quantum(cur_t.numpy(), np.asarray(cur_j), min_exact=0.99)
    for name, k, stride, residual in tfp.block_plan(spec):
        x_np = np.array(cur_j)  # a writable copy for torch.from_numpy
        nxt = j_block(cur_j, j_packed[name], kernel=k, stride=stride, act="silu",
                      x_res=cur_j if residual else None, interpret=True)
        xt = torch.from_numpy(x_np)
        with torch.inference_mode():
            got = fused_mbconv_block_plain(xt, model.qf[name], kernel=k, stride=stride,
                                           act="silu", x_res=xt if residual else None)
        assert_within_one_quantum(got.numpy(), np.asarray(nxt))
        cur_j = nxt

    ref = np.asarray(jfp.apply_int8_fused(spec, qj, j_packed, jnp.asarray(imgs), interpret=True))
    assert np.abs(ref).max() > 1.0  # BN recalibration keeps the logits off zero
    with torch.inference_mode():
        got = model(torch.from_numpy(imgs)).numpy()
        plain = model(torch.from_numpy(imgs), impl="plain").numpy()
    np.testing.assert_array_equal(got, plain)  # a CPU tensor takes the plain versions
    assert_logits_close(got, ref)


def test_mobilenet_model_blockwise_then_end_to_end(mbv2_64):
    """The fused executor serves MobileNetV2 (ReLU6, no SE gate, the relu6
    stem and head): each block fed JAX's own input within one quantum, then
    the port (plain) end to end against JAX apply_int8_fused(interpret=True):
    equal (ReLU6 is exact and both sides requantize alike; the CPU measures 0)."""
    from inference_efficient_vision_models_tpu.compress.quant import qmobilenet as jqm
    from inference_efficient_vision_models_tpu_torch.compress.quant import qmobilenet as tqm

    spec, q = mbv2_64
    imgs = np.random.default_rng(5).integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    model = tfp.from_jax_qmodel(spec.to_dict(), q, device="cpu")
    qj = jax.tree.map(jnp.asarray, q)
    j_packed = jfp.pack_fused(spec, q)
    stem = qj["stem"]
    cur_j = jqm._requant(jsf.apply_u8_stem(stem, jnp.asarray(imgs), stride=2, pad=1, relu6=True),
                         stem["out_scale"], stem["out_zp"])
    with torch.inference_mode():
        cur_t = tfp.stem_int8(model.q, torch.from_numpy(imgs), impl="plain", act=tqm.ACT)
    np.testing.assert_array_equal(cur_t.numpy(), np.asarray(cur_j))
    plan = tqm.block_plan(model.spec)
    assert len(plan) == 17 and all(k == 3 for _, k, _, _ in plan)
    for name, k, stride, residual in plan:
        x_np = np.array(cur_j)
        nxt = j_block(cur_j, j_packed[name], kernel=k, stride=stride, act="relu6",
                      x_res=cur_j if residual else None, interpret=True)
        xt = torch.from_numpy(x_np)
        with torch.inference_mode():
            got = fused_mbconv_block_plain(xt, model.qf[name], kernel=k, stride=stride,
                                           act="relu6", x_res=xt if residual else None)
        assert_within_one_quantum(got.numpy(), np.asarray(nxt))
        cur_j = nxt

    ref = np.asarray(jfp.apply_int8_fused(spec, qj, j_packed, jnp.asarray(imgs), interpret=True))
    with torch.inference_mode():
        got = model(torch.from_numpy(imgs)).numpy()
        plain = model(torch.from_numpy(imgs), impl="plain").numpy()
    np.testing.assert_array_equal(got, plain)  # a CPU tensor takes the plain versions
    np.testing.assert_array_equal(got, ref)
