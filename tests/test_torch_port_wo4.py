"""W4A16 (``compress/quant/wo4.py``, the engine's ``weight_only_quantize(bits=4)``
and ``load_quantized(..., "weight_only_int4")``) against the JAX package, on
the CPU, for every family: a narrow ResNet18, a tiny ResNeXt (4 groups),
EfficientNet-B0 and MobileNetV2-0.5 at 64x64, a small ViT at 32x32, all from
``chip_smoke.params_from_seed``.

The conversion is numpy on both sides, so the packed int4 leaves, their
group scales and the int8 fallback leaves (odd output counts, the
``keep_int8`` policy's depthwise kernels and short reductions) are EQUAL,
and so are the artifacts' bytes, read across both ways. The dequantized
bf16 trees are EQUAL (the same sign extension, fp32 product and cast).
Logits: the port's engine forward against the JAX engine's, and the port's
loader against the JAX loader (which folds the normalization into an s2d
float stem for the CNNs), within ``TAU`` of the logit scale: twice the
larger of the two deviations this file measures, the same at 1, 2, 4 and 8
torch threads (r18n 6.74e-3, ResNeXt 6.64e-3, B0 5.00e-3, MobileNetV2
3.43e-2, ViT 1.48e-2): the bf16 convs and GEMMs round at other places than
XLA's, and the random-init networks carry it to the logits."""

import functools
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from chip_smoke import params_from_seed
from inference_efficient_vision_models_tpu.cli.quantize import _save_qmodel
from inference_efficient_vision_models_tpu.compress.quant import quant_module as j_quant_module
from inference_efficient_vision_models_tpu.compress.quant import wo4 as jwo4
from inference_efficient_vision_models_tpu.compress.quant.engine import (
    QuantizationEngine as JEngine,
)
from inference_efficient_vision_models_tpu.core.config import QuantConfig as JQuantConfig
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu.serving import load_quantized as j_load
from inference_efficient_vision_models_tpu_torch.compress.quant import wo4 as two4
from inference_efficient_vision_models_tpu_torch.compress.quant import wo8 as two8
from inference_efficient_vision_models_tpu_torch.compress.quant.engine import QuantizationEngine
from inference_efficient_vision_models_tpu_torch.core import artifacts
from inference_efficient_vision_models_tpu_torch.core.config import QuantConfig
from inference_efficient_vision_models_tpu_torch.models import registry as treg
from inference_efficient_vision_models_tpu_torch.serving import load_quantized

try:
    from tests.test_torch_port_prune import narrow_r18_dict, one_thread  # noqa: F401
    from tests.test_torch_port_resnet_float import flat
except ImportError:
    from test_torch_port_prune import narrow_r18_dict, one_thread  # noqa: F401
    from test_torch_port_resnet_float import flat

LOG = logging.getLogger("test_torch_port_wo4")
FAMILIES = {
    "r18n": (narrow_r18_dict(), 64),
    "resnext": (dict(name="tinynext", block="bottleneck", depths=[1, 1], stage_widths=[32, 64],
                     inner_widths=[[[16, 16]], [[32, 32]]], stem_width=16, num_classes=6,
                     groups=4), 64),
    "b0": ("efficientnet_b0", 64),
    "mbv2": ("mobilenet_v2_050", 64),
    "vit": (dict(__kind__="vit", name="vit_test", patch=8, dim=64, depth=2, heads=4,
                 mlp_ratio=4.0, num_classes=6, image_size=32), 32),
}
TAU = {"r18n": 0.0135, "resnext": 0.0133, "b0": 0.01, "mbv2": 0.069, "vit": 0.03}


@functools.lru_cache(maxsize=None)
def family(name, root):
    """Both packages' engines on the family's seeded weights, their W4A16
    conversions and forwards, and the JAX stage-4 writer's artifact."""
    sd, size = FAMILIES[name]
    jspec = jreg.make_spec(sd, 6) if isinstance(sd, str) else jreg.spec_from_dict(sd)
    tspec = treg.spec_from_dict(jspec.to_dict())
    p, s = params_from_seed(tspec, 0)
    kw = dict(batch_size=8, image_size=(size, size), calibration_images=16)
    je = JEngine(JQuantConfig(artifacts_root=root, **kw), jspec, p, s, LOG)
    te = QuantizationEngine(QuantConfig(artifacts_root=root, **kw), tspec,
                            treg.params_from_jax(tspec, p, "cpu"),
                            treg.params_from_jax(tspec, s, "cpu"), LOG, "cpu")
    jm, jfn = je.weight_only_quantize(bits=4)
    tm, tfn = te.weight_only_quantize(bits=4)
    fold = os.path.join(root, name, "fold_0")
    _save_qmodel(fold, "weight_only_int4", jm, jspec)
    x = np.random.default_rng(5).integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    return dict(jspec=jspec, tspec=tspec, je=je, te=te, jm=jax.device_get(jm), jfn=jfn, tm=tm,
                tfn=tfn, fold=fold, x=x)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("wo4"))


def _leaf_kinds(tree):
    kinds = {"q4": 0, "q": 0}
    if isinstance(tree, dict):
        if set(tree) == {"q4", "s"} or set(tree) == {"q", "s"}:
            kinds["q4" if "q4" in tree else "q"] += 1
            return kinds
        for v in tree.values():
            for k, n in _leaf_kinds(v).items():
                kinds[k] += n
    return kinds


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_conversion_equals_jax(name, root):
    """Leaf for leaf: the packed nibbles, group scales and int8 fallbacks."""
    m = family(name, root)
    fj, ft = flat(m["jm"]), flat(m["tm"])
    assert fj.keys() == ft.keys()
    for k in fj:
        assert ft[k].dtype == fj[k].dtype and np.array_equal(ft[k], fj[k]), k
    kinds = _leaf_kinds(m["tm"])
    assert kinds["q4"] > 0
    if name in ("b0", "mbv2"):  # depthwise kernels and the 27-deep stem stay int8
        assert kinds["q"] > 0
    assert two4.is_weight_only_int4(m["tm"]) and jwo4.is_weight_only_int4(m["jm"])
    assert m["je"].size_mb(m["jm"]) == m["te"].size_mb(m["tm"])


def test_fallback_and_policy_leaves():
    """Odd output counts keep int8; the default policy keeps depthwise
    kernels and reductions shorter than 32 int8; ``keep_int8=...False``
    packs every even-output kernel; biases and other leaves pass through."""
    rng = np.random.default_rng(0)
    tree = {"odd": {"w": rng.standard_normal((16, 5)).astype(np.float32),
                    "b": rng.standard_normal(5).astype(np.float32)},
            "dw": {"w": rng.standard_normal((3, 3, 1, 8)).astype(np.float32)},
            "stem": {"w": rng.standard_normal((3, 3, 3, 8)).astype(np.float32)},
            "conv": {"w": rng.standard_normal((3, 3, 12, 8)).astype(np.float32)},
            "fc": {"w": rng.standard_normal((100, 6)).astype(np.float32)},
            "scale": rng.standard_normal(8).astype(np.float32)}
    never = lambda p, a: False  # noqa: E731
    for mine, theirs in ((two4._keep_int8_auto, jwo4._keep_int8_auto), (never, never)):
        got = two4.convert_weight_only_int4(tree, keep_int8=mine)
        ref = jax.device_get(jwo4.convert_weight_only_int4(tree, keep_int8=theirs))
        fj, ft = flat(ref), flat(got)
        assert fj.keys() == ft.keys()
        for k in fj:
            assert ft[k].dtype == fj[k].dtype and np.array_equal(ft[k], fj[k]), k
        np.testing.assert_array_equal(
            two4.dequantize(got, torch.float32)["fc"]["w"].numpy(),
            np.asarray(jwo4.dequantize(ref, jnp.float32)["fc"]["w"]))
    assert set(got["odd"]["w"]) == {"q", "s"} and set(got["conv"]["w"]) == {"q4", "s"}
    auto = two4.convert_weight_only_int4(tree)
    assert set(auto["dw"]["w"]) == set(auto["stem"]["w"]) == {"q", "s"}
    assert set(got["dw"]["w"]) == set(got["stem"]["w"]) == {"q4", "s"}
    # (100, 6): r = 100, groups of 50 (the largest divisor <= 64), 3 packed bytes a row
    assert got["fc"]["w"]["q4"].shape == (100, 3) and got["fc"]["w"]["s"].shape == (2, 6)
    # a W4A16 tree with int8 fallbacks is int4, not W8A16 alone
    assert two4.is_weight_only_int4(auto) and two8.is_weight_only(auto)
    assert not two4.is_weight_only_int4(two8.convert_weight_only(tree))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_dequantize_equals_jax(name, root):
    """The bf16 tree the forward runs on, bit for bit (JAX dequantizes inside
    its jitted forward: jitted here too)."""
    m = family(name, root)
    deq = jax.jit(lambda t: jax.tree.map(lambda a: a.astype(jnp.float32),
                                         jwo4.dequantize(t, jnp.bfloat16)))
    ref = flat(jax.device_get(deq(m["jm"])))
    got = two4.dequantize(m["tm"], torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in jax.tree.leaves(got)
               if v.is_floating_point())
    got = flat(jax.tree.map(lambda v: v.float().numpy() if v.is_floating_point() else v.numpy(),
                            got))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _close(got, ref, tau):
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= tau * np.abs(ref).max()


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_engine_logits_match_jax(name, root):
    m = family(name, root)
    ref = np.asarray(m["jfn"](jnp.asarray(m["x"])), np.float32)
    with torch.no_grad():
        got = m["tfn"](torch.from_numpy(m["x"])).float().numpy()
    _close(got, ref, TAU[name])


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_load_quantized_matches_jax_loader(name, root):
    """The JAX stage-4 writer's artifact through both packages' loaders."""
    m = family(name, root)
    _, _, j_fn, j_pre = j_load(m["fold"], "weight_only_int4")
    spec, model, fn, pre = load_quantized(m["fold"], "weight_only_int4", device="cpu")
    assert spec == m["tspec"] and pre is None and j_pre is None
    ref = np.asarray(j_fn(jnp.asarray(m["x"])), np.float32)
    with torch.no_grad():
        got = fn(torch.from_numpy(m["x"])).float().numpy()
    _close(got, ref, TAU[name])
    with torch.no_grad():  # the same forward as the engine's
        np.testing.assert_array_equal(got, m["tfn"](torch.from_numpy(m["x"])).float().numpy())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_artifacts_read_across(name, root):
    """The port's artifact bytes are the JAX writer's; each package reads the
    other's file into its own leaves."""
    m = family(name, root)
    mine = artifacts.tree_bytes(m["te"].q.serializable(m["tm"]))
    with open(os.path.join(m["fold"], "model_weight_only_int4.msgpack"), "rb") as f:
        theirs = f.read()
    assert mine == theirs
    read = artifacts.load_checkpoint_raw(m["fold"], "weight_only_int4")
    fj, ft = flat(read), flat(m["tm"])
    assert fj.keys() == ft.keys() and all(np.array_equal(fj[k], ft[k]) for k in fj)
    back = flat(serialization.msgpack_restore(mine))
    ref = flat(j_quant_module(m["jspec"]).serializable(m["jm"]))
    assert back.keys() == ref.keys() and all(np.array_equal(back[k], ref[k]) for k in ref)
