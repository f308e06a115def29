"""The committed static-INT8 EfficientNet-B0 artifact, its golden logits and
the port's EfficientNet pieces against the JAX package, on the CPU.

The artifact (``inference_efficient_vision_models_tpu_torch/testdata/effnet_b0_int8/``)
is a 6-class EfficientNet-B0 at full width and depth, 224x224 raw uint8
input, made by the JAX package from a seeded random init whose BN statistics
are recalibrated on surrogate images (so its logits are O(10), not ~1e-4);
it is not trained and no accuracy is claimed for it. The goldens are the JAX
package's ``apply_int8_fused(interpret=True)`` logits of 8 seeded random
images. Running this file as a script rewrites both:
``JAX_PLATFORMS=cpu python tests/test_torch_port_effnet.py``.
"""

import json
import os
import sys
import time

import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch
from flax import serialization

from inference_efficient_vision_models_tpu.compress.quant import fusedpath as jfp
from inference_efficient_vision_models_tpu.compress.quant import qeffnet as jqe
from inference_efficient_vision_models_tpu.compress.quant import stemfold as jsf
from inference_efficient_vision_models_tpu.models import efficientnet as jeff
from inference_efficient_vision_models_tpu.models.registry import spec_from_dict as j_spec
from inference_efficient_vision_models_tpu.ops.fused_mbconv import fused_mbconv_block as j_block
from inference_efficient_vision_models_tpu_torch.compress.quant import fusedpath as tfp
from inference_efficient_vision_models_tpu_torch.compress.quant import stemfold as tsf
from inference_efficient_vision_models_tpu_torch.core.artifacts import load_checkpoint_raw
from inference_efficient_vision_models_tpu_torch.models import efficientnet as teff
from inference_efficient_vision_models_tpu_torch.models.registry import spec_from_dict as t_spec
from inference_efficient_vision_models_tpu_torch.ops.fused_mbconv import fused_mbconv_block_plain
from inference_efficient_vision_models_tpu_torch.serving import Predictor, load_quantized

try:
    from tests.test_torch_port_fused_mbconv import (
        assert_logits_close,
        assert_within_one_quantum,
        quantized_jax_model,
    )
except ImportError:  # run as a script
    from test_torch_port_fused_mbconv import (
        assert_logits_close,
        assert_within_one_quantum,
        quantized_jax_model,
    )

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "inference_efficient_vision_models_tpu_torch", "testdata")
ARTIFACT = os.path.join(TESTDATA, "effnet_b0_int8")
GOLDEN = os.path.join(TESTDATA, "effnet_b0_jax_logits.npz")
GOLDEN_SEED, GOLDEN_SHAPE = 0, (8, 224, 224, 3)
BLOCK_IMAGES = 2  # images whose stem and block outputs the goldens keep


def golden_images() -> np.ndarray:
    return np.random.default_rng(GOLDEN_SEED).integers(0, 256, GOLDEN_SHAPE, dtype=np.uint8)


def _jax_artifact():
    with open(os.path.join(ARTIFACT, "spec.json")) as f:
        spec = j_spec(json.load(f))
    with open(os.path.join(ARTIFACT, "model_static_int8.msgpack"), "rb") as f:
        return spec, jqe.restore_derived(serialization.msgpack_restore(f.read()))


def jax_fused_logits(spec, qm, imgs: np.ndarray) -> np.ndarray:
    qf = jfp.pack_fused(spec, qm)
    qj = jax.tree.map(jnp.asarray, qm)
    return np.concatenate([
        np.asarray(jfp.apply_int8_fused(spec, qj, qf, jnp.asarray(imgs[i : i + 4]),
                                        interpret=True))
        for i in range(0, len(imgs), 4)])


def jax_block_outputs(spec, qm, imgs: np.ndarray) -> dict:
    """The JAX package's stem output and every fused block's int8 output
    (``fused_mbconv_block(interpret=True)``), each block fed the previous
    one's output, as ``apply_int8_fused`` chains them."""
    qf = jfp.pack_fused(spec, qm)
    stem = jax.tree.map(jnp.asarray, qm["stem"])
    y = jsf.apply_u8_stem(stem, jnp.asarray(imgs), stride=2, pad=1, act="silu")
    cur = jqe._requant(y, stem["out_scale"], stem["out_zp"])
    out = {"block_stem": np.asarray(cur)}
    for name, k, stride, residual in tfp.block_plan(t_spec(spec.to_dict())):
        cur = j_block(cur, qf[name], kernel=k, stride=stride, act="silu",
                      x_res=cur if residual else None, interpret=True)
        out[f"block_{name}"] = np.asarray(cur)
    return out


@pytest.fixture(scope="module")
def port_model():
    return tfp.load_static_int8_fused(ARTIFACT, device="cpu")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_golden_logits_are_current(golden):
    """The committed goldens are what the JAX package computes today from the
    committed msgpack (equal up to float summation order)."""
    assert int(golden["seed"]) == GOLDEN_SEED and tuple(golden["shape"]) == GOLDEN_SHAPE
    spec, qm = _jax_artifact()
    ref = jax_fused_logits(spec, qm, golden_images())
    np.testing.assert_allclose(golden["logits"], ref, rtol=1e-5, atol=1e-5)
    for k, v in jax_block_outputs(spec, qm, golden_images()[:BLOCK_IMAGES]).items():
        np.testing.assert_array_equal(golden[k], v, err_msg=k)


def test_blocks_match_jax_blocks(port_model, golden):
    """Every block fed JAX's own input to it: the port's int8 output within
    one quantum of JAX's, >= 98% exact (the check that decides correctness;
    flips do not compound)."""
    names = ["stem"] + [name for name, *_ in tfp.block_plan(port_model.spec)]
    with torch.inference_mode():
        stem = tfp.stem_int8(port_model.q, torch.from_numpy(golden_images()[:BLOCK_IMAGES]),
                             impl="plain")
        np.testing.assert_array_equal(stem.numpy(), golden["block_stem"])
        for (name, k, stride, residual), src in zip(tfp.block_plan(port_model.spec), names):
            x = torch.from_numpy(golden[f"block_{src}"])
            got = fused_mbconv_block_plain(x, port_model.qf[name], kernel=k, stride=stride,
                                           act="silu", x_res=x if residual else None)
            assert_within_one_quantum(got.numpy(), golden[f"block_{name}"])


def test_artifact_matches_jax_goldens(port_model, golden):
    with torch.inference_mode():
        got = port_model(torch.from_numpy(golden_images())).numpy()
    assert_logits_close(got, golden["logits"])


def test_served_through_predictor(port_model, golden):
    """load_quantized dispatches on the spec: the fused executor, raw uint8
    (no host preprocess), the same logits as the model itself."""
    spec, model, fn, pre = load_quantized(ARTIFACT, "static_int8_fused", device="cpu")
    assert isinstance(spec, teff.EfficientNetSpec) and pre is None
    pred = Predictor.from_artifact(ARTIFACT, "static_int8_fused", device="cpu", batch_size=4,
                                   bucket_sizes=(1,))
    imgs = golden_images()[:5]
    got = pred.predict_logits(imgs)
    with torch.inference_mode():
        ref = port_model(torch.from_numpy(imgs)).numpy()
    assert got.shape == (5, 6)
    np.testing.assert_array_equal(got, ref)
    # the unfused and mixed executors serve the same artifact (the shared
    # model_static_int8.msgpack), each equal to its own plain path
    for method, executor in (("static_int8", "int8"), ("static_int8_mixed", "mixed")):
        spec, model, fn, pre = load_quantized(ARTIFACT, method, device="cpu")
        assert pre is None and model.executor == executor
        with torch.inference_mode():
            got = fn(torch.from_numpy(imgs))
            np.testing.assert_array_equal(got.numpy(),
                                          model(torch.from_numpy(imgs), impl="plain").numpy())
        assert got.shape == (5, 6) and torch.isfinite(got).all()
    with pytest.raises(NotImplementedError, match="queue 1"):
        load_quantized(ARTIFACT, "static_int8_bf16", device="cpu")


def test_artifact_reads_as_jax_does():
    """The pure-Python reader gives the JAX restore leaf for leaf; the spec
    round-trips; the stem offset map is rebuilt as JAX rebuilds it."""
    spec, qm = _jax_artifact()
    raw = load_checkpoint_raw(ARTIFACT, "static_int8")
    assert "e" not in raw["stem"]  # derived, never serialized
    flat_t = jax.tree_util.tree_leaves_with_path(raw)
    flat_j = jax.tree_util.tree_leaves_with_path(jqe.serializable(qm))
    assert len(flat_t) == len(flat_j)
    for (pt, vt), (pj, vj) in zip(flat_t, flat_j):
        assert pt == pj
        np.testing.assert_array_equal(np.asarray(vt), np.asarray(vj))
    with open(os.path.join(ARTIFACT, "spec.json")) as f:
        d = json.load(f)
    assert t_spec(d).to_dict() == j_spec(d).to_dict()
    assert json.loads(json.dumps(t_spec(d).to_dict())) == d
    got = tsf.restore_offsets(raw["stem"])["e"]
    ref = jsf.restore_offsets(raw["stem"])["e"]
    assert got.shape == ref.shape == (1, 112, 112, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(jeff._VARIANTS))
def test_spec_matches_jax(name):
    got = teff.efficientnet_spec(name, num_classes=6)
    ref = jeff.efficientnet_spec(name, num_classes=6)
    assert got.to_dict() == ref.to_dict()
    assert teff.EfficientNetSpec.from_dict(got.to_dict()) == got
    assert t_spec(ref.to_dict()) == got
    for s, d in enumerate(ref.depths):
        for b in range(d):
            assert got.block_stride(s, b) == ref.block_stride(s, b)
            assert got.has_residual(s, b) == ref.has_residual(s, b)
    for v in (3.0, 20.0, 37.4, 1151.0):
        assert teff._make_divisible(v) == jeff._make_divisible(v)


def test_spec_errors():
    with pytest.raises(ValueError):
        teff.efficientnet_spec("efficientnet_b9")
    with pytest.raises(NotImplementedError):
        t_spec({"__kind__": "convnext"})
    # a MobileNetV2 dict (by __kind__, or by its hidden_widths) is no error now
    from inference_efficient_vision_models_tpu.models.mobilenet import mobilenet_v2_spec

    d = mobilenet_v2_spec("mobilenet_v2", 6).to_dict()
    assert t_spec(d).to_dict() == d
    assert t_spec({k: v for k, v in d.items() if k != "__kind__"}).to_dict() == d


def _logit_stats(logits: np.ndarray) -> str:
    top2 = np.sort(logits, axis=1)[:, -2:]
    margins = top2[:, 1] - top2[:, 0]
    return (f"logits in [{logits.min():.4f}, {logits.max():.4f}], max|logit| "
            f"{np.abs(logits).max():.4f}, top-2 margins {np.round(margins, 4).tolist()}")


def write_artifact_and_goldens() -> None:
    """Make the committed artifact with the JAX package's own functions, then
    its golden logits."""
    spec, q = quantized_jax_model("efficientnet_b0", 224)
    os.makedirs(ARTIFACT, exist_ok=True)
    with open(os.path.join(ARTIFACT, "spec.json"), "w") as f:
        json.dump(spec.to_dict(), f)
    with open(os.path.join(ARTIFACT, "model_static_int8.msgpack"), "wb") as f:
        f.write(serialization.msgpack_serialize(jqe.serializable(q)))
    with open(os.path.join(ARTIFACT, "provenance.json"), "w") as f:
        json.dump({
            "stage": "quantization",
            "spec_name": spec.name,
            "num_classes": spec.num_classes,
            "image_size": [224, 224],
            "methods": ["static_int8", "static_int8_fused"],
            "weights": "random init (create_model, jax.random.PRNGKey(0)), BN statistics "
                       "recalibrated (train/bn_recal.recalibrate_bn) on 48 surrogate images "
                       "(make_synthetic_neudet(8, 224, seed=7)); not trained: this artifact "
                       "checks shapes and numerics, and no accuracy is claimed for it",
            "calibration": "minmax observers on 32 of those images",
            "conversion": "qeffnet.fold -> calibrate -> convert_static_int8(fold_input=True) "
                          "-> serializable",
            "made_by": "JAX_PLATFORMS=cpu python tests/test_torch_port_effnet.py",
        }, f, indent=1)
    spec, qm = _jax_artifact()
    t0 = time.perf_counter()
    logits = jax_fused_logits(spec, qm, golden_images())
    blocks = jax_block_outputs(spec, qm, golden_images()[:BLOCK_IMAGES])
    np.savez_compressed(GOLDEN, logits=logits.astype(np.float32), seed=np.int64(GOLDEN_SEED),
                        shape=np.asarray(GOLDEN_SHAPE, np.int64), **blocks)
    print(f"wrote {ARTIFACT} and {GOLDEN} in {time.perf_counter() - t0:.1f} s: "
          f"{_logit_stats(logits)}")


if __name__ == "__main__":
    write_artifact_and_goldens()
