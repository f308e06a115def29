"""The port's static-INT8 ResNet executor against the JAX package, on the CPU.

JAX runs ``qresnet.apply_int8(impl="lax")`` (XLA's int8 convs); the port
runs its kernels' plain PyTorch versions. The two differ only where a
requantization rounds a tie the other way (the port's kernels multiply by
1/s_y as the Pallas kernels do, lax divides), so logits agree within
rtol/atol 0.02 and the argmax is identical.

Running this file as a script rewrites the committed golden logits that
``chip_smoke.py`` holds the GPU against:
``JAX_PLATFORMS=cpu python tests/test_torch_port_qresnet.py``.
"""

import json
import logging
import os
import sys

import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch
from flax import serialization

from inference_efficient_vision_models_tpu.compress.quant import qresnet as jq
from inference_efficient_vision_models_tpu.compress.quant.engine import QuantizationEngine
from inference_efficient_vision_models_tpu.data.synthetic import make_synthetic_neudet
from inference_efficient_vision_models_tpu.models import create_model, resnet_spec
from inference_efficient_vision_models_tpu.models.registry import spec_from_dict
from inference_efficient_vision_models_tpu.models.widths import ResNetSpec
from inference_efficient_vision_models_tpu.ops.space_to_depth import space_to_depth_u8
from inference_efficient_vision_models_tpu_torch.compress.quant import qresnet as tq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "bench", "quantization", "r2", "fold_0")
GOLDEN = os.path.join(ROOT, "inference_efficient_vision_models_tpu_torch", "testdata",
                      "r2_fold0_jax_logits.npz")
GOLDEN_SEED, GOLDEN_SHAPE = 0, (16, 224, 224, 3)


def golden_images() -> np.ndarray:
    return np.random.default_rng(GOLDEN_SEED).integers(0, 256, GOLDEN_SHAPE, dtype=np.uint8)


def _jax_artifact():
    with open(os.path.join(ARTIFACT, "spec.json")) as f:
        spec = spec_from_dict(json.load(f))
    with open(os.path.join(ARTIFACT, "model_static_int8.msgpack"), "rb") as f:
        return spec, jq.restore_derived(serialization.msgpack_restore(f.read()))


def jax_artifact_logits(imgs: np.ndarray) -> np.ndarray:
    """JAX apply_int8(impl="lax") of the committed artifact, s2d input as bench.py feeds it."""
    spec, qm = _jax_artifact()
    fwd = jax.jit(lambda q, x: jq.apply_int8(spec, q, x))
    return np.concatenate([np.asarray(fwd(qm, jnp.asarray(space_to_depth_u8(imgs[i : i + 8]))))
                           for i in range(0, len(imgs), 8)])


def _assert_logits_match(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0.02, atol=0.02)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


@pytest.fixture(scope="module")
def port_model():
    return tq.load_static_int8(ARTIFACT, device="cpu")


@pytest.fixture(scope="module")
def golden_jax_logits():
    return jax_artifact_logits(golden_images())


def test_golden_logits_are_current(golden_jax_logits):
    """The committed golden file is what the JAX package computes today
    (equal up to float summation order)."""
    g = np.load(GOLDEN)
    assert int(g["seed"]) == GOLDEN_SEED and tuple(g["shape"]) == GOLDEN_SHAPE
    np.testing.assert_allclose(g["logits"], golden_jax_logits, rtol=1e-6, atol=1e-5)


def test_artifact_matches_jax_on_random_images(port_model, golden_jax_logits):
    with torch.inference_mode():
        got = port_model(torch.from_numpy(golden_images())).numpy()
    _assert_logits_match(got, golden_jax_logits)


def test_artifact_matches_jax_on_heldout_split(port_model):
    """16 images of the artifact's held-out split, rebuilt from its provenance
    (bench.py:384-395: synthetic_size 600, 6 classes, seed 42 -> test seed 43)."""
    with open(os.path.join(ARTIFACT, "provenance.json")) as f:
        dp = json.load(f)["data"]
    per_class = max(max(dp["synthetic_size"] // dp["num_classes"], dp["num_folds"]) // 2,
                    dp["num_folds"])
    imgs, _ = make_synthetic_neudet(per_class, dp["image_size"][0], dp["num_classes"],
                                    seed=dp["seed"] + 1)
    imgs = imgs[:16]
    with torch.inference_mode():
        got = port_model(torch.from_numpy(imgs)).numpy()
    _assert_logits_match(got, jax_artifact_logits(imgs))


def test_stem_offsets_match_jax():
    with open(os.path.join(ARTIFACT, "model_static_int8.msgpack"), "rb") as f:
        stem = serialization.msgpack_restore(f.read())["stem"]
    assert "e" not in stem and "e4" not in stem  # derived, never serialized
    ref = jq.restore_stem_offsets(stem)
    got = tq.restore_stem_offsets(stem)
    for k in ("e", "e4"):
        assert got[k].shape == ref[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5)


def _narrow(name, block, depths, stage_widths, inner, stem_width):
    n_inner = 1 if block == "basic" else 2
    return ResNetSpec(
        name=name, block=block, depths=depths, stage_widths=stage_widths,
        inner_widths=tuple(tuple((w,) * n_inner for _ in range(d)) for d, w in zip(depths, inner)),
        stem_width=stem_width, num_classes=6)


@pytest.mark.parametrize("spec", [
    _narrow("resnet18", "basic", (2, 2, 2, 2), (16, 24, 32, 40), (16, 24, 32, 40), 16),
    _narrow("resnet50", "bottleneck", (3, 4, 6, 3), (32, 48, 64, 96), (8, 16, 24, 32), 16),
], ids=["resnet18_basic", "resnet50_bottleneck"])
def test_small_model_matches_jax(spec):
    """A narrow model quantized by the JAX engine at 64x64 (as tests/test_ops.py
    does), carried over with from_jax_qmodel: same logits, same argmax."""

    class Cfg:
        batch_size = 8
        calibration_images = 16
        DEBUG_MODE = False
        image_size = (64, 64)
        compute_dtype = "float32"

    _, params, state = create_model(spec, num_classes=6)
    imgs = np.random.default_rng(7).integers(0, 256, (16, 64, 64, 3), dtype=np.uint8)
    eng = QuantizationEngine(Cfg(), spec, params, state, logging.getLogger("q"))
    qmodel, q_fn = eng.static_quantize((imgs, np.zeros(16, np.int32)))
    ref = np.asarray(q_fn(jnp.asarray(imgs)))
    model = tq.from_jax_qmodel(spec.to_dict(), jax.tree.map(np.asarray, qmodel), device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(imgs)).numpy()
        got_s2d = model(torch.from_numpy(space_to_depth_u8(imgs))).numpy()
    _assert_logits_match(got, ref)
    np.testing.assert_array_equal(got_s2d, got)


def test_grouped_convs_are_refused():
    spec = resnet_spec("resnext26_32x4d", num_classes=6)
    with pytest.raises(NotImplementedError):
        tq.from_jax_qmodel(spec.to_dict(), {}, device="cpu")


if __name__ == "__main__":
    logits = jax_artifact_logits(golden_images())
    np.savez(GOLDEN, logits=logits.astype(np.float32), seed=np.int64(GOLDEN_SEED),
             shape=np.asarray(GOLDEN_SHAPE, np.int64))
    print(f"wrote {GOLDEN}: logits {logits.shape}")
