"""The port's ViT (float forward with the fused mlp1 + GELU, and the static-INT8
executor on both activation carriers) against the JAX package, on the CPU.

The committed artifact (``inference_efficient_vision_models_tpu_torch/testdata/vit_tiny_int8/``)
is a 6-class ViT-Tiny/16 at full width and depth (dim 192, 12 blocks, 3
heads, MLP 768, 197 tokens), 224x224 raw uint8 input, converted by the JAX
package from the seeded float weights of ``chip_smoke.vit_params_from_seed``
(not trained; no accuracy is claimed). The goldens are the JAX package's
logits of 8 seeded random images on every route the GPU takes: the int8
executor on the fp32 carrier, on the bf16 carrier as the TPU runs it (the
int8-intermediate MLP pair, Pallas in ``interpret=True``) and as the CPU runs
it, and the float ``vit.apply(fused_mlp=True)`` in fp32 and bf16 with
``dense_gelu``'s Pallas kernel in ``interpret=True``. Running this file as a
script rewrites both: ``JAX_PLATFORMS=cpu python tests/test_torch_port_vit.py``.

Tolerances (``assert_logits_close``: |got - ref| <= tau * max|ref|, the same
argmax where the reference's top-2 margin exceeds twice that) are twice the
worst deviation measured here: int8 fp32 carrier 0.0194 (tiny model) ->
0.04; int8 bf16 carrier 0.0350 -> 0.07 (bf16 softmax and LayerNorm round at
other places in XLA and torch, and a value that moves across a requant edge
moves by a quantum); float bf16 0.0074 -> 0.015. The float fp32 forward
differs by 7.8e-7 of the scale (summation order only); its limit is 1e-5.
"""

import contextlib
import functools
import json
import os
import sys
import time
from unittest import mock

import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch
from flax import serialization

from chip_smoke import VIT_HEAD_STD, VIT_SEED, leaf_sums, vit_params_from_seed
from inference_efficient_vision_models_tpu.compress.quant import qvit as jqv
from inference_efficient_vision_models_tpu.compress.quant import stemfold as jsf
from inference_efficient_vision_models_tpu.data.pipeline import Batches
from inference_efficient_vision_models_tpu.data.pipeline import normalize_images as j_normalize
from inference_efficient_vision_models_tpu.data.synthetic import make_synthetic_neudet
from inference_efficient_vision_models_tpu.models import vit as jvit
from inference_efficient_vision_models_tpu.models.registry import spec_from_dict as j_spec
from inference_efficient_vision_models_tpu.ops import fused_dense as jfd
from inference_efficient_vision_models_tpu_torch.compress.quant import qvit as tqv
from inference_efficient_vision_models_tpu_torch.compress.quant import stemfold as tsf
from inference_efficient_vision_models_tpu_torch.core.artifacts import load_checkpoint_raw
from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images
from inference_efficient_vision_models_tpu_torch.models import vit as tvit
from inference_efficient_vision_models_tpu_torch.models.registry import spec_from_dict as t_spec
from inference_efficient_vision_models_tpu_torch.ops.im2col import conv_int8_im2col
from inference_efficient_vision_models_tpu_torch.serving import Predictor, load_quantized

try:
    from tests.test_torch_port_fused_dense import jax_dense_gelu_interpret
    from tests.test_torch_port_fused_mbconv import assert_logits_close
except ImportError:  # run as a script
    from test_torch_port_fused_dense import jax_dense_gelu_interpret
    from test_torch_port_fused_mbconv import assert_logits_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "inference_efficient_vision_models_tpu_torch", "testdata")
ARTIFACT = os.path.join(TESTDATA, "vit_tiny_int8")
GOLDEN = os.path.join(TESTDATA, "vit_tiny_jax_logits.npz")
GOLDEN_SEED, GOLDEN_SHAPE = 0, (8, 224, 224, 3)
CURRENT_IMAGES = 2  # images the "goldens are current" check recomputes
TAU = {"int8_f32": 0.04, "int8_bf16_cpu": 0.07, "int8_bf16_pair": 0.07,
       "float_f32": 1e-5, "float_bf16": 0.015}
ROUTES = tuple(TAU)


def golden_images() -> np.ndarray:
    return np.random.default_rng(GOLDEN_SEED).integers(0, 256, GOLDEN_SHAPE, dtype=np.uint8)


@contextlib.contextmanager
def jax_tpu_routes():
    """The JAX package's TPU routes on the CPU: the fused Pallas int8 dense and
    MLP pair (``_use_pallas_dense``) and the Pallas ``dense_gelu``, each
    kernel in ``interpret=True``. Nothing in the JAX package is edited."""
    with mock.patch.object(jqv, "_use_pallas_dense", lambda: True), \
            mock.patch.object(jqv, "int8_matmul_requant",
                              functools.partial(jqv.int8_matmul_requant, interpret=True)), \
            mock.patch.object(jfd, "dense_gelu", jax_dense_gelu_interpret):
        yield


def jax_logits(route: str, spec, q, params, imgs: np.ndarray) -> np.ndarray:
    """The JAX package's logits of raw uint8 ``imgs`` on one route."""
    x = jnp.asarray(imgs)
    if route == "int8_f32":
        return np.asarray(jqv.apply_int8(spec, jax.tree.map(jnp.asarray, q), x))
    if route == "int8_bf16_cpu":
        return np.asarray(jqv.apply_int8_bf16(spec, jax.tree.map(jnp.asarray, q), x))
    with jax_tpu_routes():
        if route == "int8_bf16_pair":
            return np.asarray(jqv.apply_int8_bf16(spec, jax.tree.map(jnp.asarray, q), x))
        dtype = jnp.float32 if route == "float_f32" else jnp.bfloat16
        out, _ = jvit.apply(spec, jax.tree.map(jnp.asarray, params), {}, j_normalize(x),
                            compute_dtype=dtype, fused_mlp=True)
        return np.asarray(out)


def port_logits(route: str, spec, qmodel_np, params_np, imgs: np.ndarray) -> np.ndarray:
    """The port's logits (CPU, plain versions) on one route; the pair route
    is forced onto the CPU, where the device would not choose it."""
    x = torch.from_numpy(imgs)
    with torch.inference_mode():
        if route.startswith("int8"):
            act = torch.float32 if route == "int8_f32" else torch.bfloat16
            model = tqv.from_jax_qmodel(spec.to_dict(), qmodel_np, "cpu", act)
            with mock.patch.object(tqv, "_use_pair_route", lambda t: route == "int8_bf16_pair"):
                return model(x).numpy()
        dtype = torch.float32 if route == "float_f32" else torch.bfloat16
        return tvit.apply(t_spec(spec.to_dict()), tvit.params_from_jax(params_np, "cpu"), {},
                          normalize_images(x), compute_dtype=dtype, fused_mlp=True)[0].numpy()


def quantized_jax_vit(spec, params, size: int):
    """fold -> minmax calibration on 32 surrogate images -> static int8 with
    the normalization folded into the u8 patch embed; numpy leaves."""
    imgs, labels = make_synthetic_neudet(8, image_size=size, seed=7)
    folded = jqv.fold(spec, params, {})
    obs = jqv.calibrate(spec, folded, Batches(imgs[:32], labels[:32], 8), max_images=32)
    q = jqv.convert_static_int8(spec, folded, obs, fold_input=True, image_size=(size, size))
    return jax.tree.map(np.asarray, q)


def _jax_artifact():
    with open(os.path.join(ARTIFACT, "spec.json")) as f:
        spec = j_spec(json.load(f))
    with open(os.path.join(ARTIFACT, "model_static_int8.msgpack"), "rb") as f:
        return spec, jqv.restore_derived(serialization.msgpack_restore(f.read()))


def _tiny_spec():
    return jvit.ViTSpec(name="vit_test", patch=8, dim=64, depth=2, heads=4, mlp_ratio=4.0,
                        num_classes=6, image_size=32)


@pytest.fixture(scope="module")
def tiny_int8():
    spec = _tiny_spec()
    params = vit_params_from_seed(spec, 3)
    return spec, params, quantized_jax_vit(spec, params, 32)


@pytest.fixture(scope="module")
def artifact():
    spec, q = _jax_artifact()
    return spec, q, vit_params_from_seed(spec, VIT_SEED)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


# --------------------------------------------------------------------------
# the float ViT
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float_vit_matches_jax(dtype, fused):
    """JAX ``init`` weights carried by ``params_from_jax``; with ``fused_mlp``
    the JAX side runs ``dense_gelu``'s Pallas kernel in interpret mode."""
    spec = _tiny_spec()
    params, _ = jvit.init(jax.random.PRNGKey(0), spec)
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    with jax_tpu_routes():
        ref, _ = jvit.apply(spec, params, {}, jnp.asarray(x), compute_dtype=getattr(jnp, dtype),
                            fused_mlp=fused)
    tp = tvit.params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    with torch.inference_mode():
        got, _ = tvit.apply(t_spec(spec.to_dict()), tp, {}, torch.from_numpy(x),
                            compute_dtype=getattr(torch, dtype), fused_mlp=fused)
    assert got.dtype == torch.float32 and got.shape == (3, 6)
    assert_logits_close(got.numpy(), np.asarray(ref),
                        TAU["float_f32" if dtype == "float32" else "float_bf16"])
    feats, _ = tvit.apply(t_spec(spec.to_dict()), tp, {}, torch.from_numpy(x),
                          return_features=True)
    assert feats.shape == (3, spec.dim)
    assert tvit.param_count(tp) == jvit.param_count(params)


def test_init_and_seeded_params_have_jax_layout():
    spec = _tiny_spec()
    ref, _ = jvit.init(jax.random.PRNGKey(0), spec)
    got, state = tvit.init(t_spec(spec.to_dict()), torch.Generator().manual_seed(0), device="cpu")
    assert state == {}
    seeded = vit_params_from_seed(spec, 0)
    paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    for tree in (got, seeded):
        flat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, tree, is_leaf=lambda v: isinstance(v, torch.Tensor)))[0]
        assert [p for p, _ in flat] == [p for p, _ in paths]
        assert [v.shape for _, v in flat] == [v.shape for _, v in paths]
    w = got["blocks"]["0"]["qkv"]["w"]
    assert float(w.abs().max()) <= 0.04 and 0.015 < float(w.std()) < 0.02
    assert float(np.std(seeded["head"]["w"])) > 0.8 * VIT_HEAD_STD


# --------------------------------------------------------------------------
# the static-INT8 executor
# --------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["int8_f32", "int8_bf16_cpu", "int8_bf16_pair"])
def test_int8_executor_matches_jax(tiny_int8, route):
    """A 32x32 ViT converted by the JAX package; the bf16 pair route is held
    against JAX's TPU route with the Pallas int8 kernel in interpret mode."""
    spec, params, q = tiny_int8
    imgs = np.random.default_rng(5).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    got = port_logits(route, spec, q, params, imgs)
    assert_logits_close(got, jax_logits(route, spec, q, params, imgs), TAU[route])


def test_u8_patch_embed_matches_jax(tiny_int8):
    """The VALID patch path (a reshape, no im2col) gives JAX's ``apply_u8_stem``
    output with ``act="none"`` and the (C,) offset vector, and the im2col
    path's integers."""
    spec, _, q = tiny_int8
    model = tqv.from_jax_qmodel(spec.to_dict(), q, "cpu")
    pe = model.q["patch_embed"]
    assert pe["e"].shape == (spec.dim,)
    x = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    got = tsf.apply_u8_stem(pe, torch.from_numpy(x), stride=8, pad=0, act="none")
    ref = jsf.apply_u8_stem(jax.tree.map(jnp.asarray, q["patch_embed"]), jnp.asarray(x),
                            stride=8, pad=0, act="none")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    x_s = (torch.from_numpy(x).to(torch.int16) - 128).to(torch.int8)
    im2col = conv_int8_im2col(x_s, pe["w"], pe["w_scale"], pe["bias"], pe["w_sum"], stride=8,
                              padding=0, in_scale=1.0, in_zp=128, backend="plain")
    np.testing.assert_array_equal(got.numpy(), (im2col + pe["e"]).numpy())


# --------------------------------------------------------------------------
# the committed artifact and its goldens
# --------------------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES)
def test_artifact_matches_jax_goldens(artifact, golden, route):
    spec, q, params = artifact
    got = port_logits(route, spec, q, params, golden_images())
    assert_logits_close(got, golden[route], TAU[route])


def test_golden_logits_are_current(artifact, golden):
    """The goldens are what the JAX package computes today from the committed
    msgpack and the seeded weights (first images; equal up to float summation
    order), and the seeded weights are the ones they were made from."""
    spec, q, params = artifact
    assert int(golden["seed"]) == GOLDEN_SEED and tuple(golden["shape"]) == GOLDEN_SHAPE
    assert int(golden["param_seed"]) == VIT_SEED
    np.testing.assert_array_equal(golden["param_sums"], leaf_sums(params))
    imgs = golden_images()[:CURRENT_IMAGES]
    for route in ROUTES:
        np.testing.assert_allclose(golden[route][:CURRENT_IMAGES],
                                   jax_logits(route, spec, q, params, imgs),
                                   rtol=1e-5, atol=1e-5, err_msg=route)


def test_artifact_reads_as_jax_does():
    """The pure-Python reader gives the JAX restore leaf for leaf; the spec
    round-trips; the VALID patch embed keeps its offset vector."""
    spec, qm = _jax_artifact()
    raw = load_checkpoint_raw(ARTIFACT, "static_int8")
    flat_t = jax.tree_util.tree_leaves_with_path(raw)
    flat_j = jax.tree_util.tree_leaves_with_path(jqv.serializable(qm))
    assert len(flat_t) == len(flat_j)
    for (pt, vt), (pj, vj) in zip(flat_t, flat_j):
        assert pt == pj
        np.testing.assert_array_equal(np.asarray(vt), np.asarray(vj))
    assert raw["patch_embed"]["e"].shape == (192,) and tqv.restore_derived(raw) is raw
    with open(os.path.join(ARTIFACT, "spec.json")) as f:
        d = json.load(f)
    assert t_spec(d).to_dict() == j_spec(d).to_dict()
    assert json.loads(json.dumps(t_spec(d).to_dict())) == d


@pytest.mark.parametrize("method", ["static_int8", "static_int8_bf16"])
def test_served_through_predictor(method):
    """load_quantized dispatches a ViT spec: raw uint8 in (no host
    preprocess), the carrier the method names, the model's own logits."""
    spec, model, fn, pre = load_quantized(ARTIFACT, method, device="cpu")
    assert isinstance(spec, tvit.ViTSpec) and pre is None
    assert model.act_dtype == (torch.bfloat16 if method.endswith("bf16") else torch.float32)
    pred = Predictor.from_artifact(ARTIFACT, method, device="cpu", batch_size=4,
                                   bucket_sizes=(1,))
    imgs = golden_images()[:5]
    got = pred.predict_logits(imgs)
    with torch.inference_mode():
        ref = model(torch.from_numpy(imgs)).numpy()
    assert got.shape == (5, 6)
    np.testing.assert_array_equal(got, ref)
    if method == "static_int8_bf16":
        with torch.inference_mode():
            alias = tqv.apply_int8_bf16(model.spec, model.q, torch.from_numpy(imgs))
        np.testing.assert_array_equal(alias.numpy(), ref)
    # the artifact holds no dynamic model file and no W4A16 one (a method
    # every family serves, from its own file)
    with pytest.raises(FileNotFoundError):
        load_quantized(ARTIFACT, "dynamic_int8", device="cpu")
    with pytest.raises(FileNotFoundError):
        load_quantized(ARTIFACT, "weight_only_int4", device="cpu")


@pytest.mark.parametrize("name", sorted(jvit._VIT_TABLE))
def test_spec_from_dict_matches_jax(name):
    ref = jvit.vit_spec(name, num_classes=6)
    got = tvit.vit_spec(name, num_classes=6)
    assert got.to_dict() == ref.to_dict()
    d = json.loads(json.dumps(ref.to_dict()))
    assert t_spec(d) == got and isinstance(t_spec(d), tvit.ViTSpec)
    d.pop("__kind__")
    assert t_spec(d) == got  # a "patch" key alone marks a ViT, as in the JAX registry
    assert (got.tokens, got.head_dim, got.block_heads(0), got.block_mlp_hidden(0)) == \
        (ref.tokens, ref.head_dim, ref.block_heads(0), ref.block_mlp_hidden(0))
    pruned = ref.with_widths(head_counts=[1] * ref.depth, mlp_hidden=[64] * ref.depth)
    assert t_spec(json.loads(json.dumps(pruned.to_dict()))).to_dict() == pruned.to_dict()


def _logit_stats(logits: np.ndarray) -> str:
    top2 = np.sort(logits, axis=1)[:, -2:]
    return (f"max|logit| {np.abs(logits).max():.4f}, top-2 margins "
            f"{np.round(top2[:, 1] - top2[:, 0], 4).tolist()}")


def write_artifact_and_goldens() -> None:
    """Make the committed artifact with the JAX package's own functions, then
    its golden logits on every route."""
    spec = jvit.vit_spec("vit_tiny_patch16_224", num_classes=6)
    params = vit_params_from_seed(spec, VIT_SEED)
    q = quantized_jax_vit(spec, params, 224)
    os.makedirs(ARTIFACT, exist_ok=True)
    with open(os.path.join(ARTIFACT, "spec.json"), "w") as f:
        json.dump(spec.to_dict(), f)
    with open(os.path.join(ARTIFACT, "model_static_int8.msgpack"), "wb") as f:
        f.write(serialization.msgpack_serialize(jqv.serializable(q)))
    with open(os.path.join(ARTIFACT, "provenance.json"), "w") as f:
        json.dump({
            "stage": "quantization",
            "spec_name": spec.name,
            "num_classes": spec.num_classes,
            "image_size": [224, 224],
            "methods": ["static_int8", "static_int8_bf16"],
            "weights": f"chip_smoke.vit_params_from_seed(spec, {VIT_SEED}): clip(N(0,1), -2, 2) "
                       f"* 0.02 for every weight and bias (LayerNorm scales 1 + that), head "
                       f"weight std {VIT_HEAD_STD} so the logits spread over a few units; not "
                       f"trained: this artifact checks shapes and numerics, and no accuracy "
                       f"is claimed for it",
            "calibration": "minmax observers on 32 surrogate images "
                           "(make_synthetic_neudet(8, 224, seed=7))",
            "conversion": "qvit.fold -> calibrate -> convert_static_int8(fold_input=True) "
                          "-> serializable",
            "made_by": "JAX_PLATFORMS=cpu python tests/test_torch_port_vit.py",
        }, f, indent=1)
    spec, qm = _jax_artifact()
    t0 = time.perf_counter()
    logits = {r: jax_logits(r, spec, qm, params, golden_images()).astype(np.float32)
              for r in ROUTES}
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED),
                        shape=np.asarray(GOLDEN_SHAPE, np.int64), param_seed=np.int64(VIT_SEED),
                        param_sums=leaf_sums(params), **logits)
    print(f"wrote {ARTIFACT} and {GOLDEN} in {time.perf_counter() - t0:.1f} s")
    for r, v in logits.items():
        print(f"  {r}: {_logit_stats(v)}")


if __name__ == "__main__":
    write_artifact_and_goldens()
