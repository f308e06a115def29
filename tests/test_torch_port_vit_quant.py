"""Stage 4 of the port on the ViT against the JAX package, on the CPU, on a
small ViT (dim 64, depth 2, 4 heads, patch 8, 32x32) with weights from
``chip_smoke.vit_params_from_seed``: the taps of ``apply_folded``, the
three calibration observers, the static and dynamic INT8 conversions, the
dynamic executor (kernel A's dynamic route by its plain version), the
engine's bf16-carrier executor, ``load_quantized`` of every method the port
serves for a ViT from artifacts the JAX package's engine made, and a
head-pruned ViT through the three int8 executors.

Limits: the taps within 1e-5 of each tap's magnitude (fp32 summation order;
the CPU measures ~1e-6); minmax ranges within ``CONVERT_LIMITS``' 1.075e-6
of their magnitude, percentile and entropy within one histogram bin, as the
CNN calibration tests hold them; every converted leaf EQUAL given the same
observers (numpy on both sides); the dynamic executor within 0.0065 of the
logit scale of JAX run op by op, twice the worst the CPU measures over 8
image seeds (3.2e-3 on one, under 1e-7 on the others: XLA and torch round
LayerNorm, softmax, the attention products and erfc at other places, and
one activation within that rounding of an edge of the per-batch quantize
moves one quantum); the static executors within the limits of
tests/test_torch_port_vit.py (fp32 carrier 0.04, bf16 carrier 0.07 of the
scale); the float methods through the loaders within ``LOAD_TAU``, twice
what the CPU measures (the JAX loader folds the normalization into an s2d
float patch embed, the port normalizes first: the same function rounded
elsewhere).

Running this file as a script writes the goldens ``chip_smoke.py`` holds
the card to, with the JAX package run op by op (``jax.disable_jit()``):
``testdata/vit_tiny_convert_jax.json`` (a seeded full-width ViT-Tiny/16
calibrated on 48 surrogate 224x224 images and converted) and
``testdata/vit_tiny_dynamic_jax_logits.npz`` (its dynamic INT8 logits on 8
seeded images), then prints the record's own fp32 error against an fp64
calibration and the port's CPU deviation from both over 1-8 torch threads
(~5 min): ``JAX_PLATFORMS=cpu python tests/test_torch_port_vit_quant.py``
(``--seed N --out DIR``: another weight seed's record, for
``calib_spread.py --vit``)."""

import json
import logging
import os
import sys
import types

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from chip_smoke import (CONVERT_LIMITS, _vit_tap_of, compare_conversion, conversion_record,
                        flat_raw, vit_params_from_seed)
from inference_efficient_vision_models_tpu.compress.prune import vit_engine as jve
from inference_efficient_vision_models_tpu.compress.quant import engine as jeng
from inference_efficient_vision_models_tpu.compress.quant import qvit as jqv
from inference_efficient_vision_models_tpu.data.pipeline import Batches as JBatches
from inference_efficient_vision_models_tpu.data.pipeline import normalize_images as j_norm
from inference_efficient_vision_models_tpu.data.synthetic import make_synthetic_neudet
from inference_efficient_vision_models_tpu.models import vit as jvit
from inference_efficient_vision_models_tpu.serving import load_quantized as j_load
from inference_efficient_vision_models_tpu_torch.compress.quant import engine as teng
from inference_efficient_vision_models_tpu_torch.compress.quant import qvit as tqv
from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches as TBatches
from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images
from inference_efficient_vision_models_tpu_torch.models.registry import spec_from_dict as t_spec
from inference_efficient_vision_models_tpu_torch.ops import int8_matmul as tim
from inference_efficient_vision_models_tpu_torch.serving import load_quantized

try:
    from tests.test_torch_port_fused_mbconv import assert_logits_close
    from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
except ImportError:  # run as a script
    from test_torch_port_fused_mbconv import assert_logits_close
    from test_torch_port_prune import one_thread  # noqa: F401

SIZE = 32
TAP_RTOL, DYN_TAU = 1e-5, 0.0065
STATIC_TAU = {"static_int8": 0.04, "static_int8_bf16": 0.07}
# the CPU measures fp16 1.34e-3, bf16 0.0127, W8A16 8.9e-3, W4A16 1.03e-2, fp32 6.9e-7 (fp32
# keeps the 1e-5 of the other fp32 limits), dynamic 3.0e-7 (its own DYN_TAU)
LOAD_TAU = {"dynamic_int8": DYN_TAU, "fp32": 1e-5, "fp16": 0.0027, "bf16": 0.026,
            "weight_only_int8": 0.018, "weight_only_int4": 0.021}
METHODS = ("static_int8", "static_int8_bf16", "dynamic_int8", "fp16", "bf16", "weight_only_int8")


def small_spec(heads=4):
    return jvit.ViTSpec(name="vit_test", patch=8, dim=64, depth=2, heads=heads, mlp_ratio=4.0,
                        num_classes=6, image_size=SIZE)


class Cfg:
    batch_size = 8
    calibration_images = 32
    DEBUG_MODE = False
    image_size = (SIZE, SIZE)
    compute_dtype = "float32"
    observer = "minmax"
    percentile = 99.99


@pytest.fixture(scope="module")
def model():
    spec = small_spec()
    tspec = t_spec(spec.to_dict())
    p = vit_params_from_seed(spec, 3)
    imgs, labels = make_synthetic_neudet(8, image_size=SIZE, seed=7)
    jf = jax.device_get(jqv.fold(spec, p, {}))
    tf = tqv.fold(tspec, p, {})
    jobs = jqv.calibrate(spec, jf, JBatches(imgs[:32], labels[:32], 8), max_images=32)
    jq = jax.device_get(jax.tree.map(jnp.asarray, jqv.convert_static_int8(
        spec, jf, jobs, image_size=(SIZE, SIZE))))
    tq = tqv.convert_static_int8(tspec, tf, jobs, image_size=(SIZE, SIZE))
    x = np.random.default_rng(5).integers(0, 256, (6, SIZE, SIZE, 3), dtype=np.uint8)
    return dict(spec=spec, tspec=tspec, p=p, imgs=imgs, labels=labels, jf=jf, tf=tf,
                jobs=jobs, jq=jq, tq=tq, x=x)


def test_taps_match_jax(model):
    spec, tspec, x = model["spec"], model["tspec"], model["x"]
    ref_logits, ref = jqv.apply_folded(spec, model["jf"], j_norm(jnp.asarray(x)),
                                       with_taps=True)
    with torch.no_grad():
        logits, got = tqv.apply_folded(tspec, tqv.place_folded(model["tf"], "cpu"),
                                       normalize_images(torch.from_numpy(x)), with_taps=True)
        plain = tqv.apply_folded(tspec, tqv.place_folded(model["tf"], "cpu"),
                                 normalize_images(torch.from_numpy(x)))
        feats = tqv.apply_folded(tspec, tqv.place_folded(model["tf"], "cpu"),
                                 normalize_images(torch.from_numpy(x)), return_features=True)
    assert list(got) == list(ref) == ["input"] + [f"b{i}{n}" for i in range(2) for n in
                                                  ("qkv", "proj", "mlp1", "mlp2")] + ["head"]
    for k in ref:
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape, k
        assert np.abs(got[k].numpy() - r).max() <= TAP_RTOL * np.abs(r).max(), k
    assert_logits_close(logits.numpy(), np.asarray(ref_logits), TAP_RTOL)
    assert_logits_close(plain.numpy(), np.asarray(ref_logits), TAP_RTOL)
    np.testing.assert_allclose(feats.numpy(), got["head"].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("observer", ["minmax", "percentile", "entropy"])
def test_calibrate_matches_jax(model, observer):
    spec, tspec, imgs, labels = model["spec"], model["tspec"], model["imgs"], model["labels"]
    ref = jqv.calibrate(spec, model["jf"], JBatches(imgs[:24], labels[:24], 8), max_images=20,
                        observer=observer)
    got = tqv.calibrate(tspec, tqv.place_folded(model["tf"], "cpu"),
                        TBatches(imgs[:24], labels[:24], 8, "cpu"), max_images=20,
                        observer=observer)
    assert got.keys() == ref.keys()
    for name in ref:
        r, g = ref[name], got[name]
        if observer == "minmax":
            tol = CONVERT_LIMITS["scale_rtol"] * max(abs(r.min), abs(r.max), 1e-30)
        else:
            tol = (max(r.max, 0.0) - min(r.min, 0.0)) / 2048 * 1.0001 + 1e-6
        assert abs(g.min - r.min) <= tol and abs(g.max - r.max) <= tol, (name, r, g)


def test_static_conversion_equals_jax(model):
    """Every leaf equal, dtypes included (w_sum int32 as JAX's device arrays
    store it), the serializable tree is the tree; the port's own observers
    give a conversion within the minmax limit of JAX's record."""
    fj, ft = flat_raw(model["jq"]), flat_raw(model["tq"])
    assert fj.keys() == ft.keys()
    for k in fj:
        assert ft[k].dtype == fj[k].dtype, k
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    assert tqv.serializable(model["tq"]) is model["tq"] and "e" in model["tq"]["patch_embed"]
    imgs, labels = model["imgs"], model["labels"]
    tobs = tqv.calibrate(model["tspec"], tqv.place_folded(model["tf"], "cpu"),
                         TBatches(imgs[:32], labels[:32], 8, "cpu"), max_images=32)
    mine = tqv.convert_static_int8(model["tspec"], model["tf"], tobs, image_size=(SIZE, SIZE))
    report = compare_conversion(mine, conversion_record(model["jq"], model["jobs"]),
                                CONVERT_LIMITS, _vit_tap_of)
    assert report["ok"], report


def test_dynamic_conversion_and_executor_match_jax(model):
    spec, tspec, x = model["spec"], model["tspec"], model["x"]
    jd = jax.device_get(jax.tree.map(jnp.asarray, jqv.convert_dynamic_int8(spec, model["jf"])))
    td = tqv.convert_dynamic_int8(tspec, model["tf"])
    fj, ft = flat_raw(jd), flat_raw(td)
    assert fj.keys() == ft.keys()
    for k in fj:
        assert ft[k].dtype == fj[k].dtype, k
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    with jax.disable_jit():
        ref = np.asarray(jqv.apply_dynamic_int8(spec, jax.tree.map(jnp.asarray, jd),
                                                j_norm(jnp.asarray(x))))
    m = tqv.from_dynamic_qmodel(tspec, td, "cpu")
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
        plain = m(torch.from_numpy(x), impl="plain").numpy()
    np.testing.assert_array_equal(got, plain)  # a CPU tensor takes the plain version
    assert_logits_close(got, ref, DYN_TAU)


def test_dynamic_route_plain_equals_static_plain_and_jax_qparams():
    """The dynamic plain route from its device buffer equals the static plain
    version given those qparams as host scalars; the buffer holds the
    qparams JAX's ``_dyn_dense`` finds (fp32), 1 / s in double."""
    rng = np.random.default_rng(0)
    for m, k, n, lo, hi in [(37, 50, 13, -3.0, 5.0), (8, 192, 6, 0.5, 9.0), (5, 7, 3, -2.0, -1.0),
                            (4, 16, 8, 0.0, 0.0)]:
        x = torch.from_numpy(rng.uniform(lo, hi, (m, k)).astype(np.float32))
        w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
        ws = torch.from_numpy(rng.uniform(0.001, 0.01, n).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        wsum = w.to(torch.int32).sum(0, dtype=torch.int32)
        qp = tim.dynamic_qparams(x)
        assert qp.dtype == torch.float64 and qp.shape == (4,)
        x2 = jnp.asarray(x.numpy())
        lo_j = jnp.minimum(jnp.min(x2), 0.0)
        s = jnp.maximum((jnp.maximum(jnp.max(x2), 0.0) - lo_j) / 255.0, 1.2e-7)
        zp = int(jnp.clip(jnp.round(-lo_j / s), 0, 255))
        assert float(qp[1]) == float(s) and int(qp[2]) == zp - 128
        assert float(qp[0]) == 1.0 / float(np.float32(s))
        for act in (None, "gelu"):
            got = tim.int8_matmul_requant_dynamic_plain(x, w, ws, b, wsum, qp, act=act)
            ref = tim.int8_matmul_requant_plain(x, w, ws, b, wsum, in_scale=float(s),
                                                in_zp=zp, act=act)
            assert torch.equal(got, ref)
            assert torch.equal(tim.int8_matmul_requant_dynamic(x, w, ws, b, wsum, qp, act=act),
                               got)
    with pytest.raises(ValueError, match="float64"):
        tim.int8_matmul_requant_dynamic_plain(x, w, ws, b, wsum, qp.float())


def test_cnn_dynamic_fc_is_the_float64_formula_bit_for_bit():
    """The CNN families' dynamic fc on kernel A's dynamic route (by its plain
    version here) equals the float64 formula it replaced, bit for bit."""
    from chip_smoke import dynamic_fc_float64

    rng = np.random.default_rng(1)
    for m, k in [(8, 512), (3, 2048), (32, 1280)]:
        feats = torch.from_numpy(np.abs(rng.standard_normal((m, k))).astype(np.float32) * 2)
        w = rng.standard_normal((k, 6)).astype(np.float32) * 0.05
        from inference_efficient_vision_models_tpu_torch.compress.quant.observers import (
            quantize_weight_per_channel)

        w_q, w_scale = quantize_weight_per_channel(w, channel_axis=1)
        fcq = {"w_q": torch.from_numpy(w_q), "w_scale": torch.from_numpy(w_scale),
               "w_sum": torch.from_numpy(w_q.sum(axis=0, dtype=np.int32)),
               "bias": torch.from_numpy(rng.standard_normal(6).astype(np.float32))}
        got = teng._dynamic_fc(feats, {**fcq, "w": tim.pack_weight(fcq["w_q"])})
        assert torch.equal(got, dynamic_fc_float64(feats, fcq))


def test_mlp_fuse_switch(monkeypatch):
    cuda_like = types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"))
    assert tqv._use_pair_route(cuda_like)
    monkeypatch.setenv("IEVM_VIT_MLP_FUSE", "0")
    assert not tqv._use_pair_route(cuda_like)
    assert not tqv._use_pair_route(torch.zeros(1))


def test_engine_static_executors(model):
    """``static_quantize`` with ``executor="bf16"``: the same conversion, the
    bf16 carrier; both executors against the JAX engine's."""
    spec, tspec, x = model["spec"], model["tspec"], model["x"]
    calib = (model["imgs"][:32], model["labels"][:32])
    eng = teng.QuantizationEngine(Cfg(), tspec, tqv.place_folded(model["p"], "cpu"), {},
                                  logging.getLogger("q"), device="cpu")
    assert eng.q is tqv
    jeng_ = jeng.QuantizationEngine(Cfg(), spec, model["p"], {}, logging.getLogger("q"))
    q32, m32 = eng.static_quantize(calib)
    q16, m16 = eng.static_quantize(calib, executor="bf16")
    assert m32.act_dtype == torch.float32 and m16.act_dtype == torch.bfloat16
    for k, v in flat_raw(q32).items():
        np.testing.assert_array_equal(flat_raw(q16)[k], v)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        np.testing.assert_array_equal(m16(xt).numpy(),
                                      tqv.apply_int8_bf16(tspec, m32.q, xt).numpy())
        for method, m, ex in (("static_int8", m32, "int8"), ("static_int8_bf16", m16, "bf16")):
            ref = np.asarray(jeng_.static_quantize(calib, executor=ex)[1](jnp.asarray(x)))
            assert_logits_close(m(xt).numpy(), ref, STATIC_TAU[method])
    with pytest.raises(NotImplementedError, match="bf16 carrier"):
        eng.static_quantize(calib, executor="mixed")


def test_load_quantized_every_method_matches_jax(model, tmp_path):
    """Artifacts the JAX package's engine makes and writes, restored by the
    port's ``load_quantized`` and the JAX one: the same logits within each
    method's limit; raw uint8 in, no host preprocess."""
    spec, x = model["spec"], model["x"]
    calib = (model["imgs"][:32], model["labels"][:32])
    eng = jeng.QuantizationEngine(Cfg(), spec, model["p"], {}, logging.getLogger("q"))
    made = {"static_int8": lambda: eng.static_quantize(calib),
            "dynamic_int8": eng.dynamic_quantize,
            "fp16": lambda: eng.cast_half(jnp.float16),
            "bf16": lambda: eng.cast_half(jnp.bfloat16),
            "weight_only_int8": eng.weight_only_quantize,
            "weight_only_int4": lambda: eng.weight_only_quantize(bits=4),
            "fp32": lambda: (eng.folded, None)}
    d = str(tmp_path)
    for method, fn in made.items():
        qm = fn()[0]
        with open(os.path.join(d, f"model_{method}.msgpack"), "wb") as f:
            f.write(serialization.to_bytes(jqv.serializable(jax.device_get(qm))))
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec.to_dict(), f)
    for method in METHODS + ("fp32",):
        _, _, j_fn, j_pre = j_load(d, method)
        ref = np.asarray(j_fn(jnp.asarray(x)), np.float32)
        tspec, _, fn, pre = load_quantized(d, method, device="cpu")
        assert pre is None and j_pre is None and tspec == model["tspec"], method
        with torch.inference_mode():
            got = fn(torch.from_numpy(x)).float().numpy()
        assert_logits_close(got, ref, {**STATIC_TAU, **LOAD_TAU}[method])
    # W4A16, served since it was ported: the JAX loader's logits, and the
    # port's own dequantized tree through apply_folded
    _, _, j_fn, _ = j_load(d, "weight_only_int4")
    ref = np.asarray(j_fn(jnp.asarray(x)), np.float32)
    _, model_w4, fn, pre = load_quantized(d, "weight_only_int4", device="cpu")
    with torch.inference_mode():
        got = fn(torch.from_numpy(x)).float().numpy()
    assert pre is None and "q4" in model_w4["blocks"]["0"]["qkv"]["w"]
    assert_logits_close(got, ref, LOAD_TAU["weight_only_int4"])


def test_head_pruned_vit_on_the_three_int8_executors(model):
    """Heads pruned to 2 of 4 per block (qkv N 96, proj K 32): the executors
    read the head count from the weights. Static fp32 and bf16 carriers and
    the dynamic executor against JAX's."""
    spec, tspec, p = model["spec"], model["tspec"], model["p"]
    keep = {("heads", i): np.array([1, 3]) for i in range(spec.depth)}
    jspec, jp = jve.apply_vit_pruning(spec, p, keep)
    pspec = t_spec(jspec.to_dict())
    assert pspec.head_counts == (2, 2)
    imgs, labels, x = model["imgs"], model["labels"], model["x"]
    jf = jax.device_get(jqv.fold(jspec, jp, {}))
    jobs = jqv.calibrate(jspec, jf, JBatches(imgs[:32], labels[:32], 8), max_images=32)
    q = jax.tree.map(np.asarray, jqv.convert_static_int8(jspec, jf, jobs,
                                                         image_size=(SIZE, SIZE)))
    assert q["blocks"]["0"]["qkv"]["w_q"].shape == (64, 96)
    assert q["blocks"]["0"]["proj"]["w_q"].shape == (32, 64)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        for act, route in ((torch.float32, "static_int8"), (torch.bfloat16, "static_int8_bf16")):
            m = tqv.from_jax_qmodel(pspec.to_dict(), q, "cpu", act)
            apply = jqv.apply_int8 if act == torch.float32 else jqv.apply_int8_bf16
            ref = np.asarray(apply(jspec, jax.tree.map(jnp.asarray, q), jnp.asarray(x)))
            assert_logits_close(m(xt).numpy(), ref, STATIC_TAU[route])
        jd = jqv.convert_dynamic_int8(jspec, jf)
        with jax.disable_jit():
            ref = np.asarray(jqv.apply_dynamic_int8(jspec, jax.tree.map(jnp.asarray, jd),
                                                    j_norm(jnp.asarray(x))))
        got = tqv.from_dynamic_qmodel(pspec, tqv.convert_dynamic_int8(pspec, tqv.fold(
            pspec, jp, {})), "cpu")(xt).numpy()
    assert_logits_close(got, ref, DYN_TAU)


def test_convert_and_dynamic_goldens_are_current():
    """The committed record and logits were made from the weights and images
    that ``chip_smoke`` draws today."""
    from chip_smoke import (VIT_CONVERT, VIT_CONVERT_GOLDEN, VIT_DYN_GOLDEN, leaf_sums,
                            vit_convert_inputs, vit_dyn_images)

    with open(VIT_CONVERT_GOLDEN) as f:
        rec = json.load(f)
    spec, p, _, imgs, _ = vit_convert_inputs(VIT_CONVERT)
    assert rec["provenance"]["config"] == VIT_CONVERT
    assert rec["provenance"]["param_sums"] == leaf_sums(p).tolist()
    assert rec["provenance"]["image_sum"] == int(imgs.sum(dtype=np.int64))
    assert len(rec["qparams"]) == 2 + 2 * (4 * spec.depth + 1) + 2  # input, denses, stem out
    g = np.load(VIT_DYN_GOLDEN)
    assert int(g["image_sum"]) == int(vit_dyn_images().sum(dtype=np.int64))
    np.testing.assert_array_equal(g["param_sums"], leaf_sums(p))
    assert g["logits"].shape == (8, 6)


def write_goldens(seed=None, out_dir=None) -> None:
    """The JAX package's CPU run of ``VIT_CONVERT``, op by op: fold, minmax
    calibration, static conversion and its record; the dynamic conversion's
    logits on ``vit_dyn_images``; then the record's fp32 error against an
    fp64 calibration and the port's CPU deviation from both over 1-8 torch
    threads, the source of ``VIT_CONVERT_LIMITS`` and ``VIT_DYN_TAU``. With
    ``seed`` and ``out_dir``: the record of another weight seed, written to
    ``out_dir`` (no logits), for ``calib_spread.py``."""
    import time

    from chip_smoke import (VIT_CONVERT, VIT_CONVERT_GOLDEN, VIT_DYN_GOLDEN, leaf_sums,
                            port_convert_effnet, vit_convert_inputs, vit_dyn_images)
    from inference_efficient_vision_models_tpu_torch.compress.quant import calib

    t0 = time.time()
    cfg = VIT_CONVERT if seed is None else dict(VIT_CONVERT, seed=seed)
    rec_path, made_by = VIT_CONVERT_GOLDEN, "JAX_PLATFORMS=cpu python tests/test_torch_port_vit_quant.py"
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        rec_path = os.path.join(out_dir, os.path.basename(VIT_CONVERT_GOLDEN))
        made_by += f" --seed {cfg['seed']} --out {out_dir}"
    spec, p, _, imgs, labels = vit_convert_inputs(cfg)
    jspec = jvit.vit_spec("vit_tiny_patch16_224", 6, image_size=cfg["size"])
    b = cfg["batch"]
    with jax.disable_jit():
        jf = jqv.fold(jspec, p, {})
        obs = jqv.calibrate(jspec, jf, JBatches(imgs, labels, b), max_images=len(imgs))
        q = jax.device_get(jax.tree.map(jnp.asarray, jqv.convert_static_int8(
            jspec, jf, obs, image_size=(cfg["size"], cfg["size"]))))
    rec = conversion_record(jqv.serializable(q), obs)
    rec["provenance"] = {
        "made_by": made_by, "jax": jax.__version__, "config": cfg, "observer": "minmax",
        "op_by_op": True, "param_sums": leaf_sums(p).tolist(),
        "image_sum": int(imgs.sum(dtype=np.int64)),
        "weights": "chip_smoke.vit_params_from_seed(vit_tiny_patch16_224, seed)",
    }
    with open(rec_path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    print(f"wrote {rec_path} ({time.time() - t0:.0f} s)")
    x = vit_dyn_images()
    dyn = None
    if out_dir is None:
        jd = jax.tree.map(jnp.asarray, jqv.convert_dynamic_int8(jspec, jf))
        with jax.disable_jit():
            dyn = np.asarray(jqv.apply_dynamic_int8(jspec, jd, j_norm(jnp.asarray(x))),
                             np.float32)
        np.savez_compressed(VIT_DYN_GOLDEN, logits=dyn, param_sums=leaf_sums(p),
                            image_sum=np.int64(x.sum(dtype=np.int64)))
        print(f"wrote {VIT_DYN_GOLDEN} ({time.time() - t0:.0f} s); logit scale "
              f"{float(np.abs(dyn).max())}")
    # the record's own fp32 error: an fp64 calibration of the same images
    norm = calib.normalize_images
    calib.normalize_images = lambda t: norm(t).double()
    f64 = tqv.calibrate(spec, tqv.place_folded(tqv.fold(spec, p, {}), "cpu", torch.float64),
                        TBatches(imgs, labels, b, "cpu"), max_images=len(imgs))
    calib.normalize_images = norm
    q64 = tqv.convert_static_int8(spec, tqv.fold(spec, p, {}), f64,
                                  image_size=(cfg["size"], cfg["size"]))
    r64 = compare_conversion(q64, rec, {"scale_rtol": 0.0}, _vit_tap_of)
    print(f"the record's fp32 scales against an fp64 calibration: {r64['max_scale_rel']} "
          f"({r64['worst_scale']})")
    dq = tqv.convert_dynamic_int8(spec, tqv.fold(spec, p, {}))
    for threads in (1, 2, 4, 8):  # the summation order moves with the thread count
        torch.set_num_threads(threads)
        tq, _, _ = port_convert_effnet(spec, p, {}, imgs, labels, "cpu", cfg)
        report = compare_conversion(tq, rec, {"scale_rtol": 0.0}, _vit_tap_of)
        dev = None
        if dyn is not None:
            with torch.inference_mode():
                got = tqv.from_dynamic_qmodel(spec, dq, "cpu")(torch.from_numpy(x)).numpy()
            dev = float(np.abs(got - dyn).max() / np.abs(dyn).max())
        print(f"{threads} threads: scales {report['max_scale_rel']} ({report['worst_scale']}), "
              f"leaves unequal {report['leaves_unequal']}, zero points {report['zp_bad']}, "
              f"dynamic logits over scale {dev} ({time.time() - t0:.0f} s)")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=write_goldens.__doc__)
    ap.add_argument("--seed", type=int, default=None, help="weight seed of another record")
    ap.add_argument("--out", default=None, help="its directory (with --seed)")
    a = ap.parse_args()
    if (a.seed is None) != (a.out is None):
        ap.error("--seed and --out go together")
    write_goldens(a.seed, a.out)
