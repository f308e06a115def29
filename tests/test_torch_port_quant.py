"""Stage 4 of the port (fold, calibrate, convert, the float-compute methods)
against the JAX package, on the CPU at a small size: ResNet18's topology at
widths 16/32/64/128, weights from a numpy seed, 64x64 images.

Folding, weight quantization and the conversion are numpy on the host on
both sides, so the folded leaves and the integer leaves are held EQUAL. The
activation ranges come from each package's own fp32 forward (oneDNN here,
XLA there), so scales are held within ``SCALE_RTOL`` and zero points equal
or one apart where the reference sits on a rounding edge.

Running this file as a script converts the committed pruned r2 checkpoint
with the JAX package on the CPU (minmax observer, the first 256 images of
fold 0's train split, batch 32), writes its qparams and per-leaf hashes to
``testdata/r2_convert_jax.json`` (the reference of ``chip_smoke.py``'s
``convert_r2`` phase), and prints the port's CPU deviation from it:
``JAX_PLATFORMS=cpu python tests/test_torch_port_quant.py``.
"""

import json
import logging
import os
import sys
import tempfile

import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch

from chip_smoke import (
    CONVERT_GOLDEN,
    CONVERT_LIMITS,
    compare_conversion,
    conversion_record,
    resnet_params_from_seed,
)
from inference_efficient_vision_models_tpu.compress.quant import qresnet as jq
from inference_efficient_vision_models_tpu.compress.quant.engine import (
    QuantizationEngine as JEngine,
)
from inference_efficient_vision_models_tpu.core.config import QuantConfig as JQuantConfig
from inference_efficient_vision_models_tpu.data.pipeline import Batches as JBatches
from inference_efficient_vision_models_tpu.data.pipeline import normalize_images as j_norm
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu_torch.compress.quant import calib as tcalib
from inference_efficient_vision_models_tpu_torch.compress.quant import qresnet as tq
from inference_efficient_vision_models_tpu_torch.compress.quant.engine import QuantizationEngine
from inference_efficient_vision_models_tpu_torch.core.config import QuantConfig
from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches, normalize_images
from inference_efficient_vision_models_tpu_torch.models import registry as treg
from inference_efficient_vision_models_tpu_torch.models import resnet as tr

try:
    from tests.test_torch_port_prune import narrow_r18_dict, one_thread  # noqa: F401
    from tests.test_torch_port_resnet_float import flat
except ImportError:
    from test_torch_port_prune import narrow_r18_dict, one_thread  # noqa: F401
    from test_torch_port_resnet_float import flat

LOG = logging.getLogger("test_torch_port_quant")
SPEC_D = narrow_r18_dict()
SIZE = 64
# the folded fp32 forward, port (oneDNN) vs JAX (XLA): every tap and the
# logits within TAP_TOL of their largest magnitude (summation order only;
# the CPU measures 4.8e-7)
TAP_TOL = 1e-5
# float-compute methods, logits within TOL of the JAX logits' largest
# magnitude. dynamic_int8 has an fp32 trunk and an exact int8 head: TAP_TOL
# (the CPU measures 8.2e-8). The half-precision methods: twice the CPU's
# deviation (fp16 1.57e-3, bf16 7.9e-3, W8A16 in bf16 1.54e-2): the convs
# round their fp16/bf16 outputs at other places than XLA's
METHOD_TOL = {"dynamic_int8": TAP_TOL, "fp16": 3.2e-3, "bf16": 0.016, "weight_only_int8": 0.031}


def model():
    spec = jreg.spec_from_dict(SPEC_D)
    p, s = resnet_params_from_seed(spec, 1)
    return spec, treg.spec_from_dict(SPEC_D), p, s


def images(n: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def folded():
    spec, tspec, p, s = model()
    jf = jax.device_get(jq.fold(spec, p, s))
    tf = tq.fold(tspec, p, s)
    return spec, tspec, jf, tf


def test_fold_conv_bn_equal(folded):
    _, _, jf, tf = folded
    fj, ft = flat(jf), flat(tf)
    assert fj.keys() == ft.keys()
    for k in fj:
        assert ft[k].dtype == fj[k].dtype and np.array_equal(ft[k], fj[k]), k


def test_apply_folded_logits_and_taps(folded):
    spec, tspec, jf, tf = folded
    x = images(4)
    ref, ref_taps = jq.apply_folded(spec, jf, j_norm(jnp.asarray(x)), with_taps=True)
    with torch.no_grad():
        got, taps = tq.apply_folded(tspec, tq.place_folded(tf, "cpu"),
                                    normalize_images(torch.from_numpy(x)), with_taps=True)
    assert taps.keys() == ref_taps.keys()
    for name, t in [("logits", got), *taps.items()]:
        r = np.asarray(ref if name == "logits" else ref_taps[name])
        assert t.shape == r.shape, name
        err = np.abs(t.numpy() - r).max() / np.abs(r).max()
        assert err <= TAP_TOL, (name, err)
    # return_features stops before the fc
    with torch.no_grad():
        feats = tq.apply_folded(tspec, tq.place_folded(tf, "cpu"),
                                normalize_images(torch.from_numpy(x)), return_features=True)
    np.testing.assert_array_equal(feats.numpy(), taps["feat"].numpy())


def calibrations(folded, observer):
    spec, tspec, jf, tf = folded
    imgs, labels = images(24, seed=4), np.arange(24) % 6
    ref = jq.calibrate(spec, jf, JBatches(imgs, labels, 8), max_images=20, observer=observer)
    got = tq.calibrate(tspec, tq.place_folded(tf, "cpu"), Batches(imgs, labels, 8, "cpu"),
                       max_images=20, observer=observer)
    return ref, got


@pytest.mark.parametrize("observer", ["minmax", "percentile", "entropy"])
def test_calibrate_taps_matches_jax(folded, observer):
    """minmax: each range within ``CONVERT_LIMITS['scale_rtol']`` of JAX's
    (relative); percentile and entropy: within one histogram bin of the
    tap's global range."""
    ref, got = calibrations(folded, observer)
    assert got.keys() == ref.keys()
    for name in ref:
        r, g = ref[name], got[name]
        if observer == "minmax":
            scale = max(abs(r.min), abs(r.max), 1e-30)
            tol = CONVERT_LIMITS["scale_rtol"] * scale
        else:
            tol = (max(r.max, 0.0) - min(r.min, 0.0)) / 2048 * 1.0001 + 1e-6
        assert abs(g.min - r.min) <= tol and abs(g.max - r.max) <= tol, (name, r, g)


def test_histogram_helpers_match_jax():
    from inference_efficient_vision_models_tpu.compress.quant import calib as jcalib

    rng = np.random.default_rng(0)
    h = np.histogram(np.concatenate([rng.standard_normal(20000), rng.exponential(8, 300)]),
                     bins=2048)[0]
    for fn in ("percentile_range", "entropy_range"):
        assert getattr(tcalib, fn)(h, -4.0, 40.0) == getattr(jcalib, fn)(h, -4.0, 40.0)


@pytest.fixture(scope="module")
def conversions(folded):
    spec, tspec, jf, tf = folded
    ref_obs, got_obs = calibrations(folded, "minmax")
    ref = jax.device_get(jax.tree.map(jnp.asarray, jq.convert_static_int8(
        spec, jf, ref_obs, image_size=(SIZE, SIZE))))
    got = tq.convert_static_int8(tspec, tf, got_obs, image_size=(SIZE, SIZE))
    return ref, got, ref_obs


def test_convert_static_int8_leaf_for_leaf(conversions):
    ref, got, ref_obs = conversions
    report = compare_conversion(tq.serializable(got), conversion_record(tq.serializable(ref), ref_obs))
    assert report["ok"], report


def test_int8_of_port_conversion_vs_jax_lax(conversions):
    """The port-converted model through the plain int8 path against the JAX
    package's ``apply_int8(impl="lax")`` on its own conversion: argmax
    equal, logits within rtol/atol 0.02 (the serving limit)."""
    ref_q, got_q, _ = conversions
    spec = jreg.spec_from_dict(SPEC_D)
    x = images(8, seed=9)
    ref = np.asarray(jq.apply_int8(spec, ref_q, jnp.asarray(x)))
    got = tq.from_jax_qmodel(SPEC_D, got_q, "cpu")(torch.from_numpy(x), impl="plain").numpy()
    np.testing.assert_allclose(got, ref, rtol=0.02, atol=0.02)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    spec, tspec, p, s = model()
    root = tmp_path_factory.mktemp("quant")
    kw = dict(batch_size=8, image_size=(SIZE, SIZE), calibration_images=16)
    j = JEngine(JQuantConfig(artifacts_root=str(root / "j"), **kw), spec, p, s, LOG)
    t = QuantizationEngine(QuantConfig(artifacts_root=str(root / "t"), **kw), tspec,
                           tr.params_from_jax(p, "cpu"), tr.params_from_jax(s, "cpu"), LOG, "cpu")
    return j, t


@pytest.mark.parametrize("method", sorted(METHOD_TOL))
def test_float_methods_match_jax(engines, method):
    j, t = engines
    jdt = {"fp16": jnp.float16, "bf16": jnp.bfloat16}
    tdt = {"fp16": torch.float16, "bf16": torch.bfloat16}
    if method in jdt:
        (j_model, j_fn), (t_model, t_fn) = j.cast_half(jdt[method]), t.cast_half(tdt[method])
    elif method == "dynamic_int8":
        (j_model, j_fn), (t_model, t_fn) = j.dynamic_quantize(), t.dynamic_quantize()
    else:
        (j_model, j_fn), (t_model, t_fn) = j.weight_only_quantize(), t.weight_only_quantize()
    # the stored trees are the same leaves (bf16 ones as tensors on the port's side)
    fj = flat(jax.device_get(j_model))
    ft = flat(jax.tree.map(lambda v: v.float().numpy() if isinstance(v, torch.Tensor) else v,
                           t_model))
    assert fj.keys() == ft.keys()
    for k in fj:
        assert np.array_equal(ft[k], fj[k]), k
    x = images(6, seed=5)
    ref = np.asarray(j_fn(jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = t_fn(torch.from_numpy(x)).numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= METHOD_TOL[method], err
    assert j.size_mb(j_model) == t.size_mb(t_model)


# --------------------------------------------------------------------------
# the r2 conversion golden (chip_smoke.py convert_r2)
# --------------------------------------------------------------------------


def r2_calibration_set():
    """The first 256 images of fold 0's train split of the r2 data (the
    port's bit-identical rebuild of the synthetic surrogate)."""
    from inference_efficient_vision_models_tpu_torch.core.config import TeacherConfig
    from inference_efficient_vision_models_tpu_torch.data.neudet import load_dataset
    from inference_efficient_vision_models_tpu_torch.data.splits import create_fold_split_idx
    from chip_smoke import ARTIFACT

    with open(os.path.join(ARTIFACT, "provenance.json")) as f:
        data = json.load(f)["data"]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TeacherConfig(artifacts_root=tmp, **{
            k: tuple(v) if k == "image_size" else v for k, v in data.items()})
        d = load_dataset(cfg)
    imgs, labels = d["train"]
    tr_idx = np.asarray(create_fold_split_idx(data["num_folds"], labels, data["seed"])[0]["train"])
    return imgs[tr_idx][:256], labels[tr_idx][:256], data


def write_r2_golden():
    from inference_efficient_vision_models_tpu.cli.teacher import load_stage_model
    from chip_smoke import PRUNED

    imgs, labels, data = r2_calibration_set()
    spec, p, s = load_stage_model(PRUNED, "best")
    jf = jq.fold(spec, p, s)
    obs = jq.calibrate(spec, jf, JBatches(imgs, labels, 32), max_images=256)
    # as the JAX engine stores it: device arrays (int32 sums), then fetched
    q = jax.device_get(jax.tree.map(jnp.asarray, jq.convert_static_int8(
        spec, jf, obs, image_size=(224, 224))))
    rec = conversion_record(jq.serializable(q), obs)
    rec["provenance"] = {
        "made_by": "JAX_PLATFORMS=cpu python tests/test_torch_port_quant.py",
        "checkpoint": "artifacts/bench/pruning/r2/fold_0/model_best.msgpack",
        "jax": jax.__version__, "observer": "minmax", "calibration_images": 256,
        "batch_size": 32, "data": data,
        "calibration_set": "the first 256 images of fold 0's train split",
    }
    with open(CONVERT_GOLDEN, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    # the port's deviation on the CPU, from which CONVERT_LIMITS is derived
    tspec = treg.spec_from_dict(spec.to_dict())
    tf = tq.fold(tspec, p, s)
    tobs = tq.calibrate(tspec, tq.place_folded(tf, "cpu"), Batches(imgs, labels, 32, "cpu"),
                        max_images=256)
    got = tq.serializable(tq.convert_static_int8(tspec, tf, tobs, image_size=(224, 224)))
    print(json.dumps(compare_conversion(got, rec), indent=1))


if __name__ == "__main__":
    write_r2_golden()
