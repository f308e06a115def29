"""The static-INT8 ResNeXt of the port against the JAX package, on the CPU:
a narrow ResNeXt (cardinality 4, Cg 4 and 8) and a lane-pruned one (Cg 3
and 6, not multiples of 4), each made by the JAX package's ``create_model``
and ``QuantizationEngine.static_quantize`` at 64x64 and carried over by the
port's ``from_jax_qmodel`` (its grouped conv2 on kernel F's plain version):
logits against JAX ``apply_int8(impl="lax")`` within
``test_torch_port_qresnet.py``'s limit (argmax identical, rtol/atol 0.02:
kernel A requantizes the 1x1 convs by 1/s_y, the lax path divides); the
port's own ``convert_static_int8`` from the same observers equal to JAX's
leaf for leaf (``w_sum`` over a group's (3, 3, Cg)); the model served
through ``load_quantized`` from the JAX stage-4 writer's artifact.

Running this file as a script converts a seeded full-width resnext26_32x4d
with the JAX package on the CPU and runs its INT8 executor op by op,
writing ``testdata/resnext26_convert_jax.json`` and
``testdata/resnext26_int8_jax_logits.npz`` (``chip_smoke.py``'s
``convert_resnext``), and prints the port's CPU deviation from both:
``JAX_PLATFORMS=cpu python tests/test_torch_port_resnext_quant.py``.
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

from chip_smoke import (RX_CONVERT, RX_CONVERT_GOLDEN, RX_GOLDEN, _tap_of, compare_conversion,
                        conversion_record, effnet_convert_inputs, flat_raw, leaf_sums,
                        port_convert_effnet, rx_golden_images, with_record_qparams)
from inference_efficient_vision_models_tpu.cli.quantize import _save_qmodel
from inference_efficient_vision_models_tpu.compress.quant import qresnet as jq
from inference_efficient_vision_models_tpu.compress.quant.engine import QuantizationEngine
from inference_efficient_vision_models_tpu.data.pipeline import Batches as JBatches
from inference_efficient_vision_models_tpu.models import create_model
from inference_efficient_vision_models_tpu.models.registry import make_spec as j_make_spec
from inference_efficient_vision_models_tpu.models.widths import ResNetSpec
from inference_efficient_vision_models_tpu_torch.compress.quant import qresnet as tq
from inference_efficient_vision_models_tpu_torch.ops.gconv_int8 import GroupedInt8Weight
from inference_efficient_vision_models_tpu_torch.serving import load_quantized

try:
    from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from tests.test_torch_port_qresnet import _assert_logits_match
    from tests.test_torch_port_resnet_float import flat
except ImportError:
    from test_torch_port_prune import one_thread  # noqa: F401
    from test_torch_port_qresnet import _assert_logits_match
    from test_torch_port_resnet_float import flat

SIZE = 64


def _tiny_next_spec(inner=(16, 32)):
    """tests/test_resnext.py's small grouped-bottleneck net (cardinality 4);
    ``inner=(12, 24)``: its lanes pruned to Cg 3 and 6."""
    return ResNetSpec(name="tinynext", block="bottleneck", depths=(1, 1), stage_widths=(32, 64),
                      inner_widths=(((inner[0],) * 2,), ((inner[1],) * 2,)), stem_width=16,
                      num_classes=6, groups=4)


class Cfg:
    batch_size = 8
    calibration_images = 16
    DEBUG_MODE = False
    image_size = (SIZE, SIZE)
    compute_dtype = "float32"
    observer = "minmax"
    percentile = 99.99


@pytest.fixture(scope="module", params=[(16, 32), (12, 24)], ids=["cg4_8", "lanes_cg3_6"])
def made(request, tmp_path_factory):
    spec = _tiny_next_spec(request.param)
    _, params, state = create_model(spec, num_classes=6)
    imgs = np.random.default_rng(7).integers(0, 256, (16, SIZE, SIZE, 3), dtype=np.uint8)
    eng = QuantizationEngine(Cfg(), spec, params, state, logging.getLogger("q"))
    qmodel, q_fn = eng.static_quantize((imgs, np.zeros(16, np.int32)))
    qmodel = jax.tree.map(np.asarray, qmodel)
    fold = str(tmp_path_factory.mktemp("rx") / "fold_0")
    _save_qmodel(fold, "static_int8", qmodel, spec)
    ref = np.asarray(q_fn(jnp.asarray(imgs)))
    return dict(spec=spec, params=jax.device_get(params), state=jax.device_get(state),
                imgs=imgs, qmodel=qmodel, ref=ref, fold=fold)


def test_from_jax_qmodel_matches_jax_lax(made):
    spec = made["spec"]
    model = tq.from_jax_qmodel(spec.to_dict(), made["qmodel"], device="cpu")
    w = model.q["layer1"]["0"]["conv2"]["w"]
    assert isinstance(w, GroupedInt8Weight) and w.groups == 4
    assert w.cg == spec.inner_widths[0][0][0] // 4
    with torch.inference_mode():
        got = model(torch.from_numpy(made["imgs"])).numpy()
    _assert_logits_match(got, made["ref"])
    # JAX's apply_int8 with impl="lax" outside jit, the executor the golden runs
    ref = np.asarray(jq.apply_int8(spec, jax.tree.map(jnp.asarray, jq.restore_derived(
        made["qmodel"])), jnp.asarray(made["imgs"][:4])))
    _assert_logits_match(got[:4], ref)


def test_port_conversion_equals_jax(made):
    """The port's fold + convert from the JAX observers: every leaf equal."""
    spec = made["spec"]
    jf = jax.device_get(jq.fold(spec, made["params"], made["state"]))
    tf = tq.fold(spec, made["params"], made["state"])
    fj, ft = flat(jf), flat(tf)
    assert fj.keys() == ft.keys() and all(np.array_equal(fj[k], ft[k]) for k in fj)
    obs = jq.calibrate(spec, jf, JBatches(made["imgs"], np.zeros(16, np.int32), 8),
                       max_images=16)
    # as the JAX engine stores it: 32-bit device arrays (numpy sums int32 to int64)
    ref = flat_raw(jax.device_get(jax.tree.map(jnp.asarray, jq.convert_static_int8(
        spec, jf, obs, image_size=(SIZE, SIZE)))))
    got = flat_raw(tq.convert_static_int8(spec, tf, obs, image_size=(SIZE, SIZE)))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    c2 = got["/layer1/0/conv2/w_sum"]
    assert c2.dtype == np.int32 and np.array_equal(
        c2, got["/layer1/0/conv2/w_q"].astype(np.int64).sum(axis=(0, 1, 2)))


def test_served_through_load_quantized(made):
    """The JAX writer's artifact through the port's loader and ``Predictor``
    path: the in-memory model's logits, from raw uint8 and s2d input."""
    from inference_efficient_vision_models_tpu_torch.serving import Predictor

    spec, model, fn, pre = load_quantized(made["fold"], "static_int8", device="cpu")
    assert spec.groups == 4 and pre is not None
    pred = Predictor(fn, host_preprocess=pre, batch_size=8, device="cpu")
    got = pred.predict_logits(made["imgs"])
    mem = tq.from_jax_qmodel(spec.to_dict(), made["qmodel"], device="cpu")
    with torch.inference_mode():
        np.testing.assert_array_equal(got, mem(torch.from_numpy(made["imgs"])).numpy())
    _assert_logits_match(got, made["ref"])


def test_convert_and_logits_goldens_are_current():
    """The committed conversion record and logits were made from the seeded
    weights and images ``chip_smoke`` gives today; the record's leaves are
    the JAX layout of resnext26_32x4d (grouped conv2 (3, 3, Cg, C))."""
    with open(RX_CONVERT_GOLDEN) as f:
        golden = json.load(f)
    spec, p, _, imgs, _ = effnet_convert_inputs("resnext26_32x4d", RX_CONVERT)
    np.testing.assert_array_equal(leaf_sums(p), golden["provenance"]["param_sums"])
    assert int(imgs.sum(dtype=np.int64)) == golden["provenance"]["image_sum"]
    assert golden["leaves"]["/layer1/0/conv2/w_q"]["shape"] == [3, 3, 4, 128]
    assert golden["leaves"]["/layer4/1/conv2/w_q"]["shape"] == [3, 3, 32, 1024]
    logits = np.load(RX_GOLDEN)
    x = rx_golden_images()
    assert int(logits["image_sum"]) == int(x.sum(dtype=np.int64))
    assert logits["int8"].shape == (len(x), 6) and np.isfinite(logits["int8"]).all()


def write_goldens() -> None:
    """The JAX package's CPU run of ``RX_CONVERT``: fold, minmax calibration,
    conversion and its record; its static INT8 executor (``impl="lax"``) op
    by op on ``rx_golden_images``; then the record's own fp32 error against
    an fp64 calibration and the port's CPU deviation from both over 1-8
    torch threads (scales, and logits of the port's conversion with the
    record's activation qparams), the source of ``RX_CONVERT_LIMITS`` and
    ``RX_TAU``."""
    import time

    from inference_efficient_vision_models_tpu_torch.compress.quant import calib
    from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches as TB

    t0 = time.time()
    spec, p, s, imgs, labels = effnet_convert_inputs("resnext26_32x4d", RX_CONVERT)
    jspec = j_make_spec("resnext26_32x4d", 6)
    b = RX_CONVERT["batch"]
    jf = jq.fold(jspec, p, s)
    obs = jq.calibrate(jspec, jf, JBatches(imgs, labels, b), max_images=len(imgs))
    q = jax.device_get(jax.tree.map(jnp.asarray, jq.convert_static_int8(
        jspec, jf, obs, image_size=(RX_CONVERT["size"],) * 2)))
    rec = conversion_record(jq.serializable(q), obs)
    rec["provenance"] = {
        "made_by": "JAX_PLATFORMS=cpu python tests/test_torch_port_resnext_quant.py",
        "jax": jax.__version__, "config": RX_CONVERT, "observer": "minmax",
        "param_sums": leaf_sums(p).tolist(), "image_sum": int(imgs.sum(dtype=np.int64)),
        "weights": "chip_smoke.resnet_params_from_seed(resnext26_32x4d, seed)",
    }
    with open(RX_CONVERT_GOLDEN, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    print(f"wrote {RX_CONVERT_GOLDEN} ({time.time() - t0:.0f} s)", flush=True)
    x = rx_golden_images()
    qj = jax.tree.map(jnp.asarray, jq.restore_derived(q))
    out = np.concatenate([np.asarray(jq.apply_int8(jspec, qj, jnp.asarray(x[i : i + 2])),
                                     np.float32) for i in range(0, len(x), 2)])  # op by op
    np.savez_compressed(RX_GOLDEN, int8=out, image_sum=np.int64(x.sum(dtype=np.int64)))
    print(f"wrote {RX_GOLDEN} ({time.time() - t0:.0f} s); logit scale "
          f"{float(np.abs(out).max())}", flush=True)
    # the record's own fp32 error: an fp64 calibration of the same images
    norm = calib.normalize_images
    calib.normalize_images = lambda t: norm(t).double()
    f64 = tq.calibrate(spec, tq.place_folded(tq.fold(spec, p, s), "cpu", dtype=torch.float64),
                       TB(imgs, labels, b, "cpu"), max_images=len(imgs))
    calib.normalize_images = norm
    q64 = tq.convert_static_int8(spec, tq.fold(spec, p, s), f64, image_size=(224, 224))
    r64 = compare_conversion(tq.serializable(q64), rec, {"scale_rtol": 0.0}, _tap_of)
    print(f"the record's fp32 scales against an fp64 calibration: {r64['max_scale_rel']} "
          f"({r64['worst_scale']})", flush=True)
    for threads in (1, 2, 4, 8):  # the summation order moves with the thread count
        torch.set_num_threads(threads)
        tqm, _, _ = port_convert_effnet(spec, p, s, imgs, labels, "cpu", RX_CONVERT)
        report = compare_conversion(tq.serializable(tqm), rec, {"scale_rtol": 0.0}, _tap_of)
        m = tq.from_jax_qmodel(spec.to_dict(), with_record_qparams(tqm, rec), "cpu")
        with torch.inference_mode():
            got = m(torch.from_numpy(x)).numpy()
        print(f"{threads} threads: scales {report['max_scale_rel']} ({report['worst_scale']}), "
              f"leaves unequal {report['leaves_unequal']}, zero points {report['zp_bad']}, "
              f"logits over scale {float(np.abs(got - out).max() / np.abs(out).max())}, "
              f"argmax {float((got.argmax(1) == out.argmax(1)).mean())} "
              f"({time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    write_goldens()
