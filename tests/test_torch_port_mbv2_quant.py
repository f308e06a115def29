"""Stage 4 of the port on MobileNetV2 against the JAX package, on the CPU at
64x64 on ``mobilenet_v2_050`` (weights from ``chip_smoke.mbv2_params_from_seed``,
BN statistics recalibrated by the JAX package on surrogate images so the
activations have a realistic range): the BN fold, the calibration taps'
ranges, the static-INT8 conversion, kernel E's plain version with its ReLU6
epilogue, the unfused and mixed int8 executors (``impl="plain"``: kernels A
and E by their plain versions), and ``load_quantized`` of every method the
port serves from artifacts the JAX package's engine made and wrote.

Limits: folded leaves and every converted leaf but the derived stem offset
map are EQUAL (numpy on both sides); observer ranges within 1e-5 of their
magnitude (fp32 convs summed in another order; the CPU measures ~5e-6).
Kernel E's plain version equals JAX ``qmobilenet._conv_q(relu6=True)`` bit
for bit (ReLU6 is exact and both requantize by true division), requant ties
included. The executors are held per block with teacher forcing (each block
fed the port's previous output) against the jitted JAX blocks: within one
quantum with >= 98% of values exact, the MBConv rule. Under ``jax.jit``
XLA's CPU backend fuses an epilogue's multiply and add, which moves three
values of s1b0 across a requant edge on these images; run op by op, JAX
takes every rounding the port takes: the stem, all 17 blocks and the logits
are EQUAL (``test_blocks_equal_jax_op_by_op``). The logits against the jitted JAX
executor: within ``TAU`` of the logit scale, twice what the CPU measures
(unfused 0.0674: that one flip grows over 17 blocks of a random-init
network; mixed 8.5e-8, the fp32 summation order of the bf16 products)."""

import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import block_outputs, flat_raw, mbv2_params_from_seed
from inference_efficient_vision_models_tpu.compress.quant import qmobilenet as jqm
from inference_efficient_vision_models_tpu.compress.quant import stemfold as jsf
from inference_efficient_vision_models_tpu.data.pipeline import Batches as JBatches
from inference_efficient_vision_models_tpu.data.synthetic import make_synthetic_neudet
from inference_efficient_vision_models_tpu.models import mobilenet as jmb
from inference_efficient_vision_models_tpu.train.bn_recal import recalibrate_bn as j_recal
from inference_efficient_vision_models_tpu_torch.compress.quant import qmobilenet as tqm
from inference_efficient_vision_models_tpu_torch.compress.quant.qeffnet import stem_int8
from inference_efficient_vision_models_tpu_torch.compress.quant.qresnet import place_folded
from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches as TBatches
from inference_efficient_vision_models_tpu_torch.models import mobilenet as tmb
from inference_efficient_vision_models_tpu_torch.ops import dwconv_int8 as tdw
from inference_efficient_vision_models_tpu_torch.serving import load_quantized
from tests.test_torch_port_fused_mbconv import assert_logits_close, assert_within_one_quantum
from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)

SIZE = 64
NAME = "mobilenet_v2_050"
OBS_RTOL = 1e-5
TAU = {"int8": 0.135, "mixed": 1.7e-7}


@pytest.fixture(scope="module")
def model():
    spec = tmb.mobilenet_v2_spec(NAME, 6)
    jspec = jmb.mobilenet_v2_spec(NAME, 6)
    p, s = mbv2_params_from_seed(spec, 0)
    imgs, labels = make_synthetic_neudet(8, image_size=SIZE, seed=7)
    s = jax.device_get(j_recal(jspec, p, s, imgs))
    jf = jax.device_get(jqm.fold(jspec, p, s))
    tf = tqm.fold(spec, p, s)
    jobs = jqm.calibrate(jspec, jf, JBatches(imgs[:32], labels[:32], 8), max_images=32)
    tobs = tqm.calibrate(spec, place_folded(tf, "cpu"), TBatches(imgs[:32], labels[:32], 8, "cpu"),
                         max_images=32)
    jq = jax.tree.map(np.asarray, jqm.convert_static_int8(jspec, jf, jobs,
                                                          image_size=(SIZE, SIZE)))
    tq = tqm.convert_static_int8(spec, tf, jobs, image_size=(SIZE, SIZE))
    x = make_synthetic_neudet(2, image_size=SIZE, seed=11)[0][::3][:4]  # 4 classes
    return dict(spec=spec, jspec=jspec, p=p, s=s, jf=jf, tf=tf, jobs=jobs, tobs=tobs, jq=jq,
                tq=tq, x=x, imgs=imgs, labels=labels)


def test_fold_equals_jax(model):
    fj, ft = flat_raw(model["jf"]), flat_raw(model["tf"])
    assert fj.keys() == ft.keys()
    assert "/stage1/0/se_reduce/w" not in ft and "/stage0/0/expand/w" not in ft
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)


def test_observer_ranges_match_jax(model):
    jobs, tobs = model["jobs"], model["tobs"]
    assert sorted(jobs) == sorted(tobs)
    assert {"input", "stem", "head", "feat", "s0b0d", "s0b0o", "s1b0e", "s6b0e"} <= set(jobs)
    assert "s0b0e" not in jobs  # block 0 has no expand
    for k, o in jobs.items():
        mag = max(abs(o.min), abs(o.max))
        assert abs(tobs[k].min - o.min) <= OBS_RTOL * mag and \
            abs(tobs[k].max - o.max) <= OBS_RTOL * mag, k


def test_conversion_equals_jax(model):
    """Every leaf equal (integers, scales, zero points), but the stem's
    offset map, derived and never serialized (within 1e-5), and the w_sum
    dtypes (int32 here, as JAX's 32-bit device arrays store them)."""
    fj, ft = flat_raw(model["jq"]), flat_raw(model["tq"])
    assert fj.keys() == ft.keys()
    for k in fj:
        if k == "/stem/e":
            np.testing.assert_allclose(ft[k], fj[k], rtol=1e-5, atol=1e-5)
            continue
        assert ft[k].dtype == fj[k].dtype or k.endswith("w_sum"), k
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    assert ft["/stage1/0/expand/w_sum"].dtype == np.int32
    ser = flat_raw(tqm.serializable(model["tq"]))
    assert "/stem/e" not in ser and "/stem/w_fp" in ser
    back = flat_raw(tqm.restore_derived(tqm.serializable(model["tq"])))
    np.testing.assert_array_equal(back["/stem/e"], ft["/stem/e"])


def _dw_case(rng, n, h, w, c, ties):
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    wq = rng.integers(-127, 128, (3, 3, 1, c), dtype=np.int8)
    if ties:
        # s_in * s_w = 2^-12 and s_out = 2^-9: y / s_out = acc / 8, a tie
        # wherever acc = 4 (mod 8)
        w_scale = np.full(c, 1 / 64, np.float32)
        bias = np.zeros(c, np.float32)
        return x, wq, w_scale, bias, np.float32(1 / 64), np.float32(1 / 512)
    w_scale = (rng.random(c) * 0.02 + 0.002).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.5).astype(np.float32)
    return x, wq, w_scale, bias, np.float32(0.037), np.float32(0.051)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("in_zp", [0, 128, 255])
@pytest.mark.parametrize("n,h,w,c,stride", [(2, 9, 11, 13, 1), (2, 9, 11, 13, 2),
                                            (1, 8, 8, 32, 2), (3, 7, 7, 24, 1)])
def test_kernel_e_relu6_plain_equals_jax(n, h, w, c, stride, in_zp, ties):
    rng = np.random.default_rng(11 * h + c + in_zp + stride)
    x, wq, w_scale, bias, in_scale, out_scale = _dw_case(rng, n, h, w, c, ties)
    out_zp = np.int32(0 if ties else 101)
    qc = {"w_q": jnp.asarray(wq), "w_scale": jnp.asarray(w_scale), "bias": jnp.asarray(bias),
          "w_sum": jnp.asarray(wq.astype(np.int32).sum(axis=(0, 1, 2))),
          "out_scale": out_scale, "out_zp": out_zp}
    ref = np.asarray(jqm._conv_q(jnp.asarray(x), jnp.int32(in_zp), in_scale, qc, stride, 1,
                                 groups=c, relu6=True, requant=True))
    args = (torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(w_scale),
            torch.from_numpy(bias))
    kw = dict(stride=stride, in_scale=in_scale, in_zp=in_zp, out_scale=out_scale,
              out_zp=out_zp, act="relu6")
    got = tdw.depthwise_conv_int8_plain(*args, **kw).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, ref)
    # on a CPU tensor the wrapper takes the plain version
    np.testing.assert_array_equal(tdw.depthwise_conv_int8(*args, **kw).numpy(), ref)
    if ties:
        acc = tdw.depthwise_acc_int32(
            torch.nn.functional.pad(args[0], (0, 0, 1, 1, 1, 1), value=in_zp - 128), args[1],
            stride) - (in_zp - 128) * args[1].int().sum(dim=(0, 1, 2))
        assert ((acc % 8 == 4) & (acc > 0) & (acc < 3072)).any()  # ties on the path
    with pytest.raises(ValueError):
        tdw.depthwise_conv_int8_plain(*args, **{**kw, "act": "gelu"})


def jax_blocks(spec, block_fn):
    """A jitted JAX run of every block, each fed the given input (teacher
    forcing) -> the list of block outputs."""
    plan = tqm.block_plan(spec)

    @jax.jit
    def run(q, stem_out, inputs):
        outs = []
        cur_s, cur_z = q["stem"]["out_scale"], q["stem"]["out_zp"]
        for (name, k, stride, res), x_in in zip(plan, [stem_out] + list(inputs)):
            blk = q[f"stage{name[1]}"][name[3:]]
            outs.append(block_fn(blk, x_in, cur_s, cur_z, kernel=k, stride=stride,
                                 residual=res))
            cur_s, cur_z = blk["out_scale"], blk["out_zp"]
        return outs

    return run


@pytest.mark.parametrize("executor", ["int8", "mixed"])
def test_executor_matches_jax(model, executor):
    spec, jspec, jq, x = model["spec"], model["jspec"], model["jq"], model["x"]
    m = tqm.from_jax_qmodel(spec.to_dict(), jq, "cpu", executor=executor)
    with torch.inference_mode():
        got = m(torch.from_numpy(x), impl="plain").numpy()
        same = m(torch.from_numpy(x)).numpy()  # a CPU tensor takes the plain versions
        outs = block_outputs(m, torch.from_numpy(x))
        stem = stem_int8(m.q, torch.from_numpy(x), impl="plain", act=tqm.ACT).numpy()
    np.testing.assert_array_equal(same, got)
    j_apply = jqm.apply_int8 if executor == "int8" else jqm.apply_int8_mixed
    ref = np.asarray(jax.jit(lambda q, x: j_apply(jspec, q, x))(jq, jnp.asarray(x)))
    assert np.abs(ref).max() > 1.0  # BN recalibration keeps the logits off zero
    assert_logits_close(got, ref, TAU[executor])
    names = [n for n, *_ in tqm.block_plan(spec)]
    j_block = jqm.block_int8 if executor == "int8" else jqm.block_mixed
    ref_blocks = jax_blocks(spec, j_block)(jq, jnp.asarray(stem),
                                           [jnp.asarray(outs[n].numpy()) for n in names[:-1]])
    for n, r in zip(names, ref_blocks):
        assert_within_one_quantum(outs[n].numpy(), np.asarray(r))


@pytest.mark.parametrize("executor", ["int8", "mixed"])
def test_blocks_equal_jax_op_by_op(model, executor):
    """The stem, each of the 17 blocks fed the port's previous output, and
    the whole forward (so the head too) against JAX's run op by op: equal."""
    spec, jspec, jq, x = model["spec"], model["jspec"], model["jq"], model["x"]
    m = tqm.from_jax_qmodel(spec.to_dict(), jq, "cpu", executor=executor)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        outs = block_outputs(m, xt)
        prev = stem_int8(m.q, xt, impl="plain", act=tqm.ACT)
        logits = m(xt, impl="plain").numpy()
    qj = jax.tree.map(jnp.asarray, jq)
    j_block = jqm.block_int8 if executor == "int8" else jqm.block_mixed
    j_apply = jqm.apply_int8 if executor == "int8" else jqm.apply_int8_mixed
    stem = jq["stem"]
    ref_stem = jqm._requant(jsf.apply_u8_stem(qj["stem"], jnp.asarray(x), stride=2, pad=1,
                                              relu6=True), stem["out_scale"], stem["out_zp"])
    np.testing.assert_array_equal(prev.numpy(), np.asarray(ref_stem))
    prev_s, prev_z = stem["out_scale"], stem["out_zp"]
    for name, k, stride, residual in tqm.block_plan(spec):
        blk = jq[f"stage{name[1]}"][name[3:]]
        ref = j_block(qj[f"stage{name[1]}"][name[3:]], jnp.asarray(prev.numpy()), prev_s, prev_z,
                      kernel=k, stride=stride, residual=residual)
        np.testing.assert_array_equal(outs[name].numpy(), np.asarray(ref), err_msg=name)
        prev, prev_s, prev_z = outs[name], blk["out_scale"], blk["out_zp"]
    np.testing.assert_array_equal(logits, np.asarray(j_apply(jspec, qj, jnp.asarray(x))))


def test_float_forward_matches_jax(model):
    """``apply_folded`` (the fp32 method and the taps' forward) against the
    JAX package's, fp32: within 1e-5 of the logit scale (summation order)."""
    from inference_efficient_vision_models_tpu.data.pipeline import normalize_images as j_norm
    from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images

    spec, jspec, x = model["spec"], model["jspec"], model["x"]
    ref = np.asarray(jax.jit(lambda f, x: jqm.apply_folded(jspec, f, j_norm(x)))(
        model["jf"], jnp.asarray(x)))
    got = tqm.apply_folded(spec, place_folded(model["tf"], "cpu"),
                           normalize_images(torch.from_numpy(x))).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


METHODS = ("static_int8", "static_int8_mixed", "static_int8_fused", "dynamic_int8", "fp16",
           "bf16", "weight_only_int8")


def test_load_quantized_restores_jax_artifacts(model, tmp_path):
    """The JAX package's QuantizationEngine converts the model and its stage-4
    writer saves each method; the port's ``load_quantized`` restores every
    one (the mixed and fused executors from the shared static-int8 file, as
    the JAX loader falls back): the int8 executors equal the port's model
    built from the engine's tree in memory; the float methods meet the
    forward the JAX engine returned with the artifact within ``tol`` of the
    logit scale, twice what the CPU measures (dynamic int8 4.6e-4: its
    per-batch activation qparams carry the fp32 trunk's summation order;
    fp16 0.0277, bf16 0.192, W8A16 0.181: the convs round their fp16 / bf16
    outputs at other places than XLA's, and this random-init network with
    recalibrated statistics amplifies a relative perturbation ~50x over 17
    blocks: fp16's 2^-11 and bf16's 2^-8 become those shares)."""
    import logging

    from inference_efficient_vision_models_tpu.cli.quantize import _save_qmodel
    from inference_efficient_vision_models_tpu.compress.quant.engine import QuantizationEngine
    from inference_efficient_vision_models_tpu.core.config import QuantConfig

    jspec, p, s = model["jspec"], model["p"], model["s"]
    cfg = QuantConfig(image_size=(SIZE, SIZE), calibration_images=32, batch_size=8,
                      artifacts_root=str(tmp_path))
    eng = QuantizationEngine(cfg, jspec, p, s, logging.getLogger("test"))
    calib = (model["imgs"][:32], model["labels"][:32])
    made = {"static_int8": eng.static_quantize(calib),
            "dynamic_int8": eng.dynamic_quantize(),
            "fp16": eng.cast_half(jnp.float16), "bf16": eng.cast_half(jnp.bfloat16),
            "weight_only_int8": eng.weight_only_quantize()}
    fold = str(tmp_path / "fold_0")
    for method, (m, _) in made.items():
        _save_qmodel(fold, method, m, jspec)
    assert json.load(open(f"{fold}/spec.json"))["__kind__"] == "mobilenet_v2"
    from inference_efficient_vision_models_tpu_torch.compress.quant import fusedpath as tfp

    x, xt = model["x"], torch.from_numpy(model["x"])
    q_np = jax.tree.map(np.asarray, made["static_int8"][0])
    sd = model["spec"].to_dict()
    in_memory = {"static_int8": tqm.from_jax_qmodel(sd, q_np, "cpu"),
                 "static_int8_mixed": tqm.from_jax_qmodel(sd, q_np, "cpu", executor="mixed"),
                 "static_int8_fused": tfp.from_jax_qmodel(sd, q_np, "cpu")}
    tol = {"dynamic_int8": 9.2e-4, "fp16": 0.056, "bf16": 0.39, "weight_only_int8": 0.37}
    for method in METHODS:
        spec, _, fn, pre = load_quantized(fold, method, device="cpu")
        assert pre is None and spec == model["spec"], method
        with torch.no_grad():
            got = fn(xt).float().numpy()
        assert got.shape == (len(x), 6) and np.isfinite(got).all(), method
        if method in in_memory:
            with torch.no_grad():
                np.testing.assert_array_equal(got, in_memory[method](xt).numpy())
            continue
        ref = np.asarray(made[method][1](jnp.asarray(x)), np.float32)
        assert np.abs(got - ref).max() <= tol[method] * np.abs(ref).max(), method


def test_convert_and_logits_goldens_are_current():
    """The committed conversion record and JAX logits were made from the
    seeded weights and images ``chip_smoke`` gives today, and the port's CPU
    conversion from the recorded BN statistics meets the record leaf for leaf
    (activation qparams within ``MBV2_CONVERT_LIMITS``)."""
    from chip_smoke import (MBV2_CONVERT, MBV2_CONVERT_GOLDEN, MBV2_CONVERT_LIMITS,
                            MBV2_CONVERT_STATE, MBV2_GOLDEN, _eff_tap_of, compare_conversion,
                            effnet_convert_inputs, leaf_sums, mbv2_golden_images,
                            nested_from_npz)
    from inference_efficient_vision_models_tpu_torch.compress.quant.observers import (
        ObserverState)
    from tests.test_torch_port_resnet_float import flat

    with open(MBV2_CONVERT_GOLDEN) as f:
        golden = json.load(f)
    spec, p, s, imgs, _ = effnet_convert_inputs("mobilenet_v2", MBV2_CONVERT)
    np.testing.assert_array_equal(leaf_sums(p), golden["provenance"]["param_sums"])
    assert int(imgs.sum(dtype=np.int64)) == golden["provenance"]["image_sum"]
    state = nested_from_npz(np.load(MBV2_CONVERT_STATE))
    assert flat(state).keys() == flat(s).keys()
    obs = {k: ObserverState(lo, hi, True) for k, (lo, hi) in golden["observers"].items()}
    q = tqm.convert_static_int8(spec, tqm.fold(spec, p, state), obs, image_size=(224, 224))
    report = compare_conversion(tqm.serializable(q), golden, MBV2_CONVERT_LIMITS, _eff_tap_of)
    assert report["ok"], report
    logits = np.load(MBV2_GOLDEN)
    x = mbv2_golden_images()
    assert int(logits["image_sum"]) == int(x.sum(dtype=np.int64))
    assert logits["int8"].shape == logits["mixed"].shape == (len(x), 6)


def test_calib_spread_controls_are_refused():
    """``calib_spread.calibration_in`` at 64x64: an fp64 calibration stays
    within ``scale_rtol`` of the fp32 one, the bf16 and fp16 controls do not,
    and the patched functions are restored."""
    import calib_spread
    import chip_smoke as cs
    from inference_efficient_vision_models_tpu_torch.compress.quant import calib, qresnet

    cfg = dict(cs.MBV2_CONVERT, size=SIZE, per_class=2, batch=4)
    spec, p, s, imgs, labels = cs.effnet_convert_inputs(NAME, cfg)
    q, obs, _ = cs.port_convert_effnet(spec, p, s, imgs, labels, "cpu", cfg)
    rec = cs.conversion_record(tqm.serializable(q), obs)
    norm, place = calib.normalize_images, qresnet.place_folded
    devs = {}
    for name, dtype in (("fp64", torch.float64), *calib_spread.CONTROLS.items()):
        with calib_spread.calibration_in(dtype):
            qd, _, _ = cs.port_convert_effnet(spec, p, s, imgs, labels, "cpu", cfg)
        devs[name] = cs.compare_conversion(tqm.serializable(qd), rec, cs.MBV2_CONVERT_LIMITS,
                                           cs._eff_tap_of)["max_scale_rel"]
    assert calib.normalize_images is norm and qresnet.place_folded is place
    limit = cs.MBV2_CONVERT_LIMITS["scale_rtol"]
    assert devs["fp64"] <= limit < min(devs["bf16"], devs["fp16"]), devs


def write_goldens(seed=None, out_dir=None) -> None:
    """The JAX package's CPU run of ``MBV2_CONVERT``: BN recalibration on the
    surrogate images, fold, minmax calibration, conversion, its record and
    the statistics; then its unfused and mixed executors, op by op, on
    ``mbv2_golden_images``; then the port's CPU deviation from each over
    1-8 torch threads, the source of ``MBV2_CONVERT_LIMITS`` and ``MBV2_TAU``.
    With ``seed`` and ``out_dir``: the record and the statistics of the
    model drawn from that weight seed, written to ``out_dir`` (no logits),
    which ``calib_spread.py`` holds the card's calibration against."""
    import time

    from chip_smoke import (MBV2_CONVERT, MBV2_CONVERT_GOLDEN, MBV2_CONVERT_STATE, MBV2_GOLDEN,
                            _eff_tap_of, compare_conversion, conversion_record,
                            effnet_convert_inputs, flat_state_npz, leaf_sums,
                            mbv2_golden_images, port_convert_effnet, port_recal_effnet,
                            state_deviation, with_record_qparams)

    t0 = time.time()
    cfg = MBV2_CONVERT if seed is None else dict(MBV2_CONVERT, seed=seed)
    rec_path, state_path, made_by = (MBV2_CONVERT_GOLDEN, MBV2_CONVERT_STATE,
                                     "JAX_PLATFORMS=cpu python tests/test_torch_port_mbv2_quant.py")
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        rec_path = os.path.join(out_dir, os.path.basename(MBV2_CONVERT_GOLDEN))
        state_path = os.path.join(out_dir, os.path.basename(MBV2_CONVERT_STATE))
        made_by += f" --seed {cfg['seed']} --out {out_dir}"
    spec, p, s, imgs, labels = effnet_convert_inputs("mobilenet_v2", cfg)
    jspec = jmb.mobilenet_v2_spec("mobilenet_v2", 6)
    b = cfg["batch"]
    state = jax.device_get(j_recal(jspec, p, s, imgs, batch_size=b, num_batches=len(imgs) // b))
    jf = jqm.fold(jspec, p, state)
    obs = jqm.calibrate(jspec, jf, JBatches(imgs, labels, b), max_images=len(imgs))
    q = jax.device_get(jax.tree.map(jnp.asarray, jqm.convert_static_int8(
        jspec, jf, obs, image_size=(cfg["size"], cfg["size"]))))
    rec = conversion_record(jqm.serializable(q), obs)
    rec["provenance"] = {
        "made_by": made_by,
        "jax": jax.__version__, "config": cfg, "observer": "minmax",
        "param_sums": leaf_sums(p).tolist(), "image_sum": int(imgs.sum(dtype=np.int64)),
        "weights": "chip_smoke.mbv2_params_from_seed(mobilenet_v2, seed), BN statistics "
                   "recalibrated on the images (train/bn_recal.recalibrate_bn), stored beside "
                   "this file",
    }
    with open(rec_path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    np.savez_compressed(state_path, **flat_state_npz(state))
    print(f"wrote {rec_path} and {state_path} ({time.time() - t0:.0f} s)")
    x = mbv2_golden_images()
    out = {}
    if out_dir is None:
        qj = jax.tree.map(jnp.asarray, q)
        out = {"image_sum": np.int64(x.sum(dtype=np.int64))}
        for ex, fn in (("int8", jqm.apply_int8), ("mixed", jqm.apply_int8_mixed)):
            out[ex] = np.asarray(fn(jspec, qj, jnp.asarray(x)), np.float32)  # op by op
        np.savez_compressed(MBV2_GOLDEN, **out)
        print(f"wrote {MBV2_GOLDEN} ({time.time() - t0:.0f} s); logit scale "
              f"{float(np.abs(out['int8']).max())}")
    # the record's own fp32 error: an fp64 calibration of the same images
    from inference_efficient_vision_models_tpu_torch.compress.quant import calib
    from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches as TB

    norm = calib.normalize_images
    calib.normalize_images = lambda x: norm(x).double()
    f64 = tqm.calibrate(spec, place_folded(tqm.fold(spec, p, state), "cpu", dtype=torch.float64),
                        TB(imgs, labels, b, "cpu"), max_images=len(imgs))
    calib.normalize_images = norm
    q64 = tqm.convert_static_int8(spec, tqm.fold(spec, p, state), f64, image_size=(224, 224))
    r64 = compare_conversion(tqm.serializable(q64), rec, {"scale_rtol": 0.0}, _eff_tap_of)
    print(f"the record's fp32 scales against an fp64 calibration: {r64['max_scale_rel']} "
          f"({r64['worst_scale']})")
    q_np = jax.tree.map(np.asarray, q)
    for threads in (1, 2, 4, 8):  # the summation order moves with the thread count
        torch.set_num_threads(threads)
        recal = port_recal_effnet(spec, p, s, imgs, "cpu", cfg)
        tq, _, _ = port_convert_effnet(spec, p, state, imgs, labels, "cpu", cfg)
        report = compare_conversion(tqm.serializable(tq), rec, {"scale_rtol": 0.0}, _eff_tap_of)
        model_q = with_record_qparams(tq, rec)
        devs = {}
        for ex in ("int8", "mixed") if out else ():
            m = tqm.from_jax_qmodel(spec.to_dict(), model_q, "cpu", executor=ex)
            with torch.inference_mode():
                got = m(torch.from_numpy(x), impl="plain").numpy()
            devs[ex] = float(np.abs(got - out[ex]).max() / np.abs(out[ex]).max())
        print(f"{threads} threads: recal deviation {state_deviation(recal, state)}, scales "
              f"{report['max_scale_rel']} ({report['worst_scale']}), leaves unequal "
              f"{report['leaves_unequal']}, zero points {report['zp_bad']}, logits over "
              f"scale {devs} ({time.time() - t0:.0f} s)")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=write_goldens.__doc__)
    ap.add_argument("--seed", type=int, default=None, help="weight seed of another record")
    ap.add_argument("--out", default=None, help="its directory (with --seed)")
    a = ap.parse_args()
    if (a.seed is None) != (a.out is None):
        ap.error("--seed and --out go together")
    write_goldens(a.seed, a.out)
