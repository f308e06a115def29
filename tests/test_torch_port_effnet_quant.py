"""Stage 4 of the port on EfficientNet-B0 against the JAX package, on the CPU
at full width and 64x64 (weights from ``chip_smoke.effnet_params_from_seed``,
BN statistics recalibrated by the JAX package on surrogate images so the
activations have a realistic range): the BN fold, the calibration taps'
ranges, the static-INT8 conversion, the unfused and mixed int8 executors
(``impl="plain"``: kernels A and E by their plain versions) and the fused
executor on the port's own conversion.

Limits: folded leaves and every converted leaf but the derived stem offset
map are EQUAL (numpy on both sides); observer ranges within 1e-5 of their
magnitude (fp32 convs summed in another order; the CPU measures 4.9e-6).
The executors are held per block with teacher forcing (each block fed the
port's previous output): within one quantum with >= 98% of values exact,
the rule of the fused executor's tests (the SiLU and sigmoid of the two
sides differ by ulps). Logits, on surrogate images: ``TAU`` of the logit
scale, twice the deviation this file measures (mixed against JAX 0.067: the
bf16 depthwise feeds the SE gate unrounded, and an early one-quantum flip
grows over 16 blocks; fused against unfused 0.0144), and 0.02 for the
unfused executor, which measures 2.9e-8 (no value crosses a rounding edge
on these images; 0.02 leaves room for one flip in a late block)."""

import os
import sys

import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch

from chip_smoke import block_outputs, effnet_params_from_seed, flat_raw
from inference_efficient_vision_models_tpu.compress.quant import qeffnet as jqe
from inference_efficient_vision_models_tpu.data.pipeline import Batches as JBatches
from inference_efficient_vision_models_tpu.data.synthetic import make_synthetic_neudet
from inference_efficient_vision_models_tpu.models import efficientnet as jeff
from inference_efficient_vision_models_tpu.train.bn_recal import recalibrate_bn as j_recal
from inference_efficient_vision_models_tpu_torch.compress.quant import fusedpath as tfp
from inference_efficient_vision_models_tpu_torch.compress.quant import qeffnet as tqe
from inference_efficient_vision_models_tpu_torch.compress.quant.qresnet import place_folded
from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches as TBatches
from inference_efficient_vision_models_tpu_torch.models import efficientnet as teff
from inference_efficient_vision_models_tpu_torch.ops.fused_mbconv import fused_mbconv_block_plain

try:
    from tests.test_torch_port_fused_mbconv import assert_logits_close, assert_within_one_quantum
    from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from tests.test_torch_port_resnet_float import flat
except ImportError:
    from test_torch_port_fused_mbconv import assert_logits_close, assert_within_one_quantum
    from test_torch_port_prune import one_thread  # noqa: F401
    from test_torch_port_resnet_float import flat

SIZE = 64
OBS_RTOL = 1e-5
TAU = {"int8": 0.02, "mixed": 0.14, "fused": 0.03}


@pytest.fixture(scope="module")
def model():
    spec = teff.efficientnet_spec("efficientnet_b0", 6)
    jspec = jeff.efficientnet_spec("efficientnet_b0", 6)
    p, s = effnet_params_from_seed(spec, 0)
    imgs, labels = make_synthetic_neudet(8, image_size=SIZE, seed=7)
    s = jax.device_get(j_recal(jspec, p, s, imgs))
    jf = jax.device_get(jqe.fold(jspec, p, s))
    tf = tqe.fold(spec, p, s)
    jobs = jqe.calibrate(jspec, jf, JBatches(imgs[:32], labels[:32], 8), max_images=32)
    tobs = tqe.calibrate(spec, place_folded(tf, "cpu"), TBatches(imgs[:32], labels[:32], 8, "cpu"),
                         max_images=32)
    jq = jax.tree.map(np.asarray, jqe.convert_static_int8(jspec, jf, jobs, image_size=(SIZE,
                                                                                       SIZE)))
    tq = tqe.convert_static_int8(spec, tf, jobs, image_size=(SIZE, SIZE))
    x = make_synthetic_neudet(2, image_size=SIZE, seed=11)[0][::3][:4]  # 4 classes
    return dict(spec=spec, jspec=jspec, p=p, s=s, jf=jf, tf=tf, jobs=jobs, tobs=tobs, jq=jq,
                tq=tq, x=x)


def test_fold_equals_jax(model):
    fj, ft = flat(model["jf"]), flat(model["tf"])
    assert fj.keys() == ft.keys()
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)


def test_observer_ranges_match_jax(model):
    jobs, tobs = model["jobs"], model["tobs"]
    assert sorted(jobs) == sorted(tobs)
    assert {"input", "stem", "head", "feat", "s0b0d", "s0b0se", "s0b0o", "s6b0e"} <= set(jobs)
    assert "s0b0e" not in jobs  # block 0 has no expand
    for k, o in jobs.items():
        mag = max(abs(o.min), abs(o.max))
        assert abs(tobs[k].min - o.min) <= OBS_RTOL * mag and \
            abs(tobs[k].max - o.max) <= OBS_RTOL * mag, k


def test_conversion_equals_jax(model):
    """Every leaf equal (integers, scales, zero points, dtypes), but the
    stem's offset map, derived and never serialized: there the port's conv of
    the constant image sums in another order (within 1e-5)."""
    fj, ft = flat_raw(model["jq"]), flat_raw(model["tq"])
    assert fj.keys() == ft.keys()
    for k in fj:
        if k == "/stem/e":
            np.testing.assert_allclose(ft[k], fj[k], rtol=1e-5, atol=1e-5)
            continue
        assert ft[k].dtype == fj[k].dtype or k.endswith("w_sum"), k
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    assert ft["/stage1/0/expand/w_sum"].dtype == np.int32
    ser = flat_raw(tqe.serializable(model["tq"]))
    assert "/stem/e" not in ser and "/stem/w_fp" in ser
    back = flat_raw(tqe.restore_derived(tqe.serializable(model["tq"])))
    np.testing.assert_array_equal(back["/stem/e"], ft["/stem/e"])


def jax_blocks(spec, block_fn):
    """A jitted JAX run of every block, each fed the given input (teacher
    forcing) -> the list of block outputs."""
    plan = tqe.block_plan(spec)

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
    m = tqe.from_jax_qmodel(spec.to_dict(), jq, "cpu", executor=executor)
    with torch.inference_mode():
        got = m(torch.from_numpy(x), impl="plain").numpy()
        outs = block_outputs(m, torch.from_numpy(x))
        stem = tqe.stem_int8(m.q, torch.from_numpy(x), impl="plain").numpy()
    j_apply = jqe.apply_int8 if executor == "int8" else jqe.apply_int8_mixed
    ref = np.asarray(jax.jit(lambda q, x: j_apply(jspec, q, x))(jq, jnp.asarray(x)))
    assert_logits_close(got, ref, TAU[executor])
    names = [n for n, *_ in tqe.block_plan(spec)]
    j_block = jqe.block_int8 if executor == "int8" else jqe.block_mixed
    ref_blocks = jax_blocks(spec, j_block)(jq, jnp.asarray(stem),
                                           [jnp.asarray(outs[n].numpy()) for n in names[:-1]])
    for n, r in zip(names, ref_blocks):
        assert_within_one_quantum(outs[n].numpy(), np.asarray(r))


def test_fused_executor_on_the_ports_conversion(model):
    """The fused executor serves the port's own conversion: each block
    (plain kernel C), fed the unfused executor's input, within one quantum
    of the unfused block's output and >= 98% exact; logits within TAU."""
    spec, tq, x = model["spec"], model["tq"], model["x"]
    unfused = tqe.from_jax_qmodel(spec.to_dict(), tq, "cpu")
    fused = tfp.from_jax_qmodel(spec.to_dict(), tq, "cpu")
    with torch.inference_mode():
        u_logits = unfused(torch.from_numpy(x), impl="plain").numpy()
        outs = block_outputs(unfused, torch.from_numpy(x))
        f_logits = fused(torch.from_numpy(x)).numpy()
        prev = tqe.stem_int8(unfused.q, torch.from_numpy(x), impl="plain")
        for name, k, stride, res in tqe.block_plan(spec):
            got = fused_mbconv_block_plain(prev, fused.qf[name], kernel=k, stride=stride,
                                           act="silu", x_res=prev if res else None)
            assert_within_one_quantum(got.numpy(), outs[name].numpy())
            prev = outs[name]
    assert_logits_close(f_logits, u_logits, TAU["fused"])


def test_float_forward_matches_jax(model):
    """``apply_folded`` (the fp32 method and the taps' forward) against the
    JAX package's, fp32: within 2.5e-5 of the logit scale, twice the 1.17e-5
    measured (the recalibrated network's gain carries the summation-order
    differences of 16 blocks to logits of a few hundred)."""
    from inference_efficient_vision_models_tpu.data.pipeline import normalize_images as j_norm
    from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images

    spec, jspec, x = model["spec"], model["jspec"], model["x"]
    ref = np.asarray(jax.jit(lambda f, x: jqe.apply_folded(jspec, f, j_norm(x)))(
        model["jf"], jnp.asarray(x)))
    got = tqe.apply_folded(spec, place_folded(model["tf"], "cpu"),
                           normalize_images(torch.from_numpy(x))).numpy()
    assert np.abs(got - ref).max() <= 2.5e-5 * np.abs(ref).max()


def test_convert_golden_is_current():
    """The committed conversion record was made from the seeded weights and
    images ``chip_smoke.effnet_convert_inputs`` gives today, and the port's
    CPU conversion from the recorded BN statistics meets it within
    ``EFF_CONVERT_LIMITS`` (activation qparams) and leaf for leaf."""
    import json

    from chip_smoke import (EFF_CONVERT_GOLDEN, EFF_CONVERT_LIMITS, EFF_CONVERT_STATE,
                            _eff_tap_of, compare_conversion, effnet_convert_inputs, leaf_sums,
                            nested_from_npz)

    with open(EFF_CONVERT_GOLDEN) as f:
        golden = json.load(f)
    spec, p, s, imgs, _ = effnet_convert_inputs()
    np.testing.assert_array_equal(leaf_sums(p), golden["provenance"]["param_sums"])
    assert int(imgs.sum(dtype=np.int64)) == golden["provenance"]["image_sum"]
    state = nested_from_npz(np.load(EFF_CONVERT_STATE))
    assert flat(state).keys() == flat(s).keys()
    # the conversion's weight leaves from the recorded statistics (no calibration:
    # the recorded ranges stand in for the observers)
    from inference_efficient_vision_models_tpu_torch.compress.quant.observers import ObserverState

    obs = {k: ObserverState(lo, hi, True) for k, (lo, hi) in golden["observers"].items()}
    q = tqe.convert_static_int8(spec, tqe.fold(spec, p, state), obs, image_size=(224, 224))
    report = compare_conversion(tqe.serializable(q), golden, EFF_CONVERT_LIMITS, _eff_tap_of)
    assert report["ok"], report


def write_convert_golden() -> None:
    """The JAX package's CPU run of ``EFF_CONVERT``: BN recalibration on the
    surrogate images, fold, minmax calibration, conversion (as the JAX engine
    stores it: device arrays, int32 sums), its record and the statistics;
    then the port's CPU deviation from it, the source of ``EFF_CONVERT_LIMITS``."""
    import json

    from chip_smoke import (EFF_CONVERT, EFF_CONVERT_GOLDEN, EFF_CONVERT_STATE, _eff_tap_of,
                            compare_conversion, conversion_record, effnet_convert_inputs,
                            flat_state_npz, leaf_sums, port_convert_effnet, port_recal_effnet,
                            state_deviation)

    spec, p, s, imgs, labels = effnet_convert_inputs()
    jspec = jeff.efficientnet_spec("efficientnet_b0", 6)
    b = EFF_CONVERT["batch"]
    state = jax.device_get(j_recal(jspec, p, s, imgs, batch_size=b, num_batches=len(imgs) // b))
    jf = jqe.fold(jspec, p, state)
    obs = jqe.calibrate(jspec, jf, JBatches(imgs, labels, b), max_images=len(imgs))
    q = jax.device_get(jax.tree.map(jnp.asarray, jqe.convert_static_int8(
        jspec, jf, obs, image_size=(EFF_CONVERT["size"], EFF_CONVERT["size"]))))
    rec = conversion_record(jqe.serializable(q), obs)
    rec["provenance"] = {
        "made_by": "JAX_PLATFORMS=cpu python tests/test_torch_port_effnet_quant.py",
        "jax": jax.__version__, "config": EFF_CONVERT, "observer": "minmax",
        "param_sums": leaf_sums(p).tolist(), "image_sum": int(imgs.sum(dtype=np.int64)),
        "weights": "chip_smoke.effnet_params_from_seed(efficientnet_b0, seed), BN statistics "
                   "recalibrated on the images (train/bn_recal.recalibrate_bn), stored beside "
                   "this file",
    }
    with open(EFF_CONVERT_GOLDEN, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    np.savez_compressed(EFF_CONVERT_STATE, **flat_state_npz(state))
    print(f"wrote {EFF_CONVERT_GOLDEN} and {EFF_CONVERT_STATE}")
    for threads in (1, 2, 4, 8):  # the summation order moves with the thread count
        torch.set_num_threads(threads)
        recal = port_recal_effnet(spec, p, s, imgs, "cpu")
        tq, _, _ = port_convert_effnet(spec, p, state, imgs, labels, "cpu")
        report = compare_conversion(tqe.serializable(tq), rec, {"scale_rtol": 0.0}, _eff_tap_of)
        print(f"{threads} threads: recal deviation {state_deviation(recal, state)}, scales "
              f"{report['max_scale_rel']} ({report['worst_scale']}), leaves unequal "
              f"{report['leaves_unequal']}, zero points {report['zp_bad']}")


if __name__ == "__main__":
    write_convert_golden()
