"""The port's four stage CLIs on MobileNetV2 on the CPU
(``IEVM_PLATFORM=cpu``) on ``mobilenet_v2_050`` at 64x64 under DEBUG_MODE:
teacher -> KD (MobileNetV2 -> MobileNetV2) -> prune (l2, ratio 0.2,
round_to 8, one fine-tune epoch) -> quantize (the six methods the port's
stage 4 serves for the MBConv families) and ``choice=2`` of each, with the
structural checks of the JAX package's tests/test_pipeline_mbv2.py:
checkpoints in the JAX layout with ``__kind__ == "mobilenet_v2"``, pruned
widths multiples of 8, every method's summary row and an artifact that
``load_quantized`` restores (the fused executor too, from the shared
static-int8 file), and the static-int8 artifact read by the JAX package's
loader, whose jitted logits the port's plain path meets within the
unfused executor's limit of tests/test_torch_port_mbv2_quant.py (0.135 of
the logit scale: XLA's fused epilogues round a few values elsewhere)."""

import json

import jax.numpy as jnp
import numpy as np
import torch

from inference_efficient_vision_models_tpu.core import artifacts as jart
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu_torch.cli import kd, prune, quantize, teacher
from inference_efficient_vision_models_tpu_torch.serving import load_quantized

try:
    from tests.test_torch_port_fused_mbconv import assert_logits_close
    from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from tests.test_torch_port_resnet_float import flat
    from tests.test_torch_port_stage_cli import cpu_platform, short_timing  # noqa: F401
except ImportError:
    from test_torch_port_fused_mbconv import assert_logits_close
    from test_torch_port_prune import one_thread  # noqa: F401
    from test_torch_port_resnet_float import flat
    from test_torch_port_stage_cli import cpu_platform, short_timing  # noqa: F401

from chip_smoke import mbv2_params_from_seed

METHODS = ("static_int8", "static_int8_mixed", "dynamic_int8", "fp16", "bf16",
           "weight_only_int8")


def args(root, **over):
    kw = dict(artifacts_root=str(root), image_size=(64, 64), folds=(0,), pretrained=False,
              compute_dtype="float32", DEBUG_MODE=True)
    kw.update(over)
    return [f"{k}={v!r}" for k, v in kw.items()]


def test_mbv2_stage_chain(tmp_path, cpu_platform, short_timing):  # noqa: F811
    t1 = teacher.main(args(tmp_path, model_name="mobilenet_v2_050"))
    k1 = kd.main(args(tmp_path, teacher_model="mobilenet_v2_050",
                      student_model="mobilenet_v2_050", alpha=0.5, temperature=4.0))
    for rows, stage in ((t1, "teacher_training"), (k1, "knowledge_distillation")):
        assert len(rows) == 1 and np.isfinite(rows[0]["test_loss"])
        fold = str(tmp_path / stage / "test" / "fold_0")
        d = jart.load_spec_dict(fold, "best")
        assert d["__kind__"] == "mobilenet_v2"
        raw = jart.load_checkpoint_raw(fold, "best")  # the JAX reader
        ref_p, _ = mbv2_params_from_seed(jreg.spec_from_dict(d), 0)
        assert {k: v.shape for k, v in flat(raw["params"]).items()} == \
            {k: v.shape for k, v in flat(ref_p).items()}
    assert teacher.main(args(tmp_path, choice=2)) == t1

    p1 = prune.main(args(tmp_path, pruning_ratio=0.2, round_to=8, finetune_epochs=1))
    assert [r["phase"] for r in p1] == ["baseline", "pruned", "pruned+ft"]
    assert p1[1]["Params (M)"] < p1[0]["Params (M)"] * 0.9
    pfold = tmp_path / "pruning" / "test" / "fold_0"
    spec = json.loads((pfold / "model_best.spec.json").read_text())
    assert spec["__kind__"] == "mobilenet_v2"
    widths = [spec["stem_width"], spec["last_width"], *spec["stage_widths"],
              *(h for row in spec["hidden_widths"] for h in row)]
    assert all(w % 8 == 0 for w in widths)
    p2 = prune.main(args(tmp_path, choice=2))
    assert p2[0]["Params (M)"] == p1[2]["Params (M)"]

    q1 = quantize.main(args(tmp_path, methods=METHODS, calibration_images=32))
    assert [r["method"] for r in q1] == ["fp32", *METHODS]
    assert all(np.isfinite(r["Accuracy"]) and r["Size (MB)"] > 0 for r in q1)
    by = {r["method"]: r for r in q1}
    assert by["static_int8"]["Compression"] > 3.0
    assert by["static_int8_mixed"]["Size (MB)"] == by["static_int8"]["Size (MB)"]
    q2 = quantize.main(args(tmp_path, choice=2, methods=METHODS))
    for a, b in zip(q1[1:], q2):
        assert (b["method"], b["Accuracy"], b["Size (MB)"]) == \
            (a["method"], a["Accuracy"], a["Size (MB)"])

    qfold = str(tmp_path / "quantization" / "test" / "fold_0")
    x = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    for method in METHODS + ("static_int8_fused",):
        _, _, fn, pre = load_quantized(qfold, method, device="cpu")
        assert pre is None, method
        with torch.no_grad():
            out = fn(torch.from_numpy(x)).float().numpy()
        assert out.shape == (2, 6) and np.isfinite(out).all(), method
    from inference_efficient_vision_models_tpu.serving import load_quantized as j_load_q

    _, _, j_fn, j_pre = j_load_q(qfold, "static_int8")
    assert j_pre is None
    ref = np.asarray(j_fn(jnp.asarray(x)))
    _, model, _, _ = load_quantized(qfold, "static_int8", device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x), impl="plain").numpy()
    assert_logits_close(got, ref, 0.135)
