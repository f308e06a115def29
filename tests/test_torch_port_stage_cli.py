"""The port's stage CLIs on the CPU (``IEVM_PLATFORM=cpu``) at a tiny size:
teacher -> KD -> prune -> quantize and ``choice=2`` of each, checkpoints and
stage-4 artifacts crossing between the two packages in both directions,
resume from ``model_last``, and the device rules (no fallback to the CPU)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inference_efficient_vision_models_tpu.core import artifacts as jart
from inference_efficient_vision_models_tpu.data.pipeline import normalize_images as j_norm
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu.models import resnet as jr
from inference_efficient_vision_models_tpu.train import optim as jo
from inference_efficient_vision_models_tpu_torch.cli import common, kd, prune, quantize, teacher
from inference_efficient_vision_models_tpu_torch.core import artifacts as tart
from inference_efficient_vision_models_tpu_torch.core.config import TeacherConfig
from inference_efficient_vision_models_tpu_torch.core.log import get_logger
from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images
from inference_efficient_vision_models_tpu_torch.models import registry as treg
from inference_efficient_vision_models_tpu_torch.models import resnet as tr
from inference_efficient_vision_models_tpu_torch.train.loop import train_classifier

from chip_smoke import resnet_params_from_seed

try:
    from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from tests.test_torch_port_resnet_float import flat, tiny_spec_dict
except ImportError:
    from test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from test_torch_port_resnet_float import flat, tiny_spec_dict

TEACHER = tiny_spec_dict("bottleneck", 2)
STUDENT = tiny_spec_dict("basic")


def common_args(root, **over):
    kw = dict(artifacts_root=str(root), image_size=(32, 32), synthetic_size=48, epochs=2,
              folds=(0,), num_folds=3, pretrained=False, batch_size=8,
              compute_dtype="float32")
    kw.update(over)
    return [f"{k}={v!r}" for k, v in kw.items()]


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("IEVM_PLATFORM", "cpu")


@pytest.fixture
def short_timing(monkeypatch):
    """Stages 3-4 time every model they evaluate (latency and throughput
    loops budgeted at 15 s each); a CPU time means nothing, so the tests
    run each loop at its floor (no warm-up, 3 timed calls)."""
    from inference_efficient_vision_models_tpu_torch.metrics import profile

    def floor(fn, args, warmup, iters, budget_s):
        fn(*args)
        return 0, 3

    monkeypatch.setattr(profile, "_budgeted", floor)


def test_teacher_kd_and_choice2(tmp_path, cpu_platform):
    args = common_args(tmp_path)
    t1 = teacher.main(args + [f"model_name={TEACHER!r}"])
    k1 = kd.main(args + [f"student_model={STUDENT!r}", "alpha=0.5", "temperature=4.0",
                         "sp_weight=0.3"])
    t2 = teacher.main(args + ["choice=2"])
    k2 = kd.main(args + ["choice=2"])
    for first, second in ((t1, t2), (k1, k2)):
        assert len(first) == 1 and first[0]["fold"] == 0
        assert np.isfinite(first[0]["test_loss"])
        assert second == first  # the saved best model reproduces the fold's result
    for stage, name in (("teacher_training", "teacher_results"),
                        ("knowledge_distillation", "kd_results")):
        out = tmp_path / stage / "test"
        fold = out / "fold_0"
        for f in ("model_best.msgpack", "model_last.msgpack", "model_best.spec.json",
                  "training_log.json", "provenance.json"):
            assert (fold / f).exists(), f
        assert (out / f"{name}.csv").exists() and (out / "fold_idx_dict.json").exists()
        hist = json.loads((fold / "training_log.json").read_text())
        assert len(hist["train_loss"]) == 2 and hist["step_ms"] == [[], []]
    prov = json.loads((tmp_path / "knowledge_distillation" / "test" / "fold_0" /
                       "provenance.json").read_text())
    assert prov["stage"] == "knowledge_distillation" and prov["model_type"] == "student"
    assert prov["upstream"]["stage"] == "teacher_training"
    assert prov["data"]["synthetic_size"] == 48


def test_port_checkpoint_reads_in_jax(tmp_path, cpu_platform):
    """A port-written checkpoint, read by the JAX package's reader, gives the
    JAX ``resnet.apply`` the port's logits; its optimizer state and meta
    are what the JAX resume reads."""
    teacher.main(common_args(tmp_path, epochs=1) + [f"model_name={TEACHER!r}"])
    fold = str(tmp_path / "teacher_training" / "test" / "fold_0")
    raw = jart.load_checkpoint_raw(fold, "last")
    spec = jreg.spec_from_dict(jart.load_spec_dict(fold, "last"))
    x = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    ref, _ = jr.apply(spec, raw["params"], raw["state"], j_norm(jnp.asarray(x)))
    tspec, p, s = teacher.load_stage_model(fold, "last", "cpu")
    got, _ = tr.apply(tspec, p, s, normalize_images(torch.from_numpy(x)))
    ref = np.asarray(ref)
    assert np.abs(got.detach().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    opt = jo.AdamWState(**raw["opt"])  # as the JAX resume builds it
    assert int(opt.step) == 4 and int(raw["meta"]["epoch"]) == 0  # 32 train images / 8
    p2, opt2 = jo.adamw_update(raw["params"], jax.tree.map(jnp.zeros_like, raw["params"]),
                               opt, lr=1e-3)
    assert int(opt2.step) == 5
    assert 0.0 <= float(raw["meta"]["best_acc"]) <= 1.0


def test_jax_written_teacher_feeds_port_kd(tmp_path, cpu_platform):
    spec = jreg.spec_from_dict(TEACHER)
    p, s = resnet_params_from_seed(spec, 3)
    fold = str(tmp_path / "teacher_training" / "jx" / "fold_0")
    jart.save_checkpoint(fold, "best", p, s, spec)
    x = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    ref, _ = jr.apply(spec, p, s, j_norm(jnp.asarray(x)))
    tspec, tp, ts = teacher.load_stage_model(fold, "best", "cpu")
    got, _ = tr.apply(tspec, tp, ts, normalize_images(torch.from_numpy(x)))
    ref = np.asarray(ref)
    assert np.abs(got.detach().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    res = kd.main(common_args(tmp_path, epochs=1) + [
        "teacher_exp_name='jx'", f"student_model={STUDENT!r}"])
    assert len(res) == 1 and np.isfinite(res[0]["test_loss"])


QUANT_METHODS = ("static_int8", "dynamic_int8", "fp16", "bf16", "weight_only_int8")


def debug_args(root, **over):
    kw = dict(artifacts_root=str(root), image_size=(32, 32), folds=(0,), pretrained=False,
              compute_dtype="float32", DEBUG_MODE=True)
    kw.update(over)
    return [f"{k}={v!r}" for k, v in kw.items()]


def test_prune_and_quantize_clis_debug_mode(tmp_path, cpu_platform, short_timing):
    """Stages 1-4 under DEBUG_MODE (the JAX package's e2e test of its CLIs,
    tests/test_cli_e2e.py, at the port's tiny size), ``choice=2`` of stages
    3 and 4 reproducing their results, and the artifacts read by the JAX
    package's loaders."""
    from inference_efficient_vision_models_tpu.serving import load_quantized as j_load_q
    from inference_efficient_vision_models_tpu_torch.serving import load_quantized

    teacher.main(debug_args(tmp_path, model_name=TEACHER))
    kd.main(debug_args(tmp_path, student_model=STUDENT))
    p1 = prune.main(debug_args(tmp_path, pruning_ratio=0.3, round_to=8))
    assert [r["phase"] for r in p1] == ["baseline", "pruned", "pruned+ft"]
    assert p1[1]["Params (M)"] < p1[0]["Params (M)"] and p1[1]["MACs (G)"] < p1[0]["MACs (G)"]
    p2 = prune.main(debug_args(tmp_path, choice=2))
    for k in ("Accuracy", "MACs (G)", "Params (M)", "Size (MB)"):
        assert p2[0][k] == p1[2][k], k  # the saved model is the fine-tuned one
    pfold = tmp_path / "pruning" / "test" / "fold_0"
    spec = jreg.spec_from_dict(json.loads((pfold / "model_best.spec.json").read_text()))
    assert spec.stage_widths != tuple(STUDENT["stage_widths"])
    assert all(w % 8 == 0 for w in spec.stage_widths)
    raw = jart.load_checkpoint_raw(str(pfold), "best")  # the JAX reader
    ref_p, ref_s = resnet_params_from_seed(spec, 0)
    assert flat(raw["params"]).keys() == flat(ref_p).keys()
    for k, v in flat(raw["params"]).items():
        assert v.shape == flat(ref_p)[k].shape, k
    assert len(json.loads((pfold / "training_log.json").read_text())["train_loss"]) == 1

    q1 = quantize.main(debug_args(tmp_path, methods=QUANT_METHODS))
    assert [r["method"] for r in q1] == ["fp32", *QUANT_METHODS]
    assert all(np.isfinite(r["Accuracy"]) and r["Size (MB)"] > 0 for r in q1)
    q2 = quantize.main(debug_args(tmp_path, choice=2, methods=QUANT_METHODS))
    for a, b in zip(q1[1:], q2):
        assert (b["method"], b["Accuracy"], b["Size (MB)"]) == (a["method"], a["Accuracy"],
                                                                  a["Size (MB)"])
    qfold = str(tmp_path / "quantization" / "test" / "fold_0")
    prov = json.loads(open(os.path.join(qfold, "provenance.json")).read())
    assert prov["model_type"] == "pruned" and prov["stage_widths"] == list(spec.stage_widths)
    assert prov["upstream"]["stage"] == "pruning"
    assert prov["upstream"]["upstream"]["upstream"]["stage"] == "teacher_training"

    # every artifact restored by the JAX package's loader; static_int8 gives
    # the port's plain-path argmax (and logits within the serving limit)
    x = np.random.default_rng(4).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    for method in QUANT_METHODS:
        _, _, j_fn, j_pre = j_load_q(qfold, method)
        _, _, fn, pre = load_quantized(qfold, method, device="cpu")
        ref = np.asarray(j_fn(jnp.asarray(j_pre(x) if j_pre else x)), np.float32)
        with torch.no_grad():
            got = fn(torch.from_numpy(pre(x) if pre else x)).float().numpy()
        assert ref.shape == got.shape == (6, 6) and np.isfinite(ref).all(), method
        if method == "static_int8":
            np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))
            np.testing.assert_allclose(got, ref, rtol=0.02, atol=0.02)


def test_port_quantizes_a_jax_pruned_checkpoint(tmp_path, cpu_platform, short_timing):
    """A checkpoint pruned and written by the JAX package feeds the port's
    stage 4: the port reads it back to the JAX logits, and converts it."""
    from inference_efficient_vision_models_tpu.compress.prune import prune_model as j_prune

    spec0 = jreg.spec_from_dict(STUDENT)
    spec, p, s = j_prune(spec0, *resnet_params_from_seed(spec0, 3), ratio=0.25, round_to=8)
    fold = str(tmp_path / "pruning" / "jx" / "fold_0")
    jart.save_checkpoint(fold, "best", p, s, spec)
    x = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    ref = np.asarray(jr.apply(spec, p, s, j_norm(jnp.asarray(x)))[0])
    tspec, tp, ts = teacher.load_stage_model(fold, "best", "cpu")
    assert tspec.to_dict() == spec.to_dict()
    got = tr.apply(tspec, tp, ts, normalize_images(torch.from_numpy(x)))[0].detach().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    rows = quantize.main(common_args(tmp_path, epochs=1) + [
        "pruning_exp_name='jx'", "calibration_images=16", "methods=('static_int8',)"])
    assert [r["method"] for r in rows] == ["fp32", "static_int8"]


def test_unported_stage4_options_raise(tmp_path):
    from inference_efficient_vision_models_tpu_torch.core.config import QuantConfig

    for over in ({"qat_epochs": 1}, {"adaround_iters": 4}, {"sensitivity": True},
                 {"automix": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            QuantConfig(artifacts_root=str(tmp_path), **over)


def test_resume_continues_the_same_trajectory(tmp_path):
    """Two epochs in one run, and one epoch then a resumed second from
    ``model_last``, end in the same weights and optimizer state: the
    resumed epoch draws the same batch order."""
    log = get_logger(name="test_resume")
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (20, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 6, 20)
    train, val = (imgs[:14], labels[:14]), (imgs[14:], labels[14:])
    p0, s0 = resnet_params_from_seed(jreg.spec_from_dict(STUDENT), 0)
    tspec = treg.spec_from_dict(STUDENT)
    ends = {}
    for name, plan in (("straight", [2]), ("resumed", [1, 2])):
        for epochs in plan:
            cfg = TeacherConfig(artifacts_root=str(tmp_path / name), batch_size=4,
                                compute_dtype="float32", epochs=epochs, resume=epochs > 1)
            fold = cfg.fold_dir(0)
            p, s = tr.params_from_jax(p0, "cpu"), tr.params_from_jax(s0, "cpu")
            train_classifier(cfg, tspec, p, s, train, val, fold, log, device="cpu")
        ends[name] = tart.load_checkpoint_raw(fold, "last")
        ends[name]["hist"] = tart.load_training_log(fold)
    a, b = ends["straight"], ends["resumed"]
    for k in ("params", "state", "opt"):
        fa, fb = flat(a[k]), flat(b[k])
        assert fa.keys() == fb.keys()
        for leaf in fa:
            np.testing.assert_array_equal(fa[leaf], fb[leaf], err_msg=f"{k}{leaf}")
    assert int(b["meta"]["epoch"]) == 1
    for key in ("train_loss", "val_acc"):
        assert a["hist"][key] == b["hist"][key]


def test_no_cpu_fallback(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is reachable")
    monkeypatch.delenv("IEVM_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teacher.main(common_args(tmp_path) + [f"model_name={TEACHER!r}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.stage_device()
    monkeypatch.setenv("IEVM_PLATFORM", "cpu")
    assert common.stage_device() == torch.device("cpu")
    cfg = TeacherConfig(artifacts_root=str(tmp_path))
    spec = treg.spec_from_dict(STUDENT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_classifier(cfg, spec, {}, {}, (np.zeros((2, 8, 8, 3), np.uint8), [0, 1]),
                         (np.zeros((2, 8, 8, 3), np.uint8), [0, 1]), str(tmp_path), None)


def test_augment_and_real_images_are_not_ported(tmp_path, cpu_platform):
    with pytest.raises(NotImplementedError, match="augment"):
        teacher.main(common_args(tmp_path, augment=True) + [f"model_name={TEACHER!r}"])
    with pytest.raises(NotImplementedError, match="real-image decode"):
        teacher.main(common_args(tmp_path, synthetic_data=False))


def test_cli_kwargs_and_folds():
    assert common.parse_cli_kwargs(["choice=2", "folds=(0, 2)", "model_name=resnet50",
                                    "DEBUG_MODE=True"]) == {
        "choice": 2, "folds": (0, 2), "model_name": "resnet50", "DEBUG_MODE": True}
    with pytest.raises(SystemExit):
        common.parse_cli_kwargs(["oops"])

    class C:
        num_folds, folds = 3, None

    assert list(common.iter_folds(C)) == [0, 1, 2]
    C.folds = 2
    assert common.iter_folds(C) == [2]
    C.folds = (0, 5)
    with pytest.raises(ValueError):
        common.iter_folds(C)
