"""The port's float MobileNetV2 (``models/mobilenet.py``) and its torchvision
import against the JAX package's, on the CPU: the specs of every width name,
the parameter count and layout round trip, the forward of
``mobilenet_v2_050`` at 64x64 in eval and train mode with its BatchNorm
statistics, one fp32 CE step through each package's own ``make_train_step``
(loss, logits, gradient norms, BatchNorm statistics, AdamW moments and the
update), and
``from_torch_state_dict_mbv2`` on ``tests/torch_ref.py:mobilenet_v2``'s
state_dict (leaf for leaf), from weights that
``chip_smoke.mbv2_params_from_seed`` draws.

Tolerances (fp32, TF32 off): eval logits and BN statistics within 1e-5 of
their scale (measured 1.3e-6: the summation order only); train-mode
BatchNorm over few values per channel in the last stages (8 images of 2 x 2)
amplifies that order, so the train forward's logits and new statistics within
1.1e-4 of their scale, twice the 5.33e-5 the logits measure (the largest over
1-8 torch threads; the statistics measure 1.0e-5). The step is held to
``STEP_LIMITS``, twice what this CPU measures (the values beside them)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import (compare_train_step, mbv2_params_from_seed, port_train_step,
                        step_weights, train_step_batch, train_step_metrics)
from inference_efficient_vision_models_tpu.models import mobilenet as jmb
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu.models import torch_import as jti
from inference_efficient_vision_models_tpu_torch.models import mobilenet as tmb
from inference_efficient_vision_models_tpu_torch.models import registry as treg
from inference_efficient_vision_models_tpu_torch.models import torch_import as ti
from tests import torch_ref
from tests.test_torch_port_effnet_float import jitted_grads, rel
from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
from tests.test_torch_port_resnet_float import flat
from tests.test_torch_port_torch_import import assert_same_leaves

SIZE = 64
NAME = "mobilenet_v2_050"
TAU_EVAL, TAU_TRAIN = 1e-5, 1.1e-4
STEP = dict(teacher=NAME, student=NAME, seed=0, student_seed=1, batch=8, size=SIZE,
            image_seed=0, alpha=0.5, temperature=4.0, lr=1e-3, norm_floor=1e-4)
# twice the CPU's largest deviation over 1-8 torch threads (loss 1.19e-5,
# logits 3.61e-5 of the scale, a gradient leaf's norm 7.31e-3 over the floor,
# a first moment's 7.31e-3 and a second's 2.32e-2, a BN sum 8.48e-7 of its
# magnitudes: train-mode BatchNorm over 2 x 2 maps in the last stages is
# ill-conditioned); updates within 2 lr (at step 1 m / sqrt(v) is +-1, so a
# gradient near 0 may flip its update's sign; measured 2.00009 lr, under the
# parameters' fp32 rounding that compare_train_step adds)
STEP_LIMITS = {"loss_rel": 2.4e-5, "logits_over_scale": 7.3e-5, "grad_norm_rel": 0.0147,
               "bn_sum_over_abs_sum": 1.7e-6, "mu_norm_rel": 0.0147, "nu_norm_rel": 0.0465,
               "update_dev_over_lr": 2.0}


@pytest.fixture(scope="module")
def mb():
    spec = tmb.mobilenet_v2_spec(NAME, 6)
    return spec, jmb.mobilenet_v2_spec(NAME, 6), mbv2_params_from_seed(spec, 0)


@pytest.mark.parametrize("name", ["mobilenet_v2", "mobilenet_v2_050", "mobilenet_v2_075",
                                  "mobilenet_v2_140"])
def test_spec_equals_jax(name):
    spec = treg.make_spec(name, 6)
    assert spec.to_dict() == jreg.make_spec(name, 6).to_dict()
    assert spec.to_dict()["__kind__"] == "mobilenet_v2"
    assert treg.spec_from_dict(spec.to_dict()) == spec
    assert treg.spec_from_dict({k: v for k, v in spec.to_dict().items()
                                if k != "__kind__"}) == spec


def test_param_count_and_layout_round_trip(mb):
    spec, _, (p, s) = mb
    tp = tmb.params_from_jax(p, "cpu")
    assert tmb.param_count(tp) == jmb.param_count(p)
    assert tp["stage1"]["0"]["dw"]["w"].shape == (48, 1, 3, 3)
    for tree in (p, s):
        back = flat(tmb.params_to_jax(tmb.params_from_jax(tree, "cpu")))
        ref = flat(tree)
        assert back.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    # full width: create_model's tree has the JAX layout's leaves and shapes
    full, tp2, ts2 = treg.create_model("mobilenet_v2", 6, device="cpu")
    jp, js = mbv2_params_from_seed(full, 0)
    assert tmb.param_count(tp2) == jmb.param_count(jp) == 2_231_558
    assert {k: v.shape for k, v in flat(tmb.params_to_jax(tp2)).items()} == \
        {k: v.shape for k, v in flat(jp).items()}
    assert flat(tmb.params_to_jax(ts2)).keys() == flat(js).keys()


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(mb, train):
    spec, jspec, (p, s) = mb
    x = np.random.default_rng(1).standard_normal((8, SIZE, SIZE, 3)).astype(np.float32)
    ref, ref_s = jax.jit(lambda p, s, x: jmb.apply(jspec, p, s, x, train=train))(
        p, s, jnp.asarray(x))
    got, got_s = tmb.apply(spec, tmb.params_from_jax(p, "cpu"), tmb.params_from_jax(s, "cpu"),
                           torch.from_numpy(x), train=train)
    assert rel(got.numpy(), ref) <= (TAU_TRAIN if train else TAU_EVAL)
    fr, fg = flat(jax.device_get(ref_s)), flat(tmb.params_to_jax(got_s))
    assert fr.keys() == fg.keys()
    tau = TAU_TRAIN if train else TAU_EVAL
    for k in fr:
        assert np.abs(fg[k] - fr[k]).max() <= tau * max(np.abs(fr[k]).max(), 1.0), k
    if not train:
        feats, logits, _ = treg.features_and_logits(spec, tmb.params_from_jax(p, "cpu"),
                                                    tmb.params_from_jax(s, "cpu"),
                                                    torch.from_numpy(x))
        assert feats.shape == (8, spec.last_width)
        assert rel(logits.numpy(), ref) <= TAU_EVAL


def jax_ce_step_metrics(cfg):
    """The JAX package's fp32 CE step (teacher role) reduced as
    ``chip_smoke.train_step_metrics`` reduces it."""
    from inference_efficient_vision_models_tpu.train import optim as jo
    from inference_efficient_vision_models_tpu.train import steps as js

    b = train_step_batch(cfg)
    jb = tuple(jnp.asarray(a) for a in b)
    spec = jreg.make_spec(cfg["teacher"], 6)
    weights = step_weights(cfg)
    p, s = weights["teacher"]
    (loss, (ns, logits)), g = jitted_grads(spec)(p, s, None, None, *jb)
    step = js.make_train_step(spec, learning_rate=cfg["lr"], compute_dtype="float32")
    p2, _, opt, _ = jax.device_get(step(p, s, jo.adamw_init(p), jb))
    return weights, b, train_step_metrics("teacher", float(loss), np.asarray(logits),
                                          jax.device_get(g), jax.device_get(ns), p, p2, opt.mu,
                                          opt.nu, lr=cfg["lr"])


def test_ce_step_matches_jax():
    """One fp32 CE step through each package's ``make_train_step``."""
    weights, batch, ref = jax_ce_step_metrics(STEP)
    got = port_train_step(weights, batch, "cpu", STEP)
    dev = compare_train_step("teacher", got["teacher"], ref, STEP_LIMITS, STEP)
    assert dev["ok"], dev


def mbv2_state_dict(num_classes=1000, seed=0):
    """torch_ref's MobileNetV2 with seeded weights and nontrivial BN statistics."""
    torch.manual_seed(seed)
    tm = torch_ref.mobilenet_v2(num_classes=num_classes)
    with torch.no_grad():
        for mod in tm.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.normal_(0, 0.1)
                mod.running_mean.normal_(0, 0.2)
                mod.running_var.uniform_(0.5, 1.5)
    return tm.state_dict()


def test_torch_state_dict_converts_like_jax():
    sd = mbv2_state_dict()
    spec, jspec = treg.make_spec("mobilenet_v2", 1000), jreg.make_spec("mobilenet_v2", 1000)
    p, s = ti.from_torch_state_dict_mbv2(spec, sd)
    jp, js = jti.from_torch_state_dict_mbv2(jspec, sd)
    assert p["stage1"]["0"]["dw"]["w"].shape == (96, 1, 3, 3)  # the port's (C, 1, k, k)
    assert p["fc"]["w"].shape == (1280, 1000)  # (in, out)
    assert_same_leaves(treg.params_to_jax(spec, p), jp)
    assert_same_leaves(treg.params_to_jax(spec, s), js)


def test_pretrained_from_cache_keeps_fresh_head(tmp_path, monkeypatch):
    """``create_model(pretrained=True)`` converts a cached torchvision file
    (``$IEVM_WEIGHTS_DIR``) and keeps the fresh 6-class head; every other
    leaf equals the JAX package's ``load_pretrained`` of the same file."""
    monkeypatch.setenv("IEVM_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "no_hub"))
    torch.save(mbv2_state_dict(seed=1), tmp_path / "mobilenet_v2-b0353104.pth")
    spec, p, s = treg.create_model("mobilenet_v2", 6, pretrained=True, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    _, p_rand, _ = treg.create_model("mobilenet_v2", 6, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(p["fc"]["w"], p_rand["fc"]["w"])
    jp, js = jti.load_pretrained(jreg.make_spec("mobilenet_v2", 6), {"fc": None}, None)
    assert_same_leaves({k: v for k, v in treg.params_to_jax(spec, p).items() if k != "fc"},
                       {k: v for k, v in jp.items() if k != "fc"})
    assert_same_leaves(treg.params_to_jax(spec, s), js)
