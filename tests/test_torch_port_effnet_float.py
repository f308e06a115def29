"""The port's float EfficientNet-B0 (``models/efficientnet.py``) against the
JAX package's on the CPU, at full width and 64x64, from weights that
``chip_smoke.effnet_params_from_seed`` draws: the forward in eval and train
mode with its BatchNorm statistics, the parameter count, the layout
round trip, and one CE step and one KD step (loss, gradients, BatchNorm
statistics).

Tolerances (fp32, TF32 off): the logits and BN statistics within 1e-5 of
their scale (eval mode measures ~1e-6: the summation order only); train-mode
BatchNorm over a few values per channel in the last stages (8 images of
2 x 2) amplifies that order, so the train forward and the step compare
the logits within 5e-5 of their scale, each gradient leaf within 1e-4 of
its largest magnitude, as tests/test_torch_port_train.py holds ResNet.

Running this file as a script rewrites ``testdata/effnet_train_step_jax.npz``
(the JAX package's CE and KD steps, AdamW update included, at batch 8 and
64x64, which ``chip_smoke.py`` holds the GPU against) and prints the port's
deviation from it on the CPU (~1 min):
``JAX_PLATFORMS=cpu python tests/test_torch_port_effnet_float.py``."""

import os
import sys

import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch

from chip_smoke import effnet_params_from_seed
from inference_efficient_vision_models_tpu.models import efficientnet as jeff
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu_torch.models import efficientnet as teff
from inference_efficient_vision_models_tpu_torch.models import registry as treg
from inference_efficient_vision_models_tpu_torch.train import optim as to
from inference_efficient_vision_models_tpu_torch.train import steps as ts

try:
    from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from tests.test_torch_port_resnet_float import flat
    from tests.test_torch_port_train import batch_np, t_batch
except ImportError:  # run as a script
    from test_torch_port_prune import one_thread  # noqa: F401
    from test_torch_port_resnet_float import flat
    from test_torch_port_train import batch_np, t_batch

SIZE = 64
TAU_EVAL, TAU_TRAIN, GRAD_TAU = 1e-5, 5e-5, 1e-4


@pytest.fixture(scope="module")
def b0():
    spec = teff.efficientnet_spec("efficientnet_b0", 6)
    return spec, jeff.efficientnet_spec("efficientnet_b0", 6), effnet_params_from_seed(spec, 0)


def rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


def test_param_count_and_layout_round_trip(b0):
    spec, jspec, (p, s) = b0
    tp = teff.params_from_jax(p, "cpu")
    assert teff.param_count(tp) == jeff.param_count(p) == 4_015_234
    assert tp["stage1"]["0"]["dw"]["w"].shape == (96, 1, 3, 3)
    assert tp["stage1"]["0"]["se_reduce"]["w"].shape == (96, 4)
    for tree in (p, s):
        back = flat(teff.params_to_jax(teff.params_from_jax(tree, "cpu")))
        ref = flat(tree)
        assert back.keys() == ref.keys()
        for k in ref:
            assert back[k].dtype == np.float32
            np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    t_spec, tp2, ts2 = treg.create_model("efficientnet_b0", 6, device="cpu")
    assert t_spec == spec
    assert {k: v.shape for k, v in flat(teff.params_to_jax(tp2)).items()} == \
        {k: v.shape for k, v in flat(p).items()}
    assert flat(teff.params_to_jax(ts2)).keys() == flat(s).keys()


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(b0, train):
    spec, jspec, (p, s) = b0
    x = np.random.default_rng(1).standard_normal((8, SIZE, SIZE, 3)).astype(np.float32)
    j_apply = jax.jit(lambda p, s, x: jeff.apply(jspec, p, s, x, train=train))
    ref, ref_s = j_apply(p, s, jnp.asarray(x))
    got, got_s = teff.apply(spec, teff.params_from_jax(p, "cpu"), teff.params_from_jax(s, "cpu"),
                            torch.from_numpy(x), train=train)
    assert rel(got.numpy(), ref) <= (TAU_TRAIN if train else TAU_EVAL)
    fr, fg = flat(jax.device_get(ref_s)), flat(teff.params_to_jax(got_s))
    assert fr.keys() == fg.keys()
    for k in fr:
        assert np.abs(fg[k] - fr[k]).max() <= TAU_EVAL * max(np.abs(fr[k]).max(), 1.0), k
    if not train:
        feats, logits, _ = treg.features_and_logits(spec, teff.params_from_jax(p, "cpu"),
                                                    teff.params_from_jax(s, "cpu"),
                                                    torch.from_numpy(x))
        assert feats.shape == (8, 1280)
        assert rel(logits.numpy(), ref) <= TAU_EVAL


def jitted_grads(spec_s, spec_t=None, kd=None):
    """The JAX package's CE (``spec_t`` None) or KD loss and gradient, jitted
    (op by op, B0's backward takes a minute on the CPU): as make_train_step /
    make_kd_train_step compute them."""
    from inference_efficient_vision_models_tpu.data.pipeline import normalize_images as j_norm
    from inference_efficient_vision_models_tpu.train import losses as jl

    @jax.jit
    def f(pp, s, tp, tst, imgs, labels, mask):
        x = j_norm(imgs, jnp.float32)
        t_logits = None if spec_t is None else jreg.apply_model(spec_t, tp, tst, x)[0]

        def loss_fn(pp):
            logits, ns = jreg.apply_model(spec_s, pp, s, x, train=True, compute_dtype=jnp.float32)
            if spec_t is None:
                return jl.cross_entropy(logits, labels, mask), (ns, logits)
            return jl.kd_loss(logits, t_logits, labels, mask=mask, **kd)[0], (ns, logits)

        return jax.value_and_grad(loss_fn, has_aux=True)(pp)

    return f


def assert_grads_close(got_tree, ref_tree):
    """Each leaf within GRAD_TAU of its largest magnitude, plus 1e-6 of the
    whole gradient's largest: a BatchNorm bias gradient in an early block is
    a sum that cancels to ~1e-7 of the scale, and the two sides' fp32
    summation orders leave that much in it."""
    fg, fr = flat(got_tree), flat(ref_tree)
    assert fg.keys() == fr.keys()
    top = max(np.abs(v).max() for v in fr.values())
    for k in fr:
        assert np.abs(fg[k] - fr[k]).max() <= GRAD_TAU * np.abs(fr[k]).max() + 1e-6 * top, k


def assert_stats_close(got_state, ref_state):
    fr, fg = flat(jax.device_get(ref_state)), flat(teff.params_to_jax(got_state))
    assert fr.keys() == fg.keys()
    for k in fr:
        assert np.abs(fg[k] - fr[k]).max() <= TAU_EVAL * max(np.abs(fr[k]).max(), 1.0), k


def test_ce_and_kd_steps_match_jax(b0):
    """One fp32 CE step (teacher role) and one KD step (a B0 student from
    another seed against the teacher in eval mode): loss, logits, gradients,
    BN statistics."""
    spec, jspec, (p, s) = b0
    ps, ss = effnet_params_from_seed(spec, 1)
    b = batch_np(n=8, size=SIZE, pad=1)
    jb = tuple(jnp.asarray(a) for a in b)
    tb = t_batch(b)
    tp, tst = teff.params_from_jax(p, "cpu"), teff.params_from_jax(s, "cpu")

    (loss, (ns, logits)), g = jitted_grads(jspec)(p, s, None, None, *jb)
    t_loss, t_logits, t_ns, t_g = ts.ce_loss_and_grads(spec, tp, tst, tb, compute_dtype="float32")
    assert float(t_loss) == pytest.approx(float(loss), rel=1e-5)
    assert rel(t_logits.numpy(), logits) <= TAU_TRAIN
    assert_grads_close(teff.params_to_jax(to.tree_like(tp, t_g)), jax.device_get(g))
    assert_stats_close(t_ns, ns)

    kd = dict(alpha=0.5, temperature=4.0)
    (loss, (ns, logits)), g = jitted_grads(jspec, jspec, kd)(ps, ss, p, s, *jb)
    sp_, ss_ = teff.params_from_jax(ps, "cpu"), teff.params_from_jax(ss, "cpu")
    t_loss, _, t_logits, t_ns, t_g = ts.kd_loss_and_grads(spec, spec, sp_, ss_, tp, tst, tb,
                                                         compute_dtype="float32", **kd)
    assert float(t_loss) == pytest.approx(float(loss), rel=1e-5)
    assert rel(t_logits.numpy(), logits) <= TAU_TRAIN
    assert_grads_close(teff.params_to_jax(to.tree_like(sp_, t_g)), jax.device_get(g))
    assert_stats_close(t_ns, ns)


def test_train_step_golden_is_current():
    """The committed golden was made from the weights and batch that
    ``chip_smoke.step_weights`` / ``train_step_batch`` give today."""
    from chip_smoke import (EFF_TRAIN_GOLDEN, EFF_TRAIN_STEP, UPDATE_LEAF_MAX, _flat_sorted,
                            leaf_sums, step_weights, train_step_batch)

    golden = np.load(EFF_TRAIN_GOLDEN)
    for role, (p, s) in step_weights(EFF_TRAIN_STEP).items():
        np.testing.assert_array_equal(leaf_sums(p), golden[f"{role}_param_sums"])
        np.testing.assert_array_equal(leaf_sums(s), golden[f"{role}_state_sums"])
        kept = [k for k, v in _flat_sorted(p).items() if v.size <= UPDATE_LEAF_MAX]
        assert list(golden[f"{role}_update_names"]) == kept
    imgs, labels, _ = train_step_batch(EFF_TRAIN_STEP)
    assert int(golden["image_sum"]) == int(imgs.sum(dtype=np.int64))
    np.testing.assert_array_equal(golden["labels"], labels)


def write_train_step_golden() -> None:
    """The JAX package's fp32 CE step (B0, teacher role) and KD step (a B0
    student against that teacher in eval mode) on the CPU at batch 8, 64x64,
    reduced to what chip_smoke.py compares (``train_step_metrics``); then the
    port's deviation from it on the CPU, the source of
    ``chip_smoke.EFF_TRAIN_LIMITS``."""
    from chip_smoke import (EFF_TRAIN_GOLDEN, EFF_TRAIN_STEP, compare_train_step, leaf_sums,
                            port_train_step, step_weights, train_step_batch, train_step_metrics)
    from inference_efficient_vision_models_tpu.train import optim as jo
    from inference_efficient_vision_models_tpu.train import steps as js

    cfg = EFF_TRAIN_STEP
    imgs, labels, mask = b = train_step_batch(cfg)
    jb = tuple(jnp.asarray(a) for a in b)
    spec = jreg.make_spec(cfg["teacher"], 6)
    weights = step_weights(cfg)
    out = {"labels": labels, "image_sum": np.int64(imgs.sum(dtype=np.int64))}
    for r in weights:
        out[f"{r}_param_sums"] = leaf_sums(weights[r][0])
        out[f"{r}_state_sums"] = leaf_sums(weights[r][1])
    kd = dict(alpha=cfg["alpha"], temperature=cfg["temperature"])
    p, s = weights["teacher"]
    (loss, (ns, logits)), g = jitted_grads(spec)(p, s, None, None, *jb)
    step = js.make_train_step(spec, learning_rate=cfg["lr"], compute_dtype="float32")
    p2, _, opt, _ = jax.device_get(step(p, s, jo.adamw_init(p), jb))
    out.update(train_step_metrics("teacher", float(loss), np.asarray(logits), jax.device_get(g),
                                  jax.device_get(ns), p, p2, opt.mu, opt.nu, lr=cfg["lr"]))
    p, s = weights["student"]
    (loss, (ns, logits)), g = jitted_grads(spec, spec, kd)(p, s, *weights["teacher"], *jb)
    step = js.make_kd_train_step(spec, spec, learning_rate=cfg["lr"], compute_dtype="float32",
                                 **kd)
    p2, _, opt, _ = jax.device_get(step(p, s, jo.adamw_init(p), *weights["teacher"], jb))
    out.update(train_step_metrics("student", float(loss), np.asarray(logits), jax.device_get(g),
                                  jax.device_get(ns), p, p2, opt.mu, opt.nu, lr=cfg["lr"]))
    np.savez_compressed(EFF_TRAIN_GOLDEN, **out)
    print(f"wrote {EFF_TRAIN_GOLDEN}")
    worst = {}
    for threads in (1, 2, 4, 8):  # the summation order moves with the thread count
        torch.set_num_threads(threads)
        got = port_train_step(weights, b, "cpu", cfg)
        for r in weights:
            for k, v in compare_train_step(r, got[r], out, None, cfg).items():
                worst[k] = max(worst.get(k, 0.0), v)
    print("the port's CPU deviation, the largest over 1-8 threads:", worst)


if __name__ == "__main__":
    write_train_step_golden()
