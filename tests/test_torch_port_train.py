"""The port's training math against the JAX package's on the CPU, in fp32:
one CE step and one KD step (with and without the similarity-preserving
term) against ``make_train_step`` / ``make_kd_train_step`` (loss, gradients,
updated parameters, AdamW moments, BatchNorm statistics), AdamW over several
steps, the three learning-rate schedules, the losses, and ``evaluate``.

Running this file as a script rewrites ``testdata/resnet_train_step_jax.npz``,
the JAX package's fp32 CE step of a full-width ResNet50 and KD step of a
full-width ResNet18 against it, AdamW update included (batch 8 at
224 x 224, weights from ``chip_smoke.resnet_params_from_seed``), which
``chip_smoke.py`` holds the GPU against, and prints the port's deviation
from it on the CPU (the source of chip_smoke's limits; ~5 min):
``JAX_PLATFORMS=cpu python tests/test_torch_port_train.py``.
"""

import os
import sys

import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch

from chip_smoke import (TRAIN_GOLDEN, TRAIN_STEP, UPDATE_LEAF_MAX, _flat_sorted, leaf_sums,
                        resnet_params_from_seed, train_step_batch, train_step_metrics)
from inference_efficient_vision_models_tpu.data.pipeline import Batches as JBatches
from inference_efficient_vision_models_tpu.data.pipeline import normalize_images as j_norm
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu.models import resnet as jr
from inference_efficient_vision_models_tpu.train import losses as jl
from inference_efficient_vision_models_tpu.train import optim as jo
from inference_efficient_vision_models_tpu.train import steps as js
from inference_efficient_vision_models_tpu.train.loop import evaluate as j_evaluate
from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches as TBatches
from inference_efficient_vision_models_tpu_torch.models import registry as treg
from inference_efficient_vision_models_tpu_torch.models import resnet as tr
from inference_efficient_vision_models_tpu_torch.train import losses as tl
from inference_efficient_vision_models_tpu_torch.train import optim as to
from inference_efficient_vision_models_tpu_torch.train import steps as ts
from inference_efficient_vision_models_tpu_torch.train.loop import evaluate as t_evaluate

try:
    from tests.test_torch_port_resnet_float import flat, jax_model, tiny_spec_dict
except ImportError:  # run as a script
    from test_torch_port_resnet_float import flat, jax_model, tiny_spec_dict

LR = 1e-3
# |Δloss| <= LOSS_RTOL |loss|; per gradient leaf |Δg| <= GRAD_TAU max|g|; per
# moment leaf |Δ| <= MOMENT_TAU max|moment| for mu (0.1 g), twice that for nu
# (0.001 g², twice g's relative deviation); updated params within 2 lr (at
# step 1 m̂/√v̂ is ±1 for every nonzero gradient, so a gradient near 0 may flip)
LOSS_RTOL, GRAD_TAU, MOMENT_TAU = 1e-5, 1e-4, 1e-5


def batch_np(n=4, size=64, pad=1, seed=5, classes=6):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    labels = rng.integers(0, classes, n).astype(np.int32)
    mask = np.ones(n, np.float32)
    mask[n - pad:] = 0.0
    return imgs, labels, mask


def t_batch(b):
    imgs, labels, mask = b
    return (torch.from_numpy(imgs), torch.from_numpy(labels.astype(np.int64)),
            torch.from_numpy(mask))


def port_model(d, p, s):
    return treg.spec_from_dict(d), tr.params_from_jax(p, "cpu"), tr.params_from_jax(s, "cpu")


def assert_tree_close(got_tree, ref_tree, tau, what):
    """Per leaf: |got - ref| <= tau * max|ref| (the JAX layout on both sides)."""
    fg, fr = flat(got_tree), flat(ref_tree)
    assert fg.keys() == fr.keys()
    for k in fr:
        scale = max(float(np.abs(fr[k]).max()), 1e-30)
        assert np.abs(fg[k] - fr[k]).max() <= tau * scale, (what, k)


def grads_tree(params, grads):
    """The port's gradient list as a JAX-layout tree shaped like the params."""
    return tr.params_to_jax(to.tree_like(params, grads))


def jax_ce(spec, p, s, b):
    imgs, labels, mask = (jnp.asarray(a) for a in b)
    x = j_norm(imgs, jnp.float32)

    def loss_fn(pp):
        logits, ns = jreg.apply_model(spec, pp, s, x, train=True, compute_dtype=jnp.float32)
        return jl.cross_entropy(logits, labels, mask), (ns, logits)

    (loss, (ns, logits)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
    return float(loss), np.asarray(logits), jax.device_get(ns), jax.device_get(g)


def jax_kd(spec_s, spec_t, p, s, tp, tst, b, alpha=0.5, temperature=4.0, sp_weight=0.0):
    imgs, labels, mask = (jnp.asarray(a) for a in b)
    x = j_norm(imgs, jnp.float32)
    t_feats, t_logits, _ = jreg.features_and_logits(spec_t, tp, tst, x)

    def loss_fn(pp):  # as make_kd_train_step: the sp term only when its weight is > 0
        feats, logits, ns = jreg.features_and_logits(spec_s, pp, s, x, train=True)
        total, ce, kd = jl.kd_loss(logits, t_logits, labels, alpha=alpha,
                                   temperature=temperature, mask=mask)
        sp = jl.sp_kd_loss(feats, t_feats, mask) if sp_weight else jnp.float32(0.0)
        return total + sp_weight * sp, (ns, logits, ce, kd, sp)

    (loss, (ns, logits, ce, kd, sp)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
    return (float(loss), {"ce": float(ce), "kd": float(kd), "sp": float(sp)},
            np.asarray(logits), jax.device_get(ns), jax.device_get(g))


@pytest.fixture(scope="module")
def ce_case():
    d = tiny_spec_dict("basic")
    spec, p, s = jax_model(d, 7)
    return d, spec, p, s, batch_np()


def test_ce_loss_and_grads_match_jax(ce_case):
    d, spec, p, s, b = ce_case
    loss, logits, ns, g = jax_ce(spec, p, s, b)
    spec_t, tp, tst = port_model(d, p, s)
    t_loss, t_logits, t_ns, t_g = ts.ce_loss_and_grads(spec_t, tp, tst, t_batch(b),
                                                       compute_dtype="float32")
    assert abs(float(t_loss) - loss) <= LOSS_RTOL * abs(loss)
    assert np.abs(t_logits.numpy() - logits).max() <= 1e-5 * np.abs(logits).max()
    assert_tree_close(grads_tree(tp, t_g), g, GRAD_TAU, "grad")
    assert_tree_close(tr.params_to_jax(t_ns), ns, 1e-5, "bn stats")


def test_ce_step_matches_jax_train_step(ce_case):
    d, spec, p, s, b = ce_case
    step = js.make_train_step(spec, learning_rate=LR, compute_dtype="float32")
    opt = jo.adamw_init(p)
    p2, s2, opt2, m = jax.device_get(step(p, s, opt, tuple(jnp.asarray(a) for a in b)))
    spec_t, tp, tst = port_model(d, p, s)
    t_step = ts.make_train_step(spec_t, learning_rate=LR, compute_dtype="float32")
    tp2, ts2, topt, tm = t_step(tp, tst, to.adamw_init(tp), t_batch(b))
    assert abs(float(tm["loss"]) - float(m["loss"])) <= LOSS_RTOL * abs(float(m["loss"]))
    assert float(tm["acc"]) == float(m["acc"]) and float(tm["n"]) == float(m["n"]) == 3.0
    assert topt.step == int(opt2.step) == 1
    fg, fr = flat(tr.params_to_jax(tp2)), flat(p2)
    for k in fr:
        assert np.abs(fg[k] - fr[k]).max() <= 2 * LR, k
    assert_tree_close(tr.params_to_jax(topt.mu), opt2.mu, MOMENT_TAU, "mu")
    assert_tree_close(tr.params_to_jax(topt.nu), opt2.nu, 2 * MOMENT_TAU, "nu")
    assert_tree_close(tr.params_to_jax(ts2), s2, 1e-5, "bn stats")


@pytest.fixture(scope="module")
def kd_case():
    ds, dt = tiny_spec_dict("basic"), tiny_spec_dict("bottleneck", 2)
    spec_s, p, s = jax_model(ds, 8)
    spec_t, tp, tst = jax_model(dt, 9)
    return ds, dt, spec_s, spec_t, p, s, tp, tst


def kd_batch(sp_weight):
    # the JAX package's sp gradient is NaN when a batch has a padded row
    # (test_sp_kd_loss_padded_rows), so the sp case runs on a full batch
    return batch_np(seed=6, pad=0 if sp_weight else 1)


@pytest.mark.parametrize("sp_weight", [0.0, 0.7])
def test_kd_loss_and_grads_match_jax(kd_case, sp_weight):
    ds, dt, spec_s, spec_t, p, s, tp, tst = kd_case
    b = kd_batch(sp_weight)
    loss, parts, logits, ns, g = jax_kd(spec_s, spec_t, p, s, tp, tst, b, sp_weight=sp_weight)
    s_spec, sp_, ss_ = port_model(ds, p, s)
    t_spec, tp_, tst_ = port_model(dt, tp, tst)
    t_loss, t_parts, t_logits, t_ns, t_g = ts.kd_loss_and_grads(
        s_spec, t_spec, sp_, ss_, tp_, tst_, t_batch(b), alpha=0.5, temperature=4.0,
        sp_weight=sp_weight, compute_dtype="float32")
    assert abs(float(t_loss) - loss) <= LOSS_RTOL * abs(loss)
    for k in ("ce", "kd"):
        assert abs(float(t_parts[k]) - parts[k]) <= LOSS_RTOL * abs(parts[k])
    if sp_weight:
        assert abs(float(t_parts["sp"]) - parts["sp"]) <= 1e-4 * abs(parts["sp"])
    else:
        assert float(t_parts["sp"]) == 0.0
    assert np.abs(t_logits.numpy() - logits).max() <= 1e-5 * np.abs(logits).max()
    assert_tree_close(grads_tree(sp_, t_g), g, GRAD_TAU, "grad")
    assert_tree_close(tr.params_to_jax(t_ns), ns, 1e-5, "bn stats")


@pytest.mark.parametrize("sp_weight", [0.0, 0.7])
def test_kd_step_matches_jax_kd_train_step(kd_case, sp_weight):
    ds, dt, spec_s, spec_t, p, s, tp, tst = kd_case
    b = kd_batch(sp_weight)
    step = js.make_kd_train_step(spec_s, spec_t, alpha=0.5, temperature=4.0, learning_rate=LR,
                                 compute_dtype="float32", sp_weight=sp_weight)
    p2, s2, opt2, m = jax.device_get(step(p, s, jo.adamw_init(p), tp, tst,
                                          tuple(jnp.asarray(a) for a in b)))
    s_spec, sp_, ss_ = port_model(ds, p, s)
    t_spec, tp_, tst_ = port_model(dt, tp, tst)
    t_step = ts.make_kd_train_step(s_spec, t_spec, alpha=0.5, temperature=4.0, learning_rate=LR,
                                   compute_dtype="float32", sp_weight=sp_weight)
    sp2, ss2, topt, tm = t_step(sp_, ss_, to.adamw_init(sp_), tp_, tst_, t_batch(b))
    for k in ("loss", "ce", "kd"):
        assert abs(float(tm[k]) - float(m[k])) <= LOSS_RTOL * abs(float(m[k])), k
    assert float(tm["acc"]) == float(m["acc"]) and float(tm["n"]) == float(m["n"])
    fg, fr = flat(tr.params_to_jax(sp2)), flat(p2)
    for k in fr:
        assert np.abs(fg[k] - fr[k]).max() <= 2 * LR, k
    assert_tree_close(tr.params_to_jax(topt.mu), opt2.mu, MOMENT_TAU, "mu")
    assert_tree_close(tr.params_to_jax(topt.nu), opt2.nu, 2 * MOMENT_TAU, "nu")
    assert_tree_close(tr.params_to_jax(ss2), s2, 1e-5, "bn stats")


def test_sp_kd_loss_padded_rows():
    """A padded (masked) row makes the JAX package's ``sp_kd_loss`` gradient
    NaN (the norm of the zeroed Gram row is differentiated at 0); the port's
    gradient is the loss's: the JAX gradient without that row, and 0 on it."""
    rng = np.random.default_rng(2)
    f_s, f_t = rng.standard_normal((5, 7)), rng.standard_normal((5, 7))
    mask = np.array([1, 1, 1, 1, 0], np.float32)
    j_masked = jax.grad(jl.sp_kd_loss)(jnp.asarray(f_s, jnp.float32), jnp.asarray(f_t, jnp.float32),
                                       jnp.asarray(mask))
    assert np.isnan(np.asarray(j_masked)).all()
    ref = np.asarray(jax.grad(jl.sp_kd_loss)(jnp.asarray(f_s[:4], jnp.float32),
                                             jnp.asarray(f_t[:4], jnp.float32)))
    t_s = torch.tensor(f_s, dtype=torch.float32, requires_grad=True)
    loss = tl.sp_kd_loss(t_s, torch.tensor(f_t, dtype=torch.float32), torch.from_numpy(mask))
    (g,) = torch.autograd.grad(loss, [t_s])
    assert float(loss) == pytest.approx(float(jl.sp_kd_loss(jnp.asarray(f_s[:4], jnp.float32),
                                                           jnp.asarray(f_t[:4], jnp.float32))),
                                        rel=1e-6)
    np.testing.assert_allclose(g.numpy()[:4], ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(g.numpy()[4], 0.0)


def test_adamw_matches_jax_over_steps():
    """Five updates with given gradients (so the comparison is the optimizer
    alone), weight decay on every leaf, and a zero gradient."""
    rng = np.random.default_rng(0)
    p = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
         "b": rng.standard_normal(5).astype(np.float32)}
    tp = {"a": {"w": torch.from_numpy(p["a"]["w"].copy())}, "b": torch.from_numpy(p["b"].copy())}
    jopt, topt = jo.adamw_init(p), to.adamw_init(tp)
    for i in range(5):
        g = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
             "b": rng.standard_normal(5).astype(np.float32) * (i % 2)}
        p, jopt = jo.adamw_update(p, g, jopt, lr=0.01)
        tp, topt = to.adamw_update(tp, [torch.from_numpy(g["a"]["w"]), torch.from_numpy(g["b"])],
                                   topt, lr=0.01)
    for got, ref in ((tp, p), (topt.mu, jopt.mu), (topt.nu, jopt.nu)):
        fg, fr = flat(got), flat(ref)
        for k in fr:
            np.testing.assert_allclose(fg[k], fr[k], rtol=2e-6, atol=1e-7, err_msg=k)
    assert topt.step == int(jopt.step) == 5


@pytest.mark.parametrize("kind,warmup,min_fraction", [("constant", 0, 0.0), ("cosine", 0, 0.1),
                                                      ("warmup_cosine", 7, 0.0),
                                                      ("warmup_cosine", 3, 0.25)])
def test_lr_schedules_match_jax(kind, warmup, min_fraction):
    kw = dict(warmup_steps=warmup, min_fraction=min_fraction)
    got = to.make_lr_schedule(kind, 3e-4, 40, **kw)
    ref = jo.make_lr_schedule(kind, 3e-4, 40, **kw)
    for step in range(0, 45):  # JAX rounds in fp32: 1 + cos(pi prog) near the end cancels
        assert got(step) == pytest.approx(float(ref(jnp.int32(step))), rel=1e-6, abs=1e-6 * 3e-4)
    with pytest.raises(ValueError):
        to.make_lr_schedule("linear", 1e-3, 10)


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    s, t = rng.standard_normal((6, 5)) * 3, rng.standard_normal((6, 5)) * 3
    labels = rng.integers(0, 5, 6)
    mask = np.array([1, 1, 0, 1, 1, 0], np.float32)
    f_s, f_t = rng.standard_normal((6, 7)), rng.standard_normal((6, 7))
    T = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
         dict(s=s, t=t, mask=mask, f_s=f_s, f_t=f_t).items()}
    J = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in
         dict(s=s, t=t, mask=mask, f_s=f_s, f_t=f_t).items()}
    lt, lj = torch.from_numpy(labels), jnp.asarray(labels)
    for m in (None, "mask"):
        mt, mj = (T[m], J[m]) if m else (None, None)
        pairs = [(tl.cross_entropy(T["s"], lt, mt), jl.cross_entropy(J["s"], lj, mj)),
                 (tl.masked_accuracy(T["s"], lt, mt), jl.masked_accuracy(J["s"], lj, mj)),
                 (tl.sp_kd_loss(T["f_s"], T["f_t"], mt), jl.sp_kd_loss(J["f_s"], J["f_t"], mj))]
        pairs += list(zip(tl.kd_loss(T["s"], T["t"], lt, alpha=0.3, temperature=2.0, mask=mt),
                          jl.kd_loss(J["s"], J["t"], lj, alpha=0.3, temperature=2.0, mask=mj)))
        for got, ref in pairs:
            assert float(got) == pytest.approx(float(ref), rel=1e-6, abs=1e-7)


def test_evaluate_sums_match_jax():
    d = tiny_spec_dict("bottleneck")
    spec, p, s = jax_model(d, 4)
    imgs, labels, _ = batch_np(n=11, size=48, pad=0, seed=9)
    ref = j_evaluate(js.make_eval_step(spec, compute_dtype="float32"), p, s,
                     JBatches(imgs, labels, 4))
    spec_t, tp, tst = port_model(d, p, s)
    got = t_evaluate(ts.make_eval_step(spec_t, compute_dtype="float32"), tp, tst,
                     TBatches(imgs, labels, 4, "cpu"))
    assert got["n"] == ref["n"] == 11.0
    assert got["acc"] == ref["acc"]
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)


def test_train_step_golden_weights_are_current():
    """The committed golden was made from the weights and batch that
    ``resnet_params_from_seed`` / ``train_step_batch`` give today."""
    golden = np.load(TRAIN_GOLDEN)
    for role in ("teacher", "student"):
        spec = jreg.make_spec(TRAIN_STEP[role], 6)
        p, s = resnet_params_from_seed(spec, TRAIN_STEP["seed"])
        np.testing.assert_array_equal(leaf_sums(p), golden[f"{role}_param_sums"])
        np.testing.assert_array_equal(leaf_sums(s), golden[f"{role}_state_sums"])
        kept = [k for k, v in _flat_sorted(p).items() if v.size <= UPDATE_LEAF_MAX]
        assert list(golden[f"{role}_update_names"]) == kept
    imgs, labels, mask = train_step_batch()
    assert int(golden["image_sum"]) == int(imgs.sum(dtype=np.int64))
    np.testing.assert_array_equal(golden["labels"], labels)


def write_train_step_golden() -> None:
    """The JAX package's fp32 CE step (ResNet50) and KD step (ResNet18 against
    that ResNet50 in eval mode) on the CPU, reduced to what chip_smoke.py
    compares: loss, logits, gradients and BN statistics from the loss's
    value and gradient, the update and moments from one call of
    ``make_train_step`` / ``make_kd_train_step``; then the port's deviation
    from it on the CPU."""
    imgs, labels, mask = train_step_batch()
    b = (jnp.asarray(imgs), jnp.asarray(labels), jnp.asarray(mask))
    specs = {r: jreg.make_spec(TRAIN_STEP[r], 6) for r in ("teacher", "student")}
    weights = {r: resnet_params_from_seed(specs[r], TRAIN_STEP["seed"]) for r in specs}
    out = {"labels": labels, "image_sum": np.int64(imgs.sum(dtype=np.int64))}
    for r in specs:
        out[f"{r}_param_sums"] = leaf_sums(weights[r][0])
        out[f"{r}_state_sums"] = leaf_sums(weights[r][1])
    kd = dict(alpha=TRAIN_STEP["alpha"], temperature=TRAIN_STEP["temperature"])
    p, s = weights["teacher"]
    loss, logits, ns, g = jax_ce(specs["teacher"], p, s, b)
    step = js.make_train_step(specs["teacher"], learning_rate=TRAIN_STEP["lr"],
                              compute_dtype="float32")
    p2, _, opt, _ = jax.device_get(step(p, s, jo.adamw_init(p), b))
    out.update(train_step_metrics("teacher", loss, logits, g, ns, p, p2, opt.mu, opt.nu))
    p, s = weights["student"]
    loss, _, logits, ns, g = jax_kd(specs["student"], specs["teacher"], p, s,
                                    *weights["teacher"], b, **kd)
    step = js.make_kd_train_step(specs["student"], specs["teacher"],
                                 learning_rate=TRAIN_STEP["lr"], compute_dtype="float32", **kd)
    p2, _, opt, _ = jax.device_get(step(p, s, jo.adamw_init(p), *weights["teacher"], b))
    out.update(train_step_metrics("student", loss, logits, g, ns, p, p2, opt.mu, opt.nu))
    np.savez_compressed(TRAIN_GOLDEN, **out)
    print(f"wrote {TRAIN_GOLDEN}")

    from chip_smoke import compare_train_step, port_train_step

    got = port_train_step(weights, train_step_batch(), "cpu")
    for r in specs:
        print(r, compare_train_step(r, got[r], out, None))


if __name__ == "__main__":
    write_train_step_golden()
