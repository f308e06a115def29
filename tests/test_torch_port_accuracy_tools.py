"""The port's stage-4 accuracy tools against the JAX package's, on the CPU at
a small size: the fake quantizers (values and straight-through gradients,
values exactly on the clip's edges included), the fake-quantized weight
trees (int8 per channel and the W4A16 grid, their axes and int4 groups),
two steps of ``qat_finetune`` and of ``w4_qat_finetune`` (bits 4 and 8), and
``adaround_refine`` with its conversion contract. The nets are a seeded
one-block-a-stage ResNet (widths 16/32, 32x32 images, batch 8).

QAT is held against the JAX package run op by op (``jax.disable_jit``):
under ``jax.jit`` XLA multiplies by the reciprocal of 127.5 where the code
divides, so its weight scales sit one ulp from the conversion's and a
weight at a rounding edge moves a quantum; op by op, the JAX arithmetic is
the conversion's, which the port follows.

Running this file as a script rewrites ``testdata/accuracy_tools_jax.npz``
(``chip_smoke.TOOLS_STEP``: the JAX package op by op on a narrow ResNet at
64x64, batch 8: one QAT step, one W4 QAT step, four AdaRound iterations)
and prints the port's CPU deviation from it with oneDNN on and off at 1 to
8 torch threads, the source of ``chip_smoke.TOOLS_LIMITS`` (~3 min):
``JAX_PLATFORMS=cpu python tests/test_torch_port_accuracy_tools.py``.
"""

import functools
import os
import sys

import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch

from chip_smoke import (TOOLS_GOLDEN, TOOLS_LIMITS, TOOLS_STEP, _flat_sorted, adaround_contract,
                        compare_tool_steps, leaf_sums, learned_ints, params_from_seed,
                        port_tool_steps,
                        tool_step_metrics, tools_inputs)
from inference_efficient_vision_models_tpu.compress.quant import adaround as jada
from inference_efficient_vision_models_tpu.compress.quant import qat as jqat
from inference_efficient_vision_models_tpu.compress.quant import qresnet as jq
from inference_efficient_vision_models_tpu.data.pipeline import Batches as JBatches
from inference_efficient_vision_models_tpu.data.pipeline import normalize_images as j_norm
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu.train.losses import cross_entropy as j_ce
from inference_efficient_vision_models_tpu_torch.compress.quant import adaround as tada
from inference_efficient_vision_models_tpu_torch.compress.quant import qat as tqat
from inference_efficient_vision_models_tpu_torch.compress.quant import qresnet as tq
from inference_efficient_vision_models_tpu_torch.compress.quant import wo4 as two4
from inference_efficient_vision_models_tpu_torch.compress.quant.observers import (
    minmax_qparams_affine, quantize_weight_per_channel)
from inference_efficient_vision_models_tpu_torch.core.config import QuantConfig
from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches
from inference_efficient_vision_models_tpu_torch.models import registry as treg

try:
    from tests.test_torch_port_prune import one_thread  # noqa: F401
except ImportError:  # run as a script
    from test_torch_port_prune import one_thread  # noqa: F401

SPEC = dict(name="tiny_tools", block="basic", depths=[1, 1], stage_widths=[16, 32],
            inner_widths=[[[16]], [[32]]], stem_width=16, num_classes=6, groups=1)
LR = 1e-3
# one step's loss and each gradient leaf's norm, port vs JAX op by op: fp32
# summation order only (the CPU measures <= 3e-7); the updated parameters
# within 2 lr of JAX's after two steps (a sign flip of a near-zero gradient
# at one step moves a parameter by 2 lr; the CPU measures 4e-5 lr)
LOSS_RTOL, GRAD_RTOL, UPDATE_TOL = 1e-5, 1e-4, 2.0
# learned integers that differ from JAX's (jitted): the CPU measures 0 of
# 21,638; an integer flips only where h(v) ends within the two sides'
# rounding of 0.5
ADA_MISMATCH = 1e-3


@functools.lru_cache(maxsize=None)
def setup():
    """(JAX spec, port spec, the folded seeded model (JAX layout, numpy), 16
    images and labels, the port's observers on them)."""
    jspec = jreg.spec_from_dict(SPEC)
    tspec = treg.spec_from_dict(jspec.to_dict())
    folded = tq.fold(tspec, *params_from_seed(tspec, 0))
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    labels = (np.arange(16) % 6).astype(np.int32)
    obs = tq.calibrate(tspec, tq.place_folded(folded, "cpu"), Batches(imgs, labels, 8, "cpu"),
                       max_images=16)
    return jspec, tspec, folded, (imgs, labels), obs


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def jgrad(f, x):
    return np.asarray(jax.grad(lambda v: jnp.sum(f(v)))(jnp.asarray(x)))


def tgrad(f, x):
    t = torch.from_numpy(np.array(x)).requires_grad_(True)
    f(t).sum().backward()
    return t.grad.numpy()


# --------------------------------------------------------------------------
# the fake quantizers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lo_hi", [(-3.0, 5.0), (0.0, 6.0)], ids=["affine", "relu"])
def test_fake_quant_act_values_and_edge_gradients(lo_hi):
    """Values equal JAX's; the STE gradient is 1 inside the window, 1/2 on
    either edge (``jnp.clip``'s tie), 0 outside, as JAX's (``torch.clamp``
    alone would give 1 on the edges)."""
    scale, zp = minmax_qparams_affine(*lo_hi)
    lo, hi = (float(np.float32((q - zp) * scale)) for q in (0, 255))
    x = np.concatenate([[lo, hi, lo - 1.0, hi + 1.0, lo, hi],
                        np.random.default_rng(0).normal(1.0, 2.5, 250)]).astype(np.float32)
    got = tqat.fake_quant_act(torch.from_numpy(x), scale, zp).numpy()
    want = np.asarray(jqat.fake_quant_act(jnp.asarray(x), scale, zp))
    assert np.array_equal(got, want)
    g_t = tgrad(lambda v: tqat.fake_quant_act(v, scale, zp), x)
    g_j = jgrad(lambda v: jqat.fake_quant_act(v, scale, zp), x)
    assert np.array_equal(g_t, g_j)
    assert list(g_t[:4]) == [0.5, 0.5, 0.0, 0.0]


def test_clip_and_rectified_sigmoid_gradients_match_jax():
    """``clip_jax`` against ``jnp.clip`` at and around both edges, and the
    rectified sigmoid (values and gradient) against JAX's."""
    x = np.array([-1.0, 0.0, 0.25, 1.0, 2.0, 1.0 - 2**-24, 2**-30], np.float32)
    assert np.array_equal(tgrad(lambda v: tqat.clip_jax(v, 0.0, 1.0), x),
                          jgrad(lambda v: jnp.clip(v, 0.0, 1.0), x))
    v = np.concatenate([[-50.0, 50.0, 0.0], np.random.default_rng(1).normal(0, 3, 200)])
    v = v.astype(np.float32)
    assert np.array_equal(tada.rectified_sigmoid(torch.from_numpy(v)).numpy(),
                          np.asarray(jada.rectified_sigmoid(jnp.asarray(v))))
    np.testing.assert_allclose(tgrad(tada.rectified_sigmoid, v),
                               jgrad(jada.rectified_sigmoid, v), rtol=1e-6, atol=1e-7)
    frac = np.linspace(0.02, 0.98, 25).astype(np.float32)
    assert np.array_equal(tada.init_v(frac), jada.init_v(frac))


def weight_tree():
    """A JAX-layout tree with a conv, a depthwise conv, a dense, a dense with
    an odd output count and a short-reduction conv (the W4 policy keeps the
    last three int8)."""
    rng = np.random.default_rng(3)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    return {"conv": {"w": w(3, 3, 8, 16), "b": w(16)}, "dw": {"w": w(3, 3, 1, 16)},
            "fc": {"w": w(48, 6), "b": w(6)}, "odd": {"w": w(64, 5)}, "stem": {"w": w(1, 1, 3, 8)}}


def test_fake_quant_weights_match_jax_and_the_conversions():
    """``fq_weights`` / ``fq_weights_w4`` equal JAX's op by op, leaf for leaf,
    with all-ones gradients; each int4 leaf equals ``wo4``'s dequantized
    conversion (the same groups of the JAX layout) and each int8 leaf the
    per-channel conversion. Placed in the port's layout (OIHW), each conv's
    values lie on its output channel's grid."""
    tree = weight_tree()
    jt = jax.tree.map(jnp.asarray, tree)
    for tfq, jfq in ((tqat.fq_weights, jqat.fq_weights), (tqat.fq_weights_w4, jqat.fq_weights_w4)):
        got = flat(tqat.numpy_tree(tfq(tqat.tensor_tree(tree, "cpu"))))
        want = flat(jax.tree.map(np.asarray, jfq(jt)))
        assert got.keys() == want.keys()
        for k in got:
            assert np.array_equal(got[k], want[k]), k
    w4 = flat(tqat.numpy_tree(tqat.fq_weights_w4(tqat.tensor_tree(tree, "cpu"))))
    deq = flat(two4.dequantize(two4.convert_weight_only_int4(tree), torch.float32))
    for k in ("/conv/w", "/fc/w", "/dw/w", "/odd/w", "/stem/w"):
        assert np.array_equal(w4[k], np.asarray(deq[k])), k
    assert not np.array_equal(w4["/conv/w"], flat(tqat.numpy_tree(tqat.fq_weights(
        tqat.tensor_tree(tree, "cpu"))))["/conv/w"])  # the int4 grid, not the int8 one
    t = tqat.tensor_tree(tree, "cpu")
    placed = tq.place_folded(tqat.fq_weights(t), "cpu")
    for name in ("conv", "dw", "stem"):
        q, s = quantize_weight_per_channel(tree[name]["w"], channel_axis=3)
        oihw = placed[name]["w"].detach().numpy()
        assert np.array_equal(oihw, (q * s).transpose(3, 2, 0, 1)), name
    w = tree["conv"]["w"]
    for f_t, f_j in ((lambda v: tqat.fake_quant_weight(v, 3),
                      lambda v: jqat.fake_quant_weight(v, 3)),
                     (tqat.fake_quant_weight_int4, jqat.fake_quant_weight_int4)):
        g = tgrad(f_t, w)
        assert np.array_equal(g, jgrad(f_j, w)) and (g == 1.0).all()


def test_quant_config_takes_the_tools(tmp_path):
    cfg = QuantConfig(qat_epochs=1, adaround_iters=4, sensitivity=True, automix=True,
                      artifacts_root=str(tmp_path))
    assert (cfg.qat_epochs, cfg.adaround_iters, cfg.sensitivity, cfg.automix) == (1, 4, True, True)
    assert (cfg.qat_lr, cfg.adaround_lr, cfg.adaround_reg) == (1e-5, 1e-2, 0.01)
    assert (cfg.automix_budget, cfg.automix_max_taps) == (0.01, 8)


# --------------------------------------------------------------------------
# QAT and weight-only QAT
# --------------------------------------------------------------------------


def j_hook(obs):
    params = {n: minmax_qparams_affine(o.min, o.max) for n, o in obs.items()}
    return lambda name, t: t if name == "input" else jqat.fake_quant_act(t, *params[name])


def jax_step(jspec, folded, batch, fq, hook):
    """The JAX package's QAT loss (``qat.qat_finetune``'s closure), op by op
    -> (loss, logits, gradient tree)."""
    imgs, labels, mask = (jnp.asarray(a) for a in batch)
    x = j_norm(imgs)

    def loss_fn(f):
        logits = jq.apply_folded(jspec, fq(f), x, tap_fn=hook)
        return j_ce(logits, labels, mask), logits

    with jax.disable_jit():
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree.map(jnp.asarray, folded))
    return float(loss), np.asarray(logits), jax.tree.map(np.asarray, grads)


ROLES = {"qat": None, "w4": 4, "w8": 8}


@pytest.mark.parametrize("role", list(ROLES))
def test_finetune_steps_match_jax(role):
    """One step's loss, logits and gradients (``qat.fq_loss_and_grads``)
    against the JAX closure, then two steps of ``qat_finetune`` /
    ``w4_qat_finetune`` under DEBUG_MODE against the JAX package's, op by
    op: the updated parameters within 2 lr, the tree's structure the same."""
    jspec, tspec, folded, (imgs, labels), obs = setup()
    bits = ROLES[role]
    tb = next(iter(Batches(imgs, labels, 8, "cpu", shuffle=True, seed=0)))
    params = tqat.tensor_tree(folded, "cpu")
    if bits is None:
        fq_t, fq_j, hook_t, hook_j = tqat.fq_weights, jqat.fq_weights, tqat.act_hook(
            obs, torch.device("cpu")), j_hook(obs)
    else:
        fq_t = tqat.fq_weights_w4 if bits == 4 else tqat.fq_weights
        fq_j = jqat.fq_weights_w4 if bits == 4 else jqat.fq_weights
        hook_t = hook_j = None
    loss, logits, grads = tqat.fq_loss_and_grads(tspec, tq, params, tb, fq_t, hook_t)
    j_loss, j_logits, j_grads = jax_step(jspec, folded, [t.numpy() for t in tb], fq_j, hook_j)
    assert abs(loss.item() - j_loss) <= LOSS_RTOL * abs(j_loss)
    np.testing.assert_allclose(logits.numpy(), j_logits, rtol=0,
                               atol=LOSS_RTOL * np.abs(j_logits).max())
    from inference_efficient_vision_models_tpu_torch.train.optim import tree_like
    g_t, g_j = _flat_sorted(tqat.numpy_tree(tree_like(params, grads))), _flat_sorted(j_grads)
    assert g_t.keys() == g_j.keys()
    for k in g_t:
        assert abs(np.linalg.norm(g_t[k]) - np.linalg.norm(g_j[k])) <= GRAD_RTOL * max(
            np.linalg.norm(g_j[k]), 1e-12), k

    kw = dict(epochs=1, lr=LR, batch_size=8, debug=True)
    with jax.disable_jit():
        if bits is None:
            want = jqat.qat_finetune(jspec, jq, folded, obs, (imgs, labels), **kw)
        else:
            want = jqat.w4_qat_finetune(jspec, jq, folded, (imgs, labels), bits=bits, **kw)
    if bits is None:
        got = tqat.qat_finetune(tspec, tq, folded, obs, (imgs, labels), device="cpu", **kw)
    else:
        got = tqat.w4_qat_finetune(tspec, tq, folded, (imgs, labels), bits=bits, device="cpu",
                                   **kw)
    got, want, before = flat(got), flat(want), flat(folded)
    assert got.keys() == want.keys()
    moved = 0.0
    for k in got:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        assert np.abs(got[k] - want[k]).max() <= UPDATE_TOL * LR, k
        moved = max(moved, float(np.abs(got[k] - before[k]).max()))
    assert moved > LR  # the two steps moved the weights


def test_w4_qat_refuses_other_bits():
    jspec, tspec, folded, data, _ = setup()
    with pytest.raises(ValueError):
        tqat.w4_qat_finetune(tspec, tq, folded, data, bits=6, device="cpu")


# --------------------------------------------------------------------------
# AdaRound
# --------------------------------------------------------------------------


def test_adaround_contract_and_jax():
    """The port's hardened tree converts to exactly the learned integers
    (each channel's argmax element kept, the scale the same), some of them
    off the nearest rounding; against the JAX package's (jitted) learned
    integers, at most ``ADA_MISMATCH`` differ. The skipped stem is untouched."""
    jspec, tspec, folded, calib, obs = setup()
    hardened, rounding = tada.adaround_refine(tspec, tq, folded, obs, calib, iters=4,
                                              batch_size=8, device="cpu", return_rounding=True)
    assert "conv1/w" not in rounding and np.array_equal(hardened["conv1"]["w"],
                                                        folded["conv1"]["w"])
    qmodel = tq.convert_static_int8(tspec, hardened, obs, image_size=(32, 32))
    contract = adaround_contract(folded, hardened, rounding, qmodel)
    assert contract["int_equal"] and contract["argmax_kept"] and contract["scale_equal"]
    assert contract["leaves"] == 6 and contract["moved_from_nearest"] > 0
    want = jada.adaround_refine(jspec, jq, folded, obs, calib, iters=4, batch_size=8)
    got, want = flat(hardened), flat(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    differ = sum(int((got[k] != want[k]).sum()) for k in got)
    total = sum(got[k].size for k in got)
    assert differ <= ADA_MISMATCH * total, (differ, total)


# --------------------------------------------------------------------------
# the card's golden (chip_smoke's qat_step_golden)
# --------------------------------------------------------------------------


def test_tools_golden_is_current_and_the_cpu_within_its_limits():
    """The golden's seeded model is the one ``chip_smoke.tools_inputs`` makes,
    and the port on the CPU stays within ``TOOLS_LIMITS`` of it (AdaRound's
    contract exact)."""
    golden = np.load(TOOLS_GOLDEN)
    _, folded, _, _ = tools_inputs()
    assert np.array_equal(leaf_sums(folded), golden["folded_sums"])
    got = port_tool_steps("cpu", golden)
    d = compare_tool_steps(got, golden, TOOLS_LIMITS)
    assert d["ok"], d
    c = got["contract"]
    assert c["int_equal"] and c["argmax_kept"] and c["scale_equal"], c


def write_tools_golden():
    """The JAX package op by op on ``TOOLS_STEP``: its observers, one QAT
    step, one W4 QAT step (loss, logits, gradient norms, updates) and four
    AdaRound iterations (the learned integers) -> ``TOOLS_GOLDEN``; then the
    port's CPU deviation from it at 1, 2, 4 and 8 threads."""
    cfg = TOOLS_STEP
    tspec, folded, train, calib = tools_inputs(cfg)
    jspec = jreg.spec_from_dict(cfg["spec"])
    jf = jax.tree.map(jnp.asarray, folded)
    obs = jq.calibrate(jspec, jf, JBatches(*calib, cfg["batch"]), max_images=cfg["calib"])
    names = list(obs)
    out = {"folded_sums": leaf_sums(folded), "obs_names": np.array(names),
           "obs_min": np.array([obs[n].min for n in names], np.float64),
           "obs_max": np.array([obs[n].max for n in names], np.float64)}
    tb = next(iter(Batches(*train, cfg["batch"], "cpu", shuffle=True, seed=0)))
    batch = [t.numpy() for t in tb]
    kw = dict(epochs=1, lr=cfg["qat_lr"], batch_size=cfg["batch"])
    with jax.disable_jit():
        qat_after = jqat.qat_finetune(jspec, jq, folded, obs, train, **kw)
        w4_after = jqat.w4_qat_finetune(jspec, jq, folded, train, bits=4, **kw)
        hardened = jada.adaround_refine(jspec, jq, folded, obs, calib, iters=cfg["ada_iters"],
                                        lr=cfg["ada_lr"], batch_size=cfg["batch"])
    for role, fq, hook, after in (("qat", jqat.fq_weights, j_hook(obs), qat_after),
                                  ("w4", jqat.fq_weights_w4, None, w4_after)):
        loss, logits, grads = jax_step(jspec, folded, batch, fq, hook)
        out.update(tool_step_metrics(role, loss, logits, grads, folded,
                                     jax.tree.map(np.asarray, after), cfg["qat_lr"]))
    keys = []

    def collect(path, w, axis):
        if path[0] not in jq.ADAROUND_SKIP:
            keys.append("/".join(path))
        return w

    jada._weight_leaves(folded, collect)
    out["ada_names"] = np.array(sorted(keys))
    out["ada_q"] = learned_ints(folded, jax.tree.map(np.asarray, hardened), sorted(keys))
    np.savez_compressed(TOOLS_GOLDEN, **out)
    print("wrote", TOOLS_GOLDEN, os.path.getsize(TOOLS_GOLDEN), "bytes")
    golden = np.load(TOOLS_GOLDEN)
    for onednn in (True, False):
        for n in (1, 2, 4, 8):
            torch.set_num_threads(n)
            with torch.backends.mkldnn.flags(enabled=onednn):
                got = port_tool_steps("cpu", golden)
            print(f"oneDNN {onednn}, threads {n}:", compare_tool_steps(got, golden),
                  got["contract"])


if __name__ == "__main__":
    write_tools_golden()
