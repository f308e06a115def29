"""Stage 3 of the port on EfficientNet-B0 against the JAX package, on the CPU
at full width (64x64 images, weights from ``chip_smoke.effnet_params_from_seed``):
the coupled groups (keys, widths and every parameter path with its axis,
the SE vectors and the t=1 couplings), the kept channels of three criteria
(l2, taylor, bn_act; the SE squeeze groups have no BatchNorm, so bn_act
ranks them by weight L2) x local/global x round_to 1/8, the spec and every
leaf after the surgery, BN recalibration, and the pruned forward.

Selection and surgery run in numpy on the same JAX-layout trees on both
sides, so kept indices, leaves and specs are held EQUAL; the forward and
the BN statistics at fp32 1e-5 of their scale (summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import effnet_params_from_seed
from inference_efficient_vision_models_tpu.compress.prune import engine as jeng
from inference_efficient_vision_models_tpu.compress.prune import graph as jgraph
from inference_efficient_vision_models_tpu.models import efficientnet as jeff
from inference_efficient_vision_models_tpu.train.bn_recal import recalibrate_bn as j_recal
from inference_efficient_vision_models_tpu_torch.compress.prune import engine as teng
from inference_efficient_vision_models_tpu_torch.compress.prune import graph as tgraph
from inference_efficient_vision_models_tpu_torch.models import efficientnet as teff
from inference_efficient_vision_models_tpu_torch.train.bn_recal import recalibrate_bn

try:
    from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from tests.test_torch_port_resnet_float import flat
except ImportError:
    from test_torch_port_prune import one_thread  # noqa: F401
    from test_torch_port_resnet_float import flat

TAU = 1e-5


@pytest.fixture(scope="module")
def b0():
    spec = teff.efficientnet_spec("efficientnet_b0", 6)
    p, s = effnet_params_from_seed(spec, 2)
    return spec, jeff.efficientnet_spec("efficientnet_b0", 6), p, s


def _norm(groups):
    return [{k: (tuple(v) if isinstance(v, (list, tuple)) and k != "key" else v)
             for k, v in g.items()} for g in groups]


def test_groups_equal_jax(b0):
    spec, jspec, _, _ = b0
    got, ref = tgraph.group_slices(spec), jgraph.group_slices(jspec)
    assert _norm(got) == _norm(ref)
    keys = [tuple(g["key"]) for g in got]
    assert keys.count(("stem",)) == 1 and ("last",) in keys
    assert sum(k[0] == "se" for k in keys) == 16 and sum(k[0] == "hidden" for k in keys) == 15
    stem = got[0]  # the t=1 block 0 acts on the stem's channels
    assert (("stage0", "0", "dw", "w"), 3) in stem["producers"]
    assert ("stage0", "0", "se_expand", "b") in stem["vectors"]


def fake_grads(p, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), p)


@pytest.mark.parametrize("round_to", [1, 8])
@pytest.mark.parametrize("global_pruning", [False, True])
@pytest.mark.parametrize("method", ["l2", "taylor", "bn_act"])
def test_kept_channels_equal_jax(b0, method, global_pruning, round_to):
    spec, jspec, p, _ = b0
    kw = dict(ratio=0.3, method=method, global_pruning=global_pruning, round_to=round_to,
              grads=fake_grads(p) if method == "taylor" else None)
    got = teng.select_channels(spec, p, rng=np.random.default_rng(0), **kw)
    ref = jeng.select_channels(jspec, p, rng=np.random.default_rng(0), **kw)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=str(k))


@pytest.fixture(scope="module")
def pruned(b0):
    spec, jspec, p, s = b0
    t = teng.prune_model(spec, p, s, ratio=0.2, method="l2", round_to=8)
    j = jeng.prune_model(jspec, p, s, ratio=0.2, method="l2", round_to=8)
    return t, j


def test_surgery_equals_jax(pruned):
    (tspec, tp, ts_), (jspec, jp, js_) = pruned
    assert tspec.to_dict() == jspec.to_dict()
    assert tspec.stage_widths != (16, 24, 40, 80, 112, 192, 320)
    for w in (tspec.stem_width, tspec.last_width, *tspec.stage_widths,
              *(h for row in tspec.hidden_widths for h in row)):
        assert w % 8 == 0
    for got, ref in ((tp, jp), (ts_, js_)):
        fg, fr = flat(got), flat(jax.device_get(ref))
        assert fg.keys() == fr.keys()
        for k in fr:
            np.testing.assert_array_equal(fg[k], fr[k], err_msg=k)
    assert teff.param_count(teff.params_from_jax(tp, "cpu")) < 4_015_234


def test_pruned_forward_and_recalibration_match_jax(pruned):
    (tspec, tp, ts_), (jspec, jp, js_) = pruned
    imgs = np.random.default_rng(5).integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)
    ref_s = jax.device_get(j_recal(jspec, jp, js_, imgs, batch_size=4, num_batches=2))
    got_s = recalibrate_bn(tspec, teff.params_from_jax(tp, "cpu"),
                           teff.params_from_jax(ts_, "cpu"), imgs, batch_size=4, num_batches=2)
    fr, fg = flat(ref_s), flat(teff.params_to_jax(got_s))
    for k in fr:
        assert np.abs(fg[k] - fr[k]).max() <= TAU * max(np.abs(fr[k]).max(), 1.0), k
    x = np.random.default_rng(6).standard_normal((4, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, s, x: jeff.apply(jspec, p, s, x)[0])(jp, ref_s,
                                                                            jnp.asarray(x)))
    got = teff.apply(tspec, teff.params_from_jax(tp, "cpu"), teff.params_from_jax(ref_s, "cpu"),
                     torch.from_numpy(x))[0].numpy()
    assert np.abs(got - ref).max() <= TAU * np.abs(ref).max()


def test_engine_prunes_on_its_device(b0):
    """StructuredPruningEngine takes the spec: the port's tensors in, the
    pruned spec and tensors out, the same surgery as ``prune_model``."""
    import logging

    from inference_efficient_vision_models_tpu_torch.core.config import PruningConfig

    spec, _, p, s = b0
    cfg = PruningConfig(pruning_ratio=0.2, round_to=8, pruning_method="l2")
    eng = teng.StructuredPruningEngine(cfg, spec, teff.params_from_jax(p, "cpu"),
                                       teff.params_from_jax(s, "cpu"), logging.getLogger("t"),
                                       "cpu")
    new_spec, new_p, _ = eng.prune_model()
    ref_spec, ref_p, _ = teng.prune_model(spec, p, s, ratio=0.2, method="l2", round_to=8,
                                          seed=cfg.seed)
    assert new_spec == ref_spec
    fg, fr = flat(teff.params_to_jax(new_p)), flat(ref_p)
    for k in fr:
        np.testing.assert_array_equal(fg[k], fr[k], err_msg=k)
    # Taylor gradients through the eval-mode forward, as a JAX-layout tree
    imgs = np.random.default_rng(7).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    batch = (torch.from_numpy(imgs), torch.tensor([0, 1]), torch.ones(2))
    g = teng.taylor_grads_accumulated(spec, teff.params_from_jax(p, "cpu"),
                                      teff.params_from_jax(s, "cpu"), [batch])
    assert {k: v.shape for k, v in flat(g).items()} == {k: v.shape for k, v in flat(p).items()}
    assert all(np.isfinite(v).all() for v in flat(g).values())
