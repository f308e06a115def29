"""The port's ViT structured pruning (``compress/prune/vit_engine.py``, the
dispatch in ``compress/prune/engine.py``) against the JAX package's
``vit_engine`` on the CPU: the kept MLP units and heads for every criterion
(l1, l2, random), ``round_to`` 1 and 8 and ``prune_heads`` on and off, the
sliced leaves, the pruned spec's JSON round trip, and the stage-3 engine
class on a ViT (the JAX regression of tests/test_vit.py:332: its log line
must not read CNN widths). Selection and surgery are numpy on the JAX
layout on both sides, so everything is held equal."""

import json
import logging

import numpy as np
import pytest
import torch

from chip_smoke import vit_params_from_seed
from inference_efficient_vision_models_tpu.compress.prune import vit_engine as jve
from inference_efficient_vision_models_tpu.models import vit as jvit
from inference_efficient_vision_models_tpu.models.registry import spec_from_dict as j_spec
from inference_efficient_vision_models_tpu_torch.compress.prune import engine as teng
from inference_efficient_vision_models_tpu_torch.compress.prune import graph as tgraph
from inference_efficient_vision_models_tpu_torch.compress.prune import vit_engine as tve
from inference_efficient_vision_models_tpu_torch.models import vit as tvit
from inference_efficient_vision_models_tpu_torch.models.registry import spec_from_dict as t_spec

try:
    from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from tests.test_torch_port_resnet_float import flat
except ImportError:
    from test_torch_port_prune import one_thread  # noqa: F401
    from test_torch_port_resnet_float import flat


def small_spec():
    """Four heads of 16 and an MLP of 256 per block: room for both groups."""
    return jvit.ViTSpec(name="vit_test", patch=8, dim=64, depth=3, heads=4, mlp_ratio=4.0,
                        num_classes=6, image_size=32)


@pytest.fixture(scope="module")
def vit_model():
    spec = small_spec()
    return spec, t_spec(spec.to_dict()), vit_params_from_seed(spec, 7)


def assert_trees_equal(got, ref):
    fg, fr = flat(got), flat(ref)
    assert fg.keys() == fr.keys()
    for k in fr:
        assert fg[k].shape == fr[k].shape, k
        np.testing.assert_array_equal(fg[k], fr[k], err_msg=k)


@pytest.mark.parametrize("prune_heads", [True, False])
@pytest.mark.parametrize("round_to", [1, 8])
@pytest.mark.parametrize("method", ["l1", "l2", "random"])
def test_selection_and_surgery_match_jax(vit_model, method, round_to, prune_heads):
    spec, tspec, p = vit_model
    kw = dict(ratio=0.3, method=method, round_to=round_to, prune_heads=prune_heads)
    ref = jve.select_vit_channels(spec, p, rng=np.random.default_rng(42), **kw)
    got = tve.select_vit_channels(tspec, p, rng=np.random.default_rng(42), **kw)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    assert all(len(ref[("mlp", i)]) % round_to == 0 for i in range(spec.depth))
    assert (("heads", 0) in got) == prune_heads
    rs, rp = jve.apply_vit_pruning(spec, p, ref)
    gs, gp = tve.apply_vit_pruning(tspec, p, got)
    assert gs.to_dict() == rs.to_dict()
    assert_trees_equal(gp, rp)
    assert flat(p)["/blocks/0/qkv/w"].shape == (64, 192)  # the input is left as it was


def test_head_surgery_keeps_each_heads_columns(vit_model):
    """Keeping heads (0, 2) of 4 keeps their q, k and v column blocks and
    their proj rows, and the pruned model's forward is the unpruned one's
    with those heads' outputs removed (proj rows of the removed heads zero)."""
    spec, tspec, p = vit_model
    keep = {("heads", i): np.array([0, 2]) for i in range(spec.depth)}
    ns, np_ = tve.apply_vit_pruning(tspec, p, keep)
    assert ns.head_counts == (2, 2, 2) and ns.mlp_hidden == (256, 256, 256)
    w = np.asarray(p["blocks"]["1"]["qkv"]["w"]).reshape(64, 3, 4, 16)
    np.testing.assert_array_equal(np_["blocks"]["1"]["qkv"]["w"],
                                  w[:, :, [0, 2]].reshape(64, 96))
    z = {**p, "blocks": {i: {**b, "proj": {**b["proj"], "w": np.asarray(b["proj"]["w"]).copy()}}
                         for i, b in p["blocks"].items()}}
    for b in z["blocks"].values():
        b["proj"]["w"].reshape(4, 16, 64)[[1, 3]] = 0.0
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 3))
                         .astype(np.float32))
    with torch.no_grad():
        a, _ = tvit.apply(ns, tvit.params_from_jax(np_, "cpu"), {}, x)
        b, _ = tvit.apply(tspec, tvit.params_from_jax(z, "cpu"), {}, x)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_prune_model_dispatch_and_spec_round_trip(vit_model):
    spec, tspec, p = vit_model
    ref_spec, ref_p, ref_s = jve.prune_vit(spec, p, {}, ratio=0.25, method="l2", round_to=8)
    got_spec, got_p, got_s = teng.prune_model(tspec, p, {}, ratio=0.25, method="l2",
                                              round_to=8, global_pruning=True)
    assert got_s == {} == ref_s
    assert got_spec.to_dict() == ref_spec.to_dict()
    assert_trees_equal(got_p, ref_p)
    assert all(w % 8 == 0 for w in got_spec.mlp_hidden) and got_spec.head_counts == (3, 3, 3)
    d = json.loads(json.dumps(got_spec.to_dict()))
    assert t_spec(d) == got_spec and j_spec(d).to_dict() == ref_spec.to_dict()
    assert tvit.param_count(tvit.params_from_jax(got_p, "cpu")) == jvit.param_count(ref_p)
    with pytest.raises(ValueError, match="l1/l2/random"):
        teng.prune_model(tspec, p, {}, ratio=0.25, method="taylor")
    with pytest.raises(TypeError, match="vit_engine"):
        tgraph.group_slices(tspec)


def test_structured_pruning_engine_on_a_vit(vit_model):
    """The stage-3 engine class: prune (a log line without CNN widths), a
    recalibration that is a no-op (no BatchNorm), the engine's metrics."""
    spec, tspec, p = vit_model

    class Cfg:
        pruning_ratio = 0.25
        pruning_method = "l2"
        global_pruning = False
        round_to = 8
        seed = 0
        finetune_epochs = 0
        batch_size = 4
        compute_dtype = "float32"
        DEBUG_MODE = True
        image_size = (32, 32)

    eng = teng.StructuredPruningEngine(Cfg(), tspec, tvit.params_from_jax(p, "cpu"), {},
                                       logging.getLogger("p"), device="cpu")
    pspec, pparams, pstate = eng.prune_model()
    assert pspec.dim == tspec.dim and pstate == {}
    assert all(pparams["blocks"][str(i)]["mlp1"]["w"].shape[1] < 256 for i in range(3))
    assert eng.recalibrate((np.zeros((8, 32, 32, 3), np.uint8), np.zeros(8, np.int32))) == {}
    imgs = np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    m = eng.evaluate_metrics((imgs, np.arange(8) % 6), "pruned")
    assert m["Params (M)"] == pytest.approx(tvit.param_count(pparams) / 1e6)
    assert m["MACs (G)"] > 0 and np.isfinite(m["Accuracy"])
