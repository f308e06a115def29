"""Stage 3 of the port on MobileNetV2 against the JAX package, on the CPU
(``mobilenet_v2_050``, weights from ``chip_smoke.mbv2_params_from_seed``):
the coupled groups (keys, widths and every parameter path with its axis,
the depthwise edge: a t=1 block's depthwise kernel and BN ride its input's
group), and ``prune_model`` for l2, l1 and random x local/global x round_to
1/8: the kept channels, the pruned spec and every leaf, then the pruned
forward at 64x64 and the engine's own surgery.

Selection and surgery run in numpy on the same JAX-layout trees on both
sides, so kept indices, leaves and specs are held EQUAL; the forward at fp32
1e-5 of its scale (summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import mbv2_params_from_seed
from inference_efficient_vision_models_tpu.compress.prune import engine as jeng
from inference_efficient_vision_models_tpu.compress.prune import graph as jgraph
from inference_efficient_vision_models_tpu.models import mobilenet as jmb
from inference_efficient_vision_models_tpu_torch.compress.prune import engine as teng
from inference_efficient_vision_models_tpu_torch.compress.prune import graph as tgraph
from inference_efficient_vision_models_tpu_torch.models import mobilenet as tmb
from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
from tests.test_torch_port_resnet_float import flat

NAME = "mobilenet_v2_050"
TAU = 1e-5


@pytest.fixture(scope="module")
def mb():
    spec = tmb.mobilenet_v2_spec(NAME, 6)
    p, s = mbv2_params_from_seed(spec, 2)
    return spec, jmb.mobilenet_v2_spec(NAME, 6), p, s


def _norm(groups):
    """Lists as tuples; the port's groups carry an empty ``vectors`` list (the
    1-D biases of EfficientNet's SE gate), the JAX MobileNetV2 groups none."""
    out = []
    for g in groups:
        g = {k: (tuple(v) if isinstance(v, (list, tuple)) and k != "key" else v)
             for k, v in g.items()}
        if not g.get("vectors", True):
            del g["vectors"]
        out.append(g)
    return out


def test_groups_equal_jax(mb):
    spec, jspec, _, _ = mb
    got, ref = tgraph.group_slices(spec), jgraph.group_slices(jspec)
    assert _norm(got) == _norm(ref)
    keys = [tuple(g["key"]) for g in got]
    assert keys.count(("stem",)) == 1 and ("last",) in keys
    assert sum(k[0] == "hidden" for k in keys) == 16 and not any(k[0] == "se" for k in keys)
    stem = got[0]  # the t=1 block 0 acts on the stem's channels
    assert (("stage0", "0", "dw", "w"), 3) in stem["producers"]
    assert ("stage0", "0", "dw_bn") in stem["bns"]
    assert (("stage0", "0", "project", "w"), 2) in stem["consumers"]


@pytest.mark.parametrize("round_to", [1, 8])
@pytest.mark.parametrize("global_pruning", [False, True])
@pytest.mark.parametrize("method", ["l2", "l1", "random"])
def test_prune_model_equals_jax(mb, method, global_pruning, round_to):
    spec, jspec, p, s = mb
    kw = dict(ratio=0.3, method=method, global_pruning=global_pruning, round_to=round_to,
              seed=5)
    keep = teng.select_channels(spec, p, ratio=0.3, method=method,
                                global_pruning=global_pruning, round_to=round_to,
                                rng=np.random.default_rng(5))
    ref_keep = jeng.select_channels(jspec, p, ratio=0.3, method=method,
                                    global_pruning=global_pruning, round_to=round_to,
                                    rng=np.random.default_rng(5))
    assert keep.keys() == ref_keep.keys()
    for k in ref_keep:
        np.testing.assert_array_equal(keep[k], np.asarray(ref_keep[k]), err_msg=str(k))
    tspec, tp, ts_ = teng.prune_model(spec, p, s, **kw)
    jspec2, jp, js_ = jeng.prune_model(jspec, p, s, **kw)
    assert tspec.to_dict() == jspec2.to_dict()
    assert tspec.stage_widths != spec.stage_widths
    if round_to == 8:
        assert all(w % 8 == 0 for w in (tspec.stem_width, tspec.last_width,
                                        *tspec.stage_widths,
                                        *(h for row in tspec.hidden_widths for h in row)))
    for got, ref in ((tp, jp), (ts_, js_)):
        fg, fr = flat(got), flat(jax.device_get(ref))
        assert fg.keys() == fr.keys()
        for k in fr:
            np.testing.assert_array_equal(fg[k], fr[k], err_msg=k)


def test_pruned_forward_and_engine(mb):
    """The pruned model's forward against the JAX package's, and
    ``StructuredPruningEngine`` (the port's tensors in, the pruned spec and
    tensors out) doing the same surgery as ``prune_model``."""
    import logging

    from inference_efficient_vision_models_tpu_torch.core.config import PruningConfig

    spec, _, p, s = mb
    tspec, tp, ts_ = teng.prune_model(spec, p, s, ratio=0.2, method="l2", round_to=8)
    jspec2 = jmb.MobileNetV2Spec.from_dict(tspec.to_dict())
    x = np.random.default_rng(6).standard_normal((4, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, s, x: jmb.apply(jspec2, p, s, x)[0])(tp, ts_,
                                                                             jnp.asarray(x)))
    got = tmb.apply(tspec, tmb.params_from_jax(tp, "cpu"), tmb.params_from_jax(ts_, "cpu"),
                    torch.from_numpy(x))[0].numpy()
    assert np.abs(got - ref).max() <= TAU * np.abs(ref).max()

    cfg = PruningConfig(pruning_ratio=0.2, round_to=8, pruning_method="l2")
    eng = teng.StructuredPruningEngine(cfg, spec, tmb.params_from_jax(p, "cpu"),
                                       tmb.params_from_jax(s, "cpu"), logging.getLogger("t"),
                                       "cpu")
    new_spec, new_p, _ = eng.prune_model()
    ref_spec, ref_p, _ = teng.prune_model(spec, p, s, ratio=0.2, method="l2", round_to=8,
                                          seed=cfg.seed)
    assert new_spec == ref_spec
    fg, fr = flat(tmb.params_to_jax(new_p)), flat(ref_p)
    for k in fr:
        np.testing.assert_array_equal(fg[k], fr[k], err_msg=k)
