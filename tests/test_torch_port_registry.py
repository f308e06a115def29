"""The port's model registry's custom names (``register_model``,
``registered_models``), mirroring the JAX package's
``tests/test_registry_custom.py`` and held against it on the CPU: a
registered narrow ResNet through ``create_model``, pruning and static INT8
(the JAX package's on the same seeded weights: the same pruned spec and
leaves, the same integer leaves, the logits within the ResNet18 limit),
through the teacher CLI by ``model_name=``, and the duplicate-name refusal
and ``overwrite``. The port's table is its own: a name registered in one
package is unknown to the other."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import resnet_params_from_seed
from inference_efficient_vision_models_tpu.compress.prune import prune_model as j_prune
from inference_efficient_vision_models_tpu.compress.quant import qresnet as jq
from inference_efficient_vision_models_tpu.compress.quant.engine import (
    s2d_preprocess as j_s2d)
from inference_efficient_vision_models_tpu.data.pipeline import Batches as JBatches
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu_torch.cli import teacher
from inference_efficient_vision_models_tpu_torch.compress.prune import prune_model
from inference_efficient_vision_models_tpu_torch.compress.quant import qresnet as tq
from inference_efficient_vision_models_tpu_torch.core import artifacts
from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches, normalize_images
from inference_efficient_vision_models_tpu_torch.models import (
    ResNetSpec,
    apply_model,
    create_model,
    register_model,
    registered_models,
)
from inference_efficient_vision_models_tpu_torch.models import registry as treg

try:
    from tests.test_torch_port_prune import one_thread  # noqa: F401
    from tests.test_torch_port_resnet_float import flat
except ImportError:
    from test_torch_port_prune import one_thread  # noqa: F401
    from test_torch_port_resnet_float import flat

NAME = "resnet10_narrow"


def _narrow_resnet(num_classes: int = 6, in_chans: int = 3) -> ResNetSpec:
    """A half-width 10-layer ResNet that no built-in name gives."""
    depths, planes = (1, 1, 1, 1), (32, 64, 128, 256)
    return ResNetSpec(name=NAME, block="basic", depths=depths, stage_widths=planes,
                      inner_widths=tuple(((p,),) * d for d, p in zip(depths, planes)),
                      stem_width=32, num_classes=num_classes, in_chans=in_chans)


@pytest.fixture(autouse=True)
def _clean_registry():
    saved, jsaved = dict(treg._CUSTOM), dict(jreg._CUSTOM)
    yield
    treg._CUSTOM.clear()
    treg._CUSTOM.update(saved)
    jreg._CUSTOM.clear()
    jreg._CUSTOM.update(jsaved)


def test_registered_name_resolves_and_runs():
    register_model(NAME, _narrow_resnet)
    assert NAME in registered_models() and NAME not in jreg.registered_models()
    spec, params, state = create_model(NAME, num_classes=6, device="cpu")
    assert spec.stem_width == 32 and spec.stage_widths == (32, 64, 128, 256)
    x = torch.zeros((2, 64, 64, 3))
    logits, _ = apply_model(spec, params, state, x)
    assert logits.shape == (2, 6)
    # ahead of the built-in names: a registered "resnet18" is the registered one
    register_model("resnet18", _narrow_resnet)
    assert create_model("resnet18", device="cpu")[0].name == NAME


def test_registered_name_through_pruning_and_static_int8_vs_jax():
    """Pruning and the static-INT8 conversion of the registered model equal
    the JAX package's on the same seeded weights (numpy on both sides); the
    port's int8 forward (plain) gives the JAX executor's logits within the
    ResNet18 limit (rtol/atol 0.02: requant ties), the same argmax."""
    register_model(NAME, _narrow_resnet)
    jreg.register_model(NAME, _narrow_resnet)
    tspec = treg.make_spec(NAME)
    jspec = jreg.make_spec(NAME)
    assert tspec.to_dict() == jspec.to_dict()
    p, s = resnet_params_from_seed(tspec, 0)
    pspec, pp, ps = prune_model(tspec, p, s, ratio=0.25, method="l2", round_to=8)
    jpspec, jpp, jps = j_prune(jspec, p, s, ratio=0.25, method="l2", round_to=8)
    assert pspec.to_dict() == jpspec.to_dict()
    assert sum(pspec.stage_widths) < sum(tspec.stage_widths)
    for tree, jtree in ((pp, jpp), (ps, jps)):
        a, b = flat(tree), flat(jax.tree.map(np.asarray, jtree))
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (8, 64, 64, 3)).astype(np.uint8)
    labels = rng.integers(0, 6, 8).astype(np.int32)
    folded = tq.fold(pspec, pp, ps)
    obs = tq.calibrate(pspec, tq.place_folded(folded, "cpu"), Batches(imgs, labels, 8, "cpu"),
                       max_images=8)
    qm = tq.convert_static_int8(pspec, folded, obs, image_size=(64, 64))
    jfolded = jq.fold(jpspec, jpp, jps)
    jqm = jq.convert_static_int8(jpspec, jfolded, obs, image_size=(64, 64))
    a, b = flat(tq.serializable(qm)), flat(jax.tree.map(np.asarray, jq.serializable(jqm)))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a if k.endswith(("w_q", "w4_q", "w_sum")))
    model = tq.from_jax_qmodel(pspec.to_dict(), qm, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(imgs), impl="plain").numpy()
    ref = np.asarray(jq.apply_int8(jpspec, jax.tree.map(jnp.asarray, jqm),
                                   jnp.asarray(j_s2d(imgs))))
    assert got.shape == (8, 6) and np.isfinite(got).all()
    assert np.array_equal(got.argmax(1), ref.argmax(1))
    np.testing.assert_allclose(got, ref, rtol=0.02, atol=0.02)
    # the calibration the JAX package makes of the same model: the same ranges
    jobs = jq.calibrate(jpspec, jax.tree.map(jnp.asarray, jfolded), JBatches(imgs, labels, 8),
                        max_images=8)
    assert sorted(jobs) == sorted(obs)
    for n in obs:
        np.testing.assert_allclose([obs[n].min, obs[n].max], [jobs[n].min, jobs[n].max],
                                   rtol=1e-5, atol=1e-6)


def test_registered_name_from_the_teacher_cli(tmp_path, monkeypatch):
    """``model_name=`` takes a registered name in a stage CLI; the checkpoint
    carries its spec, which the later stages read back."""
    monkeypatch.setenv("IEVM_PLATFORM", "cpu")
    register_model(NAME, _narrow_resnet)
    teacher.main([f"artifacts_root={str(tmp_path)!r}", f"model_name={NAME!r}",
                  "image_size=(32, 32)", "synthetic_size=48", "epochs=1", "folds=(0,)",
                  "num_folds=3", "pretrained=False", "batch_size=8", "DEBUG_MODE=True"])
    fold = os.path.join(str(tmp_path), "teacher_training", "test", "fold_0")
    spec = treg.spec_from_dict(artifacts.load_spec_dict(fold))
    assert spec.to_dict() == _narrow_resnet().to_dict()
    x = torch.from_numpy(np.zeros((1, 32, 32, 3), np.uint8))
    tspec, p, s = teacher.load_stage_model(fold, "best", "cpu")
    assert apply_model(tspec, p, s, normalize_images(x))[0].shape == (1, 6)


def test_duplicate_registration_guarded():
    register_model(NAME, _narrow_resnet)
    with pytest.raises(ValueError):
        register_model(NAME, _narrow_resnet)
    register_model(NAME, lambda **kw: _narrow_resnet(**kw), overwrite=True)
    assert registered_models().count(NAME) == 1
