"""The port's torchvision EfficientNet import (``models/torch_import.py``)
against the JAX package's, on the CPU, from state dicts only.

- ``from_torch_state_dict_effnet`` on ``torch_ref.efficientnet_b0``'s
  state_dict gives the JAX converter's leaves exactly (through
  ``params_to_jax``).
- ``create_model("efficientnet_b0", pretrained=True)`` loads a cached file
  from ``$IEVM_WEIGHTS_DIR`` and keeps its fresh 6-class head.
- ``load_torch_checkpoint`` reads a B0 ``.pth`` (wrapped, DataParallel prefix).
- A cache file that does not fit (a leaf of another shape, or another
  family's keys) warns and keeps the random init, as the JAX package's
  ``create_model`` does for any failure; a family whose converter is not
  ported still raises.
"""

import logging

import numpy as np
import pytest
import torch

from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu.models import torch_import as jti
from inference_efficient_vision_models_tpu_torch.models import registry as treg
from inference_efficient_vision_models_tpu_torch.models import torch_import as ti
from tests import torch_ref

# torchvision's cache name of the B0 weights
B0_FILE = "efficientnet_b0_rwightman-7f5810bc.pth"


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_same_leaves(got, ref, skip=()):
    got, ref = flat(got), flat(ref)
    assert set(got) == set(ref)
    for k in sorted(set(ref) - {k for k in ref if k.startswith(tuple(skip))}):
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def b0_state_dict(num_classes=1000, seed=0):
    """torch_ref's B0 with seeded weights and nontrivial BN statistics."""
    torch.manual_seed(seed)
    tm = torch_ref.efficientnet_b0(num_classes=num_classes)
    with torch.no_grad():
        for mod in tm.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.normal_(0, 0.1)
                mod.running_mean.normal_(0, 0.2)
                mod.running_var.uniform_(0.5, 1.5)
    return tm.state_dict()


def port_tree(spec, tree):
    return treg.params_to_jax(spec, tree)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("IEVM_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "no_hub"))
    return tmp_path


def test_effnet_state_dict_converts_like_jax():
    sd = b0_state_dict()
    spec, jspec = treg.make_spec("efficientnet_b0", 1000), jreg.make_spec("efficientnet_b0", 1000)
    p, s = ti.from_torch_state_dict_effnet(spec, sd)
    jp, js = jti.from_torch_state_dict_effnet(jspec, sd)
    assert p["stage1"]["0"]["dw"]["w"].shape == (96, 1, 3, 3)  # the port's (C, 1, k, k)
    assert p["stage1"]["0"]["se_reduce"]["w"].shape == (96, 4)  # (in, out)
    assert_same_leaves(port_tree(spec, p), jp)
    assert_same_leaves(port_tree(spec, s), js)


def test_pretrained_effnet_from_cache_keeps_fresh_head(cache):
    sd = b0_state_dict(seed=1)
    torch.save(sd, cache / B0_FILE)
    assert ti.find_cached_weights("efficientnet_b0").endswith(B0_FILE)
    spec, p, s = treg.create_model("efficientnet_b0", 6, pretrained=True, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    _, p_rand, _ = treg.create_model("efficientnet_b0", 6, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    assert p["fc"]["w"].shape == (1280, 6) and torch.equal(p["fc"]["w"], p_rand["fc"]["w"])
    assert torch.equal(p["fc"]["b"], p_rand["fc"]["b"])
    # the JAX package's load_pretrained on the same cache file: every other leaf equal
    jp, js = jti.load_pretrained(jreg.make_spec("efficientnet_b0", 6), {"fc": None}, None)
    assert_same_leaves({k: v for k, v in port_tree(spec, p).items() if k != "fc"},
                       {k: v for k, v in jp.items() if k != "fc"})
    assert_same_leaves(port_tree(spec, s), js)


def test_load_torch_checkpoint_reads_b0(tmp_path):
    sd = b0_state_dict(num_classes=6, seed=2)
    path = str(tmp_path / "teacher.pth")
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    spec = treg.make_spec("efficientnet_b0", 6)
    p, s = ti.load_torch_checkpoint(spec, path)
    jp, js = jti.load_torch_checkpoint(jreg.make_spec("efficientnet_b0", 6), path)
    assert_same_leaves(port_tree(spec, p), jp)
    assert_same_leaves(port_tree(spec, s), js)


def test_unfit_cache_warns_and_keeps_random_init(cache, caplog):
    def random_and_pretrained():
        _, p_rand, s_rand = treg.create_model("efficientnet_b0", 6, device="cpu",
                                              generator=torch.Generator().manual_seed(0))
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            spec, p, s = treg.create_model("efficientnet_b0", 6, pretrained=True, device="cpu",
                                           generator=torch.Generator().manual_seed(0))
        assert "RANDOM init" in caplog.text
        assert_same_leaves(port_tree(spec, p), port_tree(spec, p_rand))
        assert_same_leaves(port_tree(spec, s), port_tree(spec, s_rand))
        return caplog.text

    # a leaf of another shape: a stem for four input channels
    sd = b0_state_dict(seed=3)
    sd["features.0.0.weight"] = torch.zeros(32, 4, 3, 3)
    torch.save(sd, cache / B0_FILE)
    assert "ValueError" in random_and_pretrained()
    # another family's keys: the JAX converter fails too (its create_model warns)
    torch.save(torch_ref.resnet18().state_dict(), cache / B0_FILE)
    assert "KeyError" in random_and_pretrained()
    with pytest.raises(KeyError):
        jti.load_pretrained(jreg.make_spec("efficientnet_b0", 6), {"fc": None}, None)


def test_unported_family_still_raises(cache):
    """(Every family is ported now: a ViT cache file without the timm keys
    fails in the converter, as the JAX package's does.)"""
    torch.save({}, cache / "vit_tiny_patch16_224.pth")
    with pytest.raises(KeyError):
        ti.load_pretrained(treg.make_spec("vit_tiny_patch16_224", 6),
                           {"head": {"w": torch.zeros(192, 6)}}, {})
