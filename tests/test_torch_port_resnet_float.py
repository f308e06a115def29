"""The port's float ResNet against the JAX package's ``resnet.apply`` on the
CPU: basic and bottleneck blocks (grouped too), eval and train mode, fp32
and bf16, the new BatchNorm running statistics, the layout converters, the
torch state-dict import against ``tests/torch_ref.py``, the registry, and
the committed r2 float goldens that ``chip_smoke.py`` holds the GPU against.

Running this file as a script rewrites those goldens (the JAX package's
logits of the committed pruned fp32 ResNet18 on the r2 held-out split, and
the split's sha256; ~2 min on the CPU):
``JAX_PLATFORMS=cpu python tests/test_torch_port_resnet_float.py``.
"""

import hashlib
import json
import logging
import os
import sys
import tempfile

import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch

from inference_efficient_vision_models_tpu.core import artifacts as jart
from inference_efficient_vision_models_tpu.core import config as jconfig
from inference_efficient_vision_models_tpu.data import neudet as jneudet
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu.models import resnet as jr
from inference_efficient_vision_models_tpu_torch.cli.teacher import load_stage_model
from inference_efficient_vision_models_tpu_torch.models import registry as treg
from inference_efficient_vision_models_tpu_torch.models import resnet as tr
from inference_efficient_vision_models_tpu_torch.models import torch_import as ti
from inference_efficient_vision_models_tpu_torch.models.widths import ResNetSpec

from chip_smoke import resnet_params_from_seed

try:
    from tests import torch_ref
except ImportError:  # run as a script
    import torch_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "inference_efficient_vision_models_tpu_torch", "testdata")
PRUNED = os.path.join(ROOT, "artifacts", "bench", "pruning", "r2", "fold_0")
PROVENANCE = os.path.join(ROOT, "artifacts", "bench", "quantization", "r2", "fold_0",
                          "provenance.json")
GOLDEN = os.path.join(TESTDATA, "r2_fold0_float_jax_logits.npz")
SPLIT_SHA = os.path.join(TESTDATA, "r2_fold0_test_split.sha256")
GOLDEN_BATCH = 32  # the JAX goldens' batch; logits do not depend on it in eval mode
CURRENT_IMAGES = 2  # images the "goldens are current" check recomputes

# fp32: |port - JAX| <= FP32_TAU * max|JAX| (the CPU measures <= 4.5e-6 at 64 px
# in train mode, summation order only; BatchNorm over few values amplifies it)
FP32_TAU = 1e-5
# bf16 on the tiny specs: the CPU measures <= 3.1e-7 of the logit scale at
# these inputs, and measured 5.13e-3 at another input (train mode, bottleneck:
# one conv output that rounds to the other bf16 neighbour, amplified by
# BatchNorm over a batch of 4); twice the largest
BF16_TAU = 0.0103
# bf16 on the r2 model at 224 x 224 (300 images): the CPU measures
# 8.11e-4 of the logit scale; twice that, the limit chip_smoke.py uses too
R2_BF16_TAU = 0.00163


def tiny_spec_dict(block: str, groups: int = 1, num_classes: int = 6) -> dict:
    """A one-block-per-stage ResNet with widths 8..64, as a spec dict."""
    if block == "basic":
        sw, inner = [8, 16, 32, 64], [[[8]], [[16]], [[32]], [[64]]]
    else:
        sw, inner = [16, 32, 64, 64], [[[8, 8]], [[8, 8]], [[16, 16]], [[16, 16]]]
    return dict(name=f"tiny_{block}{groups}", block=block, depths=[1, 1, 1, 1],
                stage_widths=sw, inner_widths=inner, stem_width=8,
                num_classes=num_classes, groups=groups)


def jax_model(d: dict, seed: int = 1):
    """(JAX spec, params, state) in the JAX layout, drawn from a numpy seed
    (BN statistics away from the identity, so eval mode normalizes with
    nontrivial values)."""
    spec = jreg.spec_from_dict(d)
    return (spec, *resnet_params_from_seed(spec, seed))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


CASES = [("basic", 1), ("bottleneck", 1), ("bottleneck", 2)]
DTYPES = {"float32": (jnp.float32, torch.float32, FP32_TAU),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TAU)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("block,groups", CASES)
def test_forward_matches_jax(block, groups, train, dtype):
    jdt, tdt, tau = DTYPES[dtype]
    d = tiny_spec_dict(block, groups)
    spec_j, p, s = jax_model(d)
    spec_t = treg.spec_from_dict(d)
    x = np.random.default_rng(2).standard_normal((4, 64, 64, 3)).astype(np.float32)
    ref, ref_s = jr.apply(spec_j, p, s, jnp.asarray(x).astype(jdt), train=train,
                          compute_dtype=jdt)
    tp, ts = tr.params_from_jax(p, "cpu"), tr.params_from_jax(s, "cpu")
    got, got_s = tr.apply(spec_t, tp, ts, torch.from_numpy(x).to(tdt), train=train,
                          compute_dtype=tdt)
    ref = np.asarray(ref, np.float32)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    got = got.detach().numpy()
    assert np.abs(got - ref).max() <= tau * np.abs(ref).max()
    fs, fr = flat(tr.params_to_jax(got_s)), flat(jax.device_get(ref_s))
    assert fs.keys() == fr.keys()
    for k in fr:
        if dtype == "float32":
            np.testing.assert_allclose(fs[k], fr[k], rtol=1e-5, atol=1e-6, err_msg=k)
        else:  # a bf16 conv output that rounds the other way moves later statistics
            assert np.abs(fs[k] - fr[k]).max() <= tau * np.abs(fr[k]).max(), k
    if not train:  # eval mode returns the state it was given
        for k, v in flat(s).items():
            np.testing.assert_array_equal(fs[k], v)


@pytest.mark.parametrize("block,groups", CASES)
def test_features_match_jax(block, groups):
    d = tiny_spec_dict(block, groups)
    spec_j, p, s = jax_model(d, 3)
    x = np.random.default_rng(4).standard_normal((3, 48, 48, 3)).astype(np.float32)
    ref_f, _ = jr.apply(spec_j, p, s, jnp.asarray(x), return_features=True)
    tp, ts = tr.params_from_jax(p, "cpu"), tr.params_from_jax(s, "cpu")
    feats, logits, _ = treg.features_and_logits(treg.spec_from_dict(d), tp, ts,
                                                torch.from_numpy(x))
    ref_f = np.asarray(ref_f)
    assert np.abs(feats.numpy() - ref_f).max() <= FP32_TAU * np.abs(ref_f).max()
    ref_l, _ = jreg.apply_model(spec_j, p, s, jnp.asarray(x))
    ref_l = np.asarray(ref_l)
    assert np.abs(logits.numpy() - ref_l).max() <= FP32_TAU * np.abs(ref_l).max()


def test_jax_layout_round_trip():
    _, p, s = jax_model(tiny_spec_dict("bottleneck", 2))
    tp = tr.params_from_jax(p, "cpu")
    assert tp["conv1"]["w"].shape == (8, 3, 7, 7)
    assert tp["conv1"]["w"].is_contiguous()  # channels-last memory on the GPU only
    assert tp["fc"]["w"].shape == p["fc"]["w"].shape
    for tree in (p, s):
        back = tr.params_to_jax(tr.params_from_jax(tree, "cpu"))
        fb, ft = flat(back), flat(tree)
        assert fb.keys() == ft.keys()
        for k in ft:
            assert fb[k].flags.c_contiguous
            np.testing.assert_array_equal(fb[k], ft[k])
    # a copy, never a view: later in-place updates must not reach it
    back = tr.params_to_jax(tp)
    tp["fc"]["b"].add_(1.0)
    np.testing.assert_array_equal(back["fc"]["b"], p["fc"]["b"])


def shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in shapes(sub, f"{prefix}/{key}").items()}
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("block,groups", CASES)
def test_init_has_jax_shapes(block, groups):
    d = tiny_spec_dict(block, groups)
    tp, ts = tr.init(treg.spec_from_dict(d), torch.Generator().manual_seed(0), "cpu")
    p, s = jax.eval_shape(lambda: jr.init(jax.random.PRNGKey(0), jreg.spec_from_dict(d)))
    assert shapes(tr.params_to_jax(tp)) == shapes(p)
    assert shapes(tr.params_to_jax(ts)) == shapes(s)
    seeded = resnet_params_from_seed(jreg.spec_from_dict(d), 0)
    assert shapes(seeded[0]) == shapes(p) and shapes(seeded[1]) == shapes(s)
    assert tr.param_count(tp) == sum(int(np.prod(v)) for v in shapes(p).values())
    w = tp["layer1"]["0"]["conv2"]["w"]  # Kaiming normal, fan_out
    assert abs(float(w.std()) - (2.0 / (9 * w.shape[0])) ** 0.5) < 0.3 * float(w.std())


@pytest.mark.parametrize("name,make,size", [
    ("resnet18", lambda: torch_ref.resnet18(num_classes=6), 64),
    ("resnext26_32x4d", lambda: torch_ref.resnext26_32x4d(num_classes=6), 32),
])
def test_torch_state_dict_import_matches_torch_ref(name, make, size):
    torch.manual_seed(0)
    tm = make()
    with torch.no_grad():  # nontrivial BN statistics
        for mod in tm.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.2)
                mod.running_var.uniform_(0.5, 1.5)
    tm.eval()
    spec = treg.make_spec(name, 6)
    sd = {f"module.{k}": v for k, v in tm.state_dict().items()}
    params, state = ti.from_torch_state_dict(spec, {"model_state_dict": sd})
    x = torch.randn(2, 3, size, size)
    with torch.no_grad():
        ref = tm(x).numpy()
        got, _ = tr.apply(spec, params, state, x.permute(0, 2, 3, 1).contiguous())
    assert np.abs(got.numpy() - ref).max() <= FP32_TAU * np.abs(ref).max()


def test_pretrained_from_cache_keeps_head(tmp_path, monkeypatch, caplog):
    torch.manual_seed(1)
    tm = torch_ref.resnet18(num_classes=1000)
    monkeypatch.setenv("IEVM_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "no_hub"))
    assert ti.find_cached_weights("resnet18") is None
    with caplog.at_level(logging.WARNING):
        spec, p0, _ = treg.create_model("resnet18", 6, pretrained=True, device="cpu")
    assert "RANDOM init" in caplog.text
    torch.save(tm.state_dict(), tmp_path / "resnet18-f37072fd.pth")
    assert ti.find_cached_weights("resnet18").endswith("resnet18-f37072fd.pth")
    spec, p, s = treg.create_model("resnet18", 6, pretrained=True, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    _, p_rand, _ = treg.create_model("resnet18", 6, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(p["fc"]["w"], p_rand["fc"]["w"]) and p["fc"]["w"].shape == (512, 6)
    assert torch.equal(p["layer2"]["0"]["down_conv"]["w"], tm.layer2[0].downsample[0].weight)
    assert torch.equal(s["bn1"]["var"], tm.bn1.running_var)
    ref_p, _ = ti.load_torch_checkpoint(spec, str(tmp_path / "resnet18-f37072fd.pth"))
    assert torch.equal(ref_p["conv1"]["w"], p["conv1"]["w"])


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "resnext50_32x4d", "wide_resnet50_2",
                                  "vit_tiny_patch16_224", "efficientnet_b0"])
def test_make_spec_matches_jax(name):
    got, ref = treg.make_spec(name, 6), jreg.make_spec(name, 6)
    assert got.to_dict() == ref.to_dict()
    d = tiny_spec_dict("bottleneck", 2)
    assert treg.make_spec(d).to_dict() == jreg.make_spec(d).to_dict()


def test_float_training_is_resnet_only():
    with pytest.raises(NotImplementedError, match="queue 1"):
        treg.create_model("vit_tiny_patch16_224", 6, device="cpu")
    # (the name predates MobileNetV2, which trains like the other CNN families now)
    spec, p, s = treg.create_model("mobilenet_v2_050", 6, device="cpu")
    assert spec.to_dict() == jreg.make_spec("mobilenet_v2_050", 6).to_dict()
    assert treg.model_module(spec).__name__.endswith("models.mobilenet")
    with pytest.raises(NotImplementedError, match="queue 1"):
        ti.from_torch_state_dict(treg.make_spec("vit_tiny_patch16_224"), {})


# --------------------------------------------------------------------------
# the r2 float goldens (committed pruned fp32 ResNet18 on the r2 split)
# --------------------------------------------------------------------------


def r2_test_split():
    """The r2 held-out split, from the data protocol in its provenance."""
    with open(PROVENANCE) as f:
        data = json.load(f)["data"]
    with tempfile.TemporaryDirectory() as tmp:  # the config makes its output dir
        cfg = jconfig.TeacherConfig(artifacts_root=tmp, **{
            k: (tuple(v) if k == "image_size" else v) for k, v in data.items()})
        return jneudet.load_dataset(cfg)["test"]


def split_sha256(imgs: np.ndarray, labels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(imgs, np.uint8).tobytes()
                          + np.asarray(labels, np.int32).tobytes()).hexdigest()


def jax_r2_logits(imgs: np.ndarray, dtype) -> np.ndarray:
    spec = jreg.spec_from_dict(jart.load_spec_dict(PRUNED, "best"))
    raw = jart.load_checkpoint_raw(PRUNED, "best")
    from inference_efficient_vision_models_tpu.data.pipeline import normalize_images

    fwd = jax.jit(lambda p, s, u8: jr.apply(spec, p, s, normalize_images(u8, dtype),
                                            compute_dtype=dtype)[0].astype(jnp.float32))
    return np.concatenate([np.asarray(fwd(raw["params"], raw["state"],
                                          jnp.asarray(imgs[i : i + GOLDEN_BATCH])))
                           for i in range(0, len(imgs), GOLDEN_BATCH)])


def port_r2_logits(imgs: np.ndarray, dtype) -> np.ndarray:
    from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images

    spec, p, s = load_stage_model(PRUNED, "best", "cpu")
    with torch.no_grad():
        return np.concatenate([
            tr.apply(spec, p, s, normalize_images(torch.from_numpy(imgs[i : i + GOLDEN_BATCH]),
                                                  dtype), compute_dtype=dtype)[0].numpy()
            for i in range(0, len(imgs), GOLDEN_BATCH)])


def test_r2_goldens_are_current():
    """The committed split hash and goldens are what the JAX package computes
    today (the first images), and the port agrees with them."""
    imgs, labels = r2_test_split()
    with open(SPLIT_SHA) as f:
        assert f.read().split()[0] == split_sha256(imgs, labels)
    golden = np.load(GOLDEN)
    assert golden["fp32"].shape == (len(labels), 6)
    np.testing.assert_array_equal(golden["labels"], labels)
    assert golden["split_sha256"] == split_sha256(imgs, labels)
    sub = imgs[:CURRENT_IMAGES]
    for key, jdt, tdt, tau in (("fp32", jnp.float32, torch.float32, FP32_TAU),
                               ("bf16", jnp.bfloat16, torch.bfloat16, R2_BF16_TAU)):
        ref = golden[key][:CURRENT_IMAGES]
        np.testing.assert_allclose(jax_r2_logits(sub, jdt), ref, rtol=1e-6, atol=1e-6)
        got = port_r2_logits(sub, tdt)
        assert np.abs(got - ref).max() <= tau * np.abs(golden[key]).max()
        np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))
    for key in ("fp32", "bf16"):
        acc = float((golden[key].argmax(1) == labels).mean())
        assert acc == float(golden[f"{key}_acc"])


def write_goldens() -> None:
    """Rewrite the r2 float goldens and the split hash; prints the port's
    deviation from them on the CPU (the source of R2_BF16_TAU)."""
    imgs, labels = r2_test_split()
    sha = split_sha256(imgs, labels)
    logits = {"fp32": jax_r2_logits(imgs, jnp.float32), "bf16": jax_r2_logits(imgs, jnp.bfloat16)}
    np.savez_compressed(
        GOLDEN, labels=labels.astype(np.int32), split_sha256=np.str_(sha),
        fp32=logits["fp32"].astype(np.float32), bf16=logits["bf16"].astype(np.float32),
        fp32_acc=np.float64((logits["fp32"].argmax(1) == labels).mean()),
        bf16_acc=np.float64((logits["bf16"].argmax(1) == labels).mean()))
    with open(SPLIT_SHA, "w") as f:
        f.write(f"{sha}  r2 fold-0 held-out split: images {imgs.shape} uint8, then labels "
                f"{labels.shape} int32, as bytes\n")
    for key, tdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        got, ref = port_r2_logits(imgs, tdt), logits[key]
        print(f"{key}: acc {(ref.argmax(1) == labels).mean():.4f}, port vs JAX "
              f"{np.abs(got - ref).max() / np.abs(ref).max():.3e} of the scale "
              f"{np.abs(ref).max():.3f}, argmax agree {(got.argmax(1) == ref.argmax(1)).mean()}")
    print(f"wrote {GOLDEN} and {SPLIT_SHA}")


if __name__ == "__main__":
    write_goldens()
