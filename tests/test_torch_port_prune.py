"""Stage 3 of the port (structured pruning) against the JAX package, on the
CPU at a small size: a ResNet18 narrowed to widths 16/32/64/128 and
one-block bottleneck nets (plain and grouped), weights drawn from a numpy
seed, 64x64 images.

Selection and surgery run in numpy on the same JAX-layout trees on both
sides, so kept indices, repacked leaves and specs are held EQUAL. The
gradients and BatchNorm statistics come from each package's own forward,
so they are held to the stated relative tolerances.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from chip_smoke import resnet_params_from_seed
from inference_efficient_vision_models_tpu.compress.prune import engine as jeng
from inference_efficient_vision_models_tpu.core.config import PruningConfig as JPruningConfig
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu.train.bn_recal import recalibrate_bn as j_recal
from inference_efficient_vision_models_tpu_torch.compress.prune import engine as teng
from inference_efficient_vision_models_tpu_torch.compress.prune.graph import (
    get_path,
    group_slices,
    set_path,
)
from inference_efficient_vision_models_tpu_torch.core.config import PruningConfig
from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images
from inference_efficient_vision_models_tpu_torch.models import registry as treg
from inference_efficient_vision_models_tpu_torch.models import resnet as tr
from inference_efficient_vision_models_tpu_torch.train.bn_recal import recalibrate_bn

try:
    from tests.test_torch_port_resnet_float import flat, tiny_spec_dict
except ImportError:
    from test_torch_port_resnet_float import flat, tiny_spec_dict

LOG = logging.getLogger("test_torch_port_prune")
METHODS = ("l1", "l2", "random", "taylor", "group_norm", "bn_act", "apoz")
# port vs JAX on one batch's fp32 gradients (eval-mode forward, TF32 off):
# summation order only; the CPU measures <= 2e-6 per leaf norm
GRAD_RTOL = 1e-5
# BN statistics recovered by the EMA inversion (new - old) / 0.1, relative to
# each leaf's largest magnitude: fp32 1e-5 (the CPU measures 2.2e-6); bf16
# twice the CPU's 0.0215 (the bf16 convs round at other places than XLA's)
RECAL_RTOL = {"float32": 1e-5, "bfloat16": 0.043}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these tiny models: the suite runs several
    workers at once, and torch's per-op thread pools then wait on threads
    the other workers hold (a small-op test ran 45x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def narrow_r18_dict(num_classes: int = 6) -> dict:
    """ResNet18's topology (2 basic blocks per stage) at widths 16/32/64/128."""
    sw = [16, 32, 64, 128]
    return dict(name="resnet18_narrow", block="basic", depths=[2, 2, 2, 2], stage_widths=sw,
                inner_widths=[[[w], [w]] for w in sw], stem_width=16,
                num_classes=num_classes, groups=1)


SPECS = {"r18n": narrow_r18_dict(), "bottleneck": tiny_spec_dict("bottleneck"),
         "resnext": tiny_spec_dict("bottleneck", 2)}


def jax_model(name: str, seed: int = 1):
    spec = jreg.spec_from_dict(SPECS[name])
    return (spec, *resnet_params_from_seed(spec, seed))


def images(n: int, seed: int = 2, size: int = 64) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def batches(imgs, labels, bs):
    """Unshuffled full batches with an all-ones mask (numpy)."""
    return [(imgs[i : i + bs], labels[i : i + bs], np.ones(bs, np.float32))
            for i in range(0, len(imgs) - bs + 1, bs)]


@pytest.fixture(scope="module")
def grads():
    """Mean CE gradients over two batches from each package: the JAX
    package's ``taylor_grads_accumulated`` and the port's."""
    out = {}
    for name in ("r18n",):
        spec, p, s = jax_model(name)
        imgs = images(8)
        labels = np.arange(8) % 6
        bl = batches(imgs, labels, 4)
        j = jax.device_get(jeng.taylor_grads_accumulated(spec, p, s, bl))
        tspec = treg.spec_from_dict(SPECS[name])
        tb = [tuple(torch.from_numpy(np.asarray(a)) for a in b) for b in bl]
        t = teng.taylor_grads_accumulated(tspec, tr.params_from_jax(p, "cpu"),
                                          tr.params_from_jax(s, "cpu"), tb)
        out[name] = (j, t)
    return out


def random_grads(params, seed=5):
    rng = np.random.default_rng(seed)
    if isinstance(params, dict):
        return {k: random_grads(v, seed + i) for i, (k, v) in enumerate(params.items())}
    return rng.standard_normal(np.shape(params)).astype(np.float32)


@pytest.mark.parametrize("round_to", [1, 8])
@pytest.mark.parametrize("global_pruning", [False, True], ids=["local", "global"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_select_channels_matches_jax(name, method, global_pruning, round_to, grads):
    spec, p, _ = jax_model(name)
    g = None
    if method == "taylor":  # the JAX package's own gradients where they are computed
        g = grads[name][0] if name in grads else random_grads(p)
    kw = dict(ratio=0.3, method=method, global_pruning=global_pruning, round_to=round_to,
              grads=g)
    ref = jeng.select_channels(spec, p, rng=np.random.default_rng(7), **kw)
    got = teng.select_channels(treg.spec_from_dict(SPECS[name]), p,
                               rng=np.random.default_rng(7), **kw)
    assert got.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=str(key))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_apply_pruning_and_spec_match_jax(name):
    spec, p, s = jax_model(name)
    kw = dict(ratio=0.3, method="l2", round_to=8 if name == "r18n" else 1, seed=3)
    j_spec, j_p, j_s = jeng.prune_model(spec, p, s, **kw)
    t_spec, t_p, t_s = teng.prune_model(treg.spec_from_dict(SPECS[name]), p, s, **kw)
    assert t_spec.to_dict() == j_spec.to_dict()
    assert t_spec != treg.spec_from_dict(SPECS[name])
    for got, ref in ((t_p, j_p), (t_s, j_s)):
        fg, fr = flat(got), flat(ref)
        assert fg.keys() == fr.keys()
        for k in fr:
            assert fg[k].shape == fr[k].shape and np.array_equal(fg[k], fr[k]), k
    # the inputs are left as they were
    np.testing.assert_array_equal(p["conv1"]["w"], resnet_params_from_seed(spec, 1)[0]["conv1"]["w"])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_zeroed_channel_prune_is_exact(name):
    """Zero ~25% of every group's channels (producer kernels and BN affine),
    prune exactly those: the smaller model's logits (port forward) equal the
    zeroed model's, within fp32 rounding (atol/rtol 1e-5)."""
    spec, params, state = jax_model(name)
    tspec = treg.spec_from_dict(SPECS[name])
    rng = np.random.default_rng(0)
    keep = {}
    for g in group_slices(tspec):
        w, lanes = g["width"], int(g.get("lanes", 1))
        per = w // lanes  # a lane group loses whole lanes
        kill_lanes = rng.choice(per, size=max(per // 4, 1), replace=False)
        kill = (kill_lanes[None, :] + (np.arange(lanes) * per)[:, None]).ravel()
        keep[tuple(g["key"])] = np.setdiff1d(np.arange(w), kill)
        for path, axis in g["producers"]:
            arr = np.asarray(get_path(params, path)).copy()
            sl = [slice(None)] * arr.ndim
            sl[axis] = kill
            arr[tuple(sl)] = 0.0
            set_path(params, path, arr)
        for bn_path in g["bns"]:
            bn = get_path(params, bn_path)
            for k in ("scale", "bias"):
                v = np.asarray(bn[k]).copy()
                v[kill] = 0.0
                bn[k] = v
    x = normalize_images(torch.from_numpy(images(2)))

    def logits(sp, p, s):
        with torch.no_grad():
            return tr.apply(sp, tr.params_from_jax(p, "cpu"), tr.params_from_jax(s, "cpu"),
                            x)[0].numpy()

    ref = logits(tspec, params, state)
    new_spec, new_p, new_s = teng.apply_pruning(tspec, params, state, keep)
    assert new_spec.stage_widths != tspec.stage_widths
    np.testing.assert_allclose(logits(new_spec, new_p, new_s), ref, rtol=1e-5, atol=1e-5)


def test_taylor_grads_accumulated_matches_jax(grads):
    j, t = grads["r18n"]
    fj, ft = flat(j), flat(t)
    assert fj.keys() == ft.keys()
    for k in fj:
        err = np.linalg.norm(ft[k].astype(np.float64) - fj[k]) / max(np.linalg.norm(fj[k]), 1e-30)
        assert err <= GRAD_RTOL, (k, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recalibrate_bn_matches_jax(dtype):
    spec, p, s = jax_model("r18n")
    imgs = images(20, seed=4)
    ref = jax.device_get(j_recal(spec, p, s, imgs, batch_size=8, num_batches=16,
                                 compute_dtype=dtype))
    got = recalibrate_bn(treg.spec_from_dict(SPECS["r18n"]), tr.params_from_jax(p, "cpu"),
                         tr.params_from_jax(s, "cpu"), imgs, batch_size=8, num_batches=16,
                         compute_dtype=dtype)
    fr, fg = flat(ref), flat(tr.params_to_jax(got))
    assert fr.keys() == fg.keys()
    for k in fr:
        err = np.abs(fg[k].astype(np.float64) - fr[k]).max() / np.abs(fr[k]).max()
        assert err <= RECAL_RTOL[dtype], (k, err)
        assert not np.array_equal(fr[k], flat(s)[k])  # the statistics did move


def test_prune_iterative_compounds_like_jax(tmp_path):
    """Three prune steps at (1-R)^(1/3) each: the same widths as the JAX
    engine's, and within 5% of the one-shot parameter count at R."""
    spec, p, s = jax_model("r18n")
    kw = dict(pruning_ratio=0.3, iterative_steps=3, iterative_ft_epochs=0,
              pruning_method="l2", round_to=1)
    j = jeng.StructuredPruningEngine(JPruningConfig(artifacts_root=str(tmp_path / "j"), **kw),
                                     spec, p, s, LOG)
    j.prune_iterative(None, None, None)
    tspec = treg.spec_from_dict(SPECS["r18n"])
    t = teng.StructuredPruningEngine(PruningConfig(artifacts_root=str(tmp_path / "t"), **kw),
                                     tspec, tr.params_from_jax(p, "cpu"),
                                     tr.params_from_jax(s, "cpu"), LOG, "cpu")
    t.prune_iterative(None, None, None)
    assert t.spec.to_dict() == j.spec.to_dict()
    n_once = tr.param_count(tr.params_from_jax(teng.prune_model(tspec, p, s, ratio=0.3)[1], "cpu"))
    assert abs(tr.param_count(t.params) - n_once) / n_once < 0.05


def test_other_families_raise():
    """A ViT goes to vit_engine (tests/test_torch_port_vit_prune.py), which
    needs its blocks; anything that is no spec of the four families raises."""
    from inference_efficient_vision_models_tpu_torch.models.vit import vit_spec

    with pytest.raises(KeyError, match="blocks"):
        teng.prune_model(vit_spec("vit_tiny_patch16_224"), {}, {}, ratio=0.1)
    with pytest.raises(TypeError):
        teng.prune_model(object(), {}, {}, ratio=0.1)
