"""The port's float ViT (``models/vit.py``) as a model that trains, against
the JAX package's on the CPU: ``init`` (shapes, parameter count, the empty
state), the layout round trip, the forward in fp32 and bf16 through
``apply_model`` and ``features_and_logits``, one CE step and one KD step
(a ResNet-free pair of ViTs, and a KD step with the similarity-preserving
loss, which needs the ViT's ``head`` in ``features_and_logits``), the
forward-only ``fused_mlp``, checkpoints each package reads from the other,
and the timm state_dict converter against the JAX package's on
``tests/torch_ref.py:vit_tiny``.

The models are small (dim 64, depth 2, 4 heads, 32x32, patch 8) and their
weights come from ``chip_smoke.vit_params_from_seed``. Tolerances (fp32,
TF32 off): logits, losses and gradients within 1e-5 of their scale (the
CPU measures ~1e-7: the summation order only); bf16 logits within 0.015 of
the scale (bf16 products rounded at other places by XLA and torch; the CPU
measures ~4e-3).

Running this file as a script rewrites ``testdata/vit_train_step_jax.npz``
(the JAX package's CE step of ViT-S/16 and KD step of ViT-Tiny/16 against
it, AdamW update included, at batch 8 and 64x64, which ``chip_smoke.py``
holds the GPU against) and prints the port's deviation from it on the CPU
over 1-8 torch threads, the source of ``chip_smoke.VIT_TRAIN_LIMITS``
(~2 min): ``JAX_PLATFORMS=cpu python tests/test_torch_port_vit_float.py``."""

import os
import sys

import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import torch

from chip_smoke import vit_params_from_seed
from inference_efficient_vision_models_tpu.core import artifacts as jart
from inference_efficient_vision_models_tpu.data.pipeline import normalize_images as j_norm
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu.models import torch_import as jti
from inference_efficient_vision_models_tpu.models import vit as jvit
from inference_efficient_vision_models_tpu.train import losses as jl
from inference_efficient_vision_models_tpu_torch.core import artifacts as tart
from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images
from inference_efficient_vision_models_tpu_torch.models import registry as treg
from inference_efficient_vision_models_tpu_torch.models import torch_import as tti
from inference_efficient_vision_models_tpu_torch.models import vit as tvit
from inference_efficient_vision_models_tpu_torch.train import optim as to
from inference_efficient_vision_models_tpu_torch.train import steps as ts

try:
    from tests import torch_ref
    from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from tests.test_torch_port_resnet_float import flat
    from tests.test_torch_port_train import batch_np, t_batch
except ImportError:  # run as a script
    import torch_ref
    from test_torch_port_prune import one_thread  # noqa: F401
    from test_torch_port_resnet_float import flat
    from test_torch_port_train import batch_np, t_batch

TAU_F32, TAU_BF16 = 1e-5, 0.015


def tiny_spec(heads=4, seed_name="vit_test"):
    return jvit.ViTSpec(name=seed_name, patch=8, dim=64, depth=2, heads=heads, mlp_ratio=4.0,
                        num_classes=6, image_size=32)


def port_spec(spec):
    return treg.spec_from_dict(spec.to_dict())


def rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(ref).max())


@pytest.mark.parametrize("name", ["vit_tiny_patch16_224", "vit_small_patch16_224"])
def test_init_shapes_and_param_count_match_jax(name):
    """Leaf paths and shapes of ``init`` equal JAX's (shapes by
    ``jax.eval_shape``: no full-size draw on the CPU), the state is empty,
    and ``param_count`` agrees."""
    jspec = jvit.vit_spec(name, num_classes=6)
    ref, ref_state = jax.eval_shape(lambda k: jvit.init(k, jspec), jax.random.PRNGKey(0))
    got, state = tvit.init(port_spec(jspec), torch.Generator().manual_seed(0), device="cpu")
    assert state == {} and ref_state == {}
    paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    mine = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda v: isinstance(v, torch.Tensor))[0]
    assert [p for p, _ in mine] == [p for p, _ in paths]
    assert [tuple(v.shape) for _, v in mine] == [tuple(v.shape) for _, v in paths]
    assert tvit.param_count(got) == sum(int(np.prod(v.shape)) for _, v in paths)
    assert treg.model_module(port_spec(jspec)) is tvit


def test_layout_round_trip_is_the_identity():
    p = vit_params_from_seed(tiny_spec(), 2)
    back = tvit.params_to_jax(tvit.params_from_jax(p, "cpu"))
    assert flat(back).keys() == flat(p).keys()
    for k, v in flat(p).items():
        np.testing.assert_array_equal(flat(back)[k], v)
        assert flat(back)[k].dtype == np.float32
    pruned = tiny_spec().with_widths(head_counts=[2, 3], mlp_hidden=[64, 128])
    assert port_spec(tiny_spec()).with_widths(head_counts=[2, 3], mlp_hidden=[64, 128]) == \
        port_spec(pruned)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_model_and_features_match_jax(dtype):
    """``apply_model`` (logits, state) and ``features_and_logits`` (the ViT's
    ``head`` on the cls features) against JAX's, train and eval mode."""
    spec = tiny_spec()
    p = vit_params_from_seed(spec, 3)
    x = np.random.default_rng(1).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    jx, tx = j_norm(jnp.asarray(x)), normalize_images(torch.from_numpy(x))
    tp = tvit.params_from_jax(p, "cpu")
    tau = TAU_F32 if dtype == "float32" else TAU_BF16
    for train in (False, True):
        ref, rs = jreg.apply_model(spec, p, {}, jx, train=train,
                                   compute_dtype=getattr(jnp, dtype))
        with torch.no_grad():
            got, gs = treg.apply_model(port_spec(spec), tp, {}, tx, train=train,
                                       compute_dtype=getattr(torch, dtype))
        assert gs == {} and got.dtype == torch.float32
        assert rel(got.numpy(), ref) <= tau
    rf, rl, _ = jreg.features_and_logits(spec, p, {}, jx, compute_dtype=getattr(jnp, dtype))
    with torch.no_grad():
        gf, gl, _ = treg.features_and_logits(port_spec(spec), tp, {}, tx,
                                             compute_dtype=getattr(torch, dtype))
    assert gf.shape == (4, 64) and rel(gf.numpy(), rf) <= tau and rel(gl.numpy(), rl) <= tau


def test_fused_mlp_is_forward_only():
    spec = port_spec(tiny_spec())
    tp = tvit.params_from_jax(vit_params_from_seed(tiny_spec(), 3), "cpu")
    x = torch.zeros(2, 32, 32, 3)
    with torch.no_grad():
        a, _ = tvit.apply(spec, tp, {}, x, fused_mlp=True)
        b, _ = tvit.apply(spec, tp, {}, x)
    assert rel(a.numpy(), b.numpy()) <= TAU_F32
    tp["blocks"]["0"]["mlp1"]["w"].requires_grad_(True)
    with pytest.raises(ValueError, match="forward-only"):
        tvit.apply(spec, tp, {}, x, fused_mlp=True)


def jax_grads(spec_s, p, imgs, labels, mask, spec_t=None, tp=None, kd=None, sp_weight=0.0):
    """The JAX package's CE (``spec_t`` None) or KD (+ similarity-preserving)
    loss and gradient, as make_train_step / make_kd_train_step compute them."""
    x = j_norm(jnp.asarray(imgs), jnp.float32)
    if spec_t is not None:
        t_feats, t_logits, _ = jreg.features_and_logits(spec_t, tp, {}, x)

    def loss_fn(pp):
        feats, logits, _ = jreg.features_and_logits(spec_s, pp, {}, x, train=True,
                                                     compute_dtype=jnp.float32)
        if spec_t is None:
            return jl.cross_entropy(logits, labels, mask), logits
        total = jl.kd_loss(logits, t_logits, labels, mask=mask, **kd)[0]
        if sp_weight:
            total = total + sp_weight * jl.sp_kd_loss(feats, t_feats, mask)
        return total, logits

    return jax.value_and_grad(loss_fn, has_aux=True)(p)


def assert_grads_close(tp, t_grads, ref):
    got, ref = flat(tvit.params_to_jax(to.tree_like(tp, t_grads))), flat(jax.device_get(ref))
    assert got.keys() == ref.keys()
    top = max(np.abs(v).max() for v in ref.values())
    for k in ref:
        assert np.abs(got[k] - ref[k]).max() <= TAU_F32 * top, k


@pytest.mark.parametrize("sp_weight", [0.0, 0.5])
def test_ce_and_kd_steps_match_jax(sp_weight):
    """One fp32 CE step (a ViT teacher, 4 heads) and one KD step (a ViT
    student with 2 heads against it in eval mode); with ``sp_weight`` > 0
    the similarity-preserving loss on both models' cls features."""
    t_spec, s_spec = tiny_spec(4), tiny_spec(2)
    pt, ps = vit_params_from_seed(t_spec, 0), vit_params_from_seed(s_spec, 1)
    imgs, labels, mask = b = batch_np(n=8, size=32, pad=0)
    tb = t_batch(b)
    jb = (labels, mask)
    ttp, tsp = tvit.params_from_jax(pt, "cpu"), tvit.params_from_jax(ps, "cpu")

    (loss, logits), g = jax_grads(t_spec, pt, imgs, *jb)
    t_loss, t_logits, t_state, t_g = ts.ce_loss_and_grads(port_spec(t_spec), ttp, {}, tb,
                                                          compute_dtype="float32")
    assert t_state == {}
    assert float(t_loss) == pytest.approx(float(loss), rel=TAU_F32)
    assert rel(t_logits.numpy(), logits) <= TAU_F32
    assert_grads_close(ttp, t_g, g)

    kd = dict(alpha=0.5, temperature=4.0)
    (loss, logits), g = jax_grads(s_spec, ps, imgs, *jb, spec_t=t_spec, tp=pt, kd=kd,
                                  sp_weight=sp_weight)
    t_loss, parts, t_logits, _, t_g = ts.kd_loss_and_grads(
        port_spec(s_spec), port_spec(t_spec), tsp, {}, ttp, {}, tb, compute_dtype="float32",
        sp_weight=sp_weight, **kd)
    assert (float(parts["sp"]) > 0) == (sp_weight > 0)
    assert float(t_loss) == pytest.approx(float(loss), rel=TAU_F32)
    assert rel(t_logits.numpy(), logits) <= TAU_F32
    assert_grads_close(tsp, t_g, g)

    # the trainer's own step updates every leaf and keeps the state empty
    step = ts.make_kd_train_step(port_spec(s_spec), port_spec(t_spec), learning_rate=1e-3,
                                 compute_dtype="float32", sp_weight=sp_weight, **kd)
    p1 = tvit.params_from_jax(ps, "cpu")
    p1, st, opt, m = step(p1, {}, to.adamw_init(p1), ttp, {}, tb)
    assert st == {} and opt.step == 1 and np.isfinite(float(m["loss"]))
    assert all(not torch.equal(a, b) for a, b in zip(to.tree_leaves(p1), to.tree_leaves(tsp))
               if a.numel() > 1)


def test_mixed_family_kd_step_matches_jax():
    """A ResNet18 teacher (BatchNorm state, eval mode) distilled into a ViT
    student with the similarity-preserving loss on both models' pooled
    features, as JAX tests/test_vit.py:36 trains one: loss and gradients
    against JAX's."""
    from chip_smoke import resnet_params_from_seed

    rspec = jreg.make_spec("resnet18", 6)
    rp, rs = resnet_params_from_seed(rspec, 0)
    s_spec = jvit.ViTSpec(name="vit_test", patch=8, dim=64, depth=2, heads=2, mlp_ratio=2.0,
                          num_classes=6, image_size=32)
    ps = vit_params_from_seed(s_spec, 1)
    imgs, labels, mask = b = batch_np(n=8, size=32, pad=0)
    kd = dict(alpha=0.5, temperature=4.0)
    x = j_norm(jnp.asarray(imgs), jnp.float32)
    t_feats, t_logits, _ = jreg.features_and_logits(rspec, rp, rs, x)

    def loss_fn(pp):
        feats, logits, _ = jreg.features_and_logits(s_spec, pp, {}, x, train=True)
        total = jl.kd_loss(logits, t_logits, labels, mask=mask, **kd)[0]
        return total + 0.5 * jl.sp_kd_loss(feats, t_feats, mask)

    loss, g = jax.value_and_grad(loss_fn)(ps)
    tps = tvit.params_from_jax(ps, "cpu")
    t_loss, parts, _, _, t_g = ts.kd_loss_and_grads(
        port_spec(s_spec), treg.spec_from_dict(rspec.to_dict()), tps, {},
        treg.params_from_jax(treg.spec_from_dict(rspec.to_dict()), rp, "cpu"),
        treg.params_from_jax(treg.spec_from_dict(rspec.to_dict()), rs, "cpu"), t_batch(b),
        compute_dtype="float32", sp_weight=0.5, **kd)
    assert float(parts["sp"]) > 0
    assert float(t_loss) == pytest.approx(float(loss), rel=TAU_F32)
    assert_grads_close(tps, t_g, g)


def test_checkpoints_read_across_packages(tmp_path):
    """A checkpoint the port writes is the JAX package's bytes and reads back
    there (params, empty state, spec); one JAX writes reads in the port."""
    spec = tiny_spec().with_widths(head_counts=[3, 4], mlp_hidden=[64, 256])
    p = vit_params_from_seed(spec, 4)
    tart.save_checkpoint(str(tmp_path / "t"), "best", tvit.params_to_jax(
        tvit.params_from_jax(p, "cpu")), {}, port_spec(spec))
    jart.save_checkpoint(str(tmp_path / "j"), "best", p, {}, spec)
    assert (tmp_path / "t" / "model_best.msgpack").read_bytes() == \
        (tmp_path / "j" / "model_best.msgpack").read_bytes()
    raw = jart.load_checkpoint_raw(str(tmp_path / "t"), "best")
    assert raw["state"] == {}
    assert jreg.spec_from_dict(jart.load_spec_dict(str(tmp_path / "t"), "best")) == spec
    got = tart.load_checkpoint_raw(str(tmp_path / "j"), "best")
    for k, v in flat(p).items():
        np.testing.assert_array_equal(flat(got["params"])[k], v)
    assert treg.spec_from_dict(tart.load_spec_dict(str(tmp_path / "j"), "best")) == \
        port_spec(spec)


def test_torch_state_dict_converter_matches_jax(tmp_path):
    """``from_torch_state_dict_vit`` on a random timm-layout ViT-Tiny at
    img_size 64 gives the JAX converter's leaves, and the forward matches
    the torch module's; ``load_pretrained`` keeps the given head."""
    tm = torch_ref.vit_tiny(num_classes=6, img_size=64)
    sd = tm.state_dict()
    spec = jvit.vit_spec("vit_tiny_patch16_224", num_classes=6, image_size=64)
    ref, _ = jti.from_torch_state_dict_vit(spec, sd)
    got, state = tti.from_torch_state_dict_vit(port_spec(spec), sd)
    assert state == {}
    fr, fg = flat(ref), flat(tvit.params_to_jax(got))
    assert fr.keys() == fg.keys()
    for k in fr:
        np.testing.assert_array_equal(fg[k], fr[k])
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        want = tm.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        out, _ = tvit.apply(port_spec(spec), got, {}, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4)
    path = tmp_path / "vit_tiny_patch16_224.pth"
    torch.save(sd, path)
    fresh, _ = tvit.init(port_spec(spec), torch.Generator().manual_seed(0), device="cpu")
    p2, s2 = tti.load_pretrained(port_spec(spec), fresh, {}, path=str(path))
    assert p2["head"] is fresh["head"] and s2 == {}
    np.testing.assert_array_equal(p2["blocks"]["3"]["qkv"]["w"].numpy(),
                                  fr["/blocks/3/qkv/w"])


def test_train_step_golden_is_current():
    """The committed golden was made from the weights and batch that
    ``chip_smoke.step_weights`` / ``train_step_batch`` give today."""
    from chip_smoke import (UPDATE_LEAF_MAX, VIT_TRAIN_GOLDEN, VIT_TRAIN_STEP, _flat_sorted,
                            leaf_sums, step_weights, train_step_batch)

    golden = np.load(VIT_TRAIN_GOLDEN)
    for role, (p, s) in step_weights(VIT_TRAIN_STEP).items():
        np.testing.assert_array_equal(leaf_sums(p), golden[f"{role}_param_sums"])
        assert s == {} and golden[f"{role}_bn_names"].size == 0
        kept = [k for k, v in _flat_sorted(p).items() if v.size <= UPDATE_LEAF_MAX]
        assert list(golden[f"{role}_update_names"]) == kept
    imgs, labels, _ = train_step_batch(VIT_TRAIN_STEP)
    assert int(golden["image_sum"]) == int(imgs.sum(dtype=np.int64))
    np.testing.assert_array_equal(golden["labels"], labels)


def write_train_step_golden() -> None:
    """The JAX package's fp32 CE step (ViT-S/16) and KD step (ViT-Tiny/16
    against it in eval mode) on the CPU at batch 8, 64x64, reduced to what
    chip_smoke.py compares (``train_step_metrics``); then the port's
    deviation from it on the CPU over 1-8 threads."""
    from chip_smoke import (VIT_TRAIN_GOLDEN, VIT_TRAIN_STEP, compare_train_step, leaf_sums,
                            port_train_step, step_weights, train_step_batch, train_step_metrics)
    from inference_efficient_vision_models_tpu.train import optim as jo
    from inference_efficient_vision_models_tpu.train import steps as js

    cfg = VIT_TRAIN_STEP
    imgs, labels, mask = b = train_step_batch(cfg)
    jb = tuple(jnp.asarray(a) for a in b)
    specs = {r: jvit.vit_spec(cfg[r], 6, image_size=cfg["size"]) for r in ("teacher", "student")}
    weights = step_weights(cfg)
    out = {"labels": labels, "image_sum": np.int64(imgs.sum(dtype=np.int64))}
    for r in weights:
        out[f"{r}_param_sums"] = leaf_sums(weights[r][0])
        out[f"{r}_state_sums"] = leaf_sums(weights[r][1])
    kd = dict(alpha=cfg["alpha"], temperature=cfg["temperature"])
    p, _ = weights["teacher"]
    (loss, logits), g = jax.jit(lambda pp: jax_grads(specs["teacher"], pp, imgs, labels,
                                                     mask))(p)
    step = js.make_train_step(specs["teacher"], learning_rate=cfg["lr"], compute_dtype="float32")
    p2, _, opt, _ = jax.device_get(step(p, {}, jo.adamw_init(p), jb))
    out.update(train_step_metrics("teacher", float(loss), np.asarray(logits), jax.device_get(g),
                                  {}, p, p2, opt.mu, opt.nu, lr=cfg["lr"]))
    p, _ = weights["student"]
    tp = weights["teacher"][0]
    (loss, logits), g = jax.jit(lambda pp: jax_grads(specs["student"], pp, imgs, labels, mask,
                                                     specs["teacher"], tp, kd))(p)
    step = js.make_kd_train_step(specs["student"], specs["teacher"], learning_rate=cfg["lr"],
                                 compute_dtype="float32", **kd)
    p2, _, opt, _ = jax.device_get(step(p, {}, jo.adamw_init(p), tp, {}, jb))
    out.update(train_step_metrics("student", float(loss), np.asarray(logits), jax.device_get(g),
                                  {}, p, p2, opt.mu, opt.nu, lr=cfg["lr"]))
    np.savez_compressed(VIT_TRAIN_GOLDEN, **out)
    print(f"wrote {VIT_TRAIN_GOLDEN} ({os.path.getsize(VIT_TRAIN_GOLDEN)} bytes)")
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
