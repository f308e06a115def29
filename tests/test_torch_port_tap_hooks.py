"""The ``tap_fn`` hook of the port's four family executors (``apply_folded``
of qresnet, qeffnet, qmobilenet and qvit), the sensitivity sweep and the
automix search, against the JAX package on the CPU (the sweeps against it
run op by op: jitted, XLA's weight scales sit one ulp from the
conversion's): a basic ResNet and a
grouped-bottleneck one (one block a stage), EfficientNet-B0 and
MobileNetV2-0.5 at full depth, and a two-block ViT, at 32x32, weights from
``chip_smoke.params_from_seed``.

The hook sees the JAX package's tap names in its order (NHWC), an identity
hook leaves the logits bit for bit as they were, and a fake-quant hook
gives the JAX package's logits within ``FQ_TAU`` of their scale (JAX jitted:
XLA divides by a scale as a multiply by its reciprocal, so a value at a
rounding edge moves a quantum there). The ViT's hook takes the taps
forward, which stays differentiable.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import params_from_seed
from inference_efficient_vision_models_tpu.compress.quant import automix as jauto
from inference_efficient_vision_models_tpu.compress.quant import qat as jqat
from inference_efficient_vision_models_tpu.compress.quant import quant_module as j_quant_module
from inference_efficient_vision_models_tpu.compress.quant import sensitivity as jsens
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu_torch.compress.quant import automix as tauto
from inference_efficient_vision_models_tpu_torch.compress.quant import qat as tqat
from inference_efficient_vision_models_tpu_torch.compress.quant import sensitivity as tsens
from inference_efficient_vision_models_tpu_torch.compress.quant.engine import (
    place_folded,
    quant_module,
)
from inference_efficient_vision_models_tpu_torch.compress.quant.observers import (
    ObserverState,
    minmax_qparams_affine,
)
from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches, normalize_images
from inference_efficient_vision_models_tpu_torch.models import registry as treg

try:
    from tests.test_torch_port_prune import one_thread  # noqa: F401
    from tests.test_torch_port_resnet_float import tiny_spec_dict
except ImportError:
    from test_torch_port_prune import one_thread  # noqa: F401
    from test_torch_port_resnet_float import tiny_spec_dict

FAMILIES = {
    "resnet_basic": tiny_spec_dict("basic"),
    "resnext": tiny_spec_dict("bottleneck", 2),
    "b0": "efficientnet_b0",
    "mbv2": "mobilenet_v2_050",
    "vit": dict(__kind__="vit", name="vit_test", patch=8, dim=64, depth=2, heads=4,
                mlp_ratio=4.0, num_classes=6, image_size=32),
}
# the fake-quant hook's logits vs JAX's, over their scale: fp32 summation
# order (measured <= 3.3e-7), B0 0.03 (measured 0.0107: a value at a rounding
# edge moves a quantum in an early block and B0's random-init blocks amplify
# it, ROADMAP queue 3's EfficientNet entry)
FQ_TAU = {"resnet_basic": 1e-6, "resnext": 1e-6, "b0": 0.03, "mbv2": 1e-6, "vit": 1e-6}
# sensitivity and automix logit RMSE, port vs JAX, relative (measured < 1e-5)
RMSE_RTOL = 1e-3


@functools.lru_cache(maxsize=None)
def family(name):
    """(JAX spec, port spec, JAX qmod, port qmod, folded (JAX layout, numpy),
    8 surrogate-like float images (NHWC), the port's observers on them)."""
    sd = FAMILIES[name]
    jspec = jreg.make_spec(sd, 6) if isinstance(sd, str) else jreg.spec_from_dict(sd)
    tspec = treg.spec_from_dict(jspec.to_dict())
    folded = quant_module(tspec).fold(tspec, *params_from_seed(tspec, 0))
    imgs = np.random.default_rng(2).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    obs = quant_module(tspec).calibrate(tspec, place_folded(tspec, folded, "cpu"),
                                        Batches(imgs, np.zeros(8, np.int32), 8, "cpu"),
                                        max_images=8)
    x = normalize_images(torch.from_numpy(imgs)).numpy()
    return jspec, tspec, j_quant_module(jspec), quant_module(tspec), folded, x, obs


def jax_forward(name, hook_kind):
    """The JAX package's jitted ``apply_folded`` with a hook: ``"names"``
    records the tap names in order, ``"fq"`` fake-quantizes every tap but the
    input to the port's observers -> (logits, names)."""
    jspec, _, jq, _, folded, x, obs = family(name)
    qp = {n: minmax_qparams_affine(o.min, o.max) for n, o in obs.items()}
    names = []

    def hook(n, t):
        names.append(n)
        return t if hook_kind == "names" or n == "input" else jqat.fake_quant_act(t, *qp[n])

    fn = jax.jit(lambda f, v: jq.apply_folded(jspec, f, v, tap_fn=hook))
    return np.asarray(fn(jax.tree.map(jnp.asarray, folded), jnp.asarray(x))), names


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tap_fn_names_identity_and_fake_quant(name):
    _, tspec, _, tq, folded, x, obs = family(name)
    placed = place_folded(tspec, folded, "cpu")
    xt = torch.from_numpy(x)
    names, seen = [], {}

    def capture(n, t):
        names.append(n)
        seen[n] = t
        return t

    with torch.no_grad():
        tapped, taps = tq.apply_folded(tspec, placed, xt, with_taps=True)
        hooked = tq.apply_folded(tspec, placed, xt, tap_fn=capture)
        plain = tq.apply_folded(tspec, placed, xt)
    _, j_names = jax_forward(name, "names")
    assert names == j_names == list(taps)
    # the hook sees what with_taps records (NHWC for the CNNs' 4D taps)
    assert all(torch.equal(seen[n], taps[n]) for n in names)
    assert torch.equal(hooked, tapped)
    if name != "vit":  # the ViT's untapped forward is vit.apply, another order of operations
        assert torch.equal(hooked, plain)

    hook = tqat.act_hook(obs, torch.device("cpu"))
    with torch.no_grad():
        fq = tq.apply_folded(tspec, placed, xt, tap_fn=hook).numpy()
    j_fq, _ = jax_forward(name, "fq")
    dev = float(np.abs(fq - j_fq).max() / np.abs(j_fq).max())
    assert dev <= FQ_TAU[name], dev


def test_vit_hook_is_differentiable():
    """The ViT's hooked forward (the taps forward, no fused MLP) backpropagates
    to every leaf."""
    _, tspec, _, tq, folded, x, obs = family("vit")
    params = tqat.tensor_tree(folded, "cpu")
    batch = (torch.from_numpy(np.random.default_rng(2).integers(0, 256, (8, 32, 32, 3),
                                                                dtype=np.uint8)),
             torch.arange(8) % 6, torch.ones(8))
    loss, _, grads = tqat.fq_loss_and_grads(tspec, tq, params, batch, tqat.fq_weights,
                                           tqat.act_hook(obs, torch.device("cpu")))
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    assert sum(int(g.abs().sum() > 0) for g in grads) == len(grads)


# --------------------------------------------------------------------------
# the sensitivity sweep and the automix search
# --------------------------------------------------------------------------


def sweep_case():
    """The basic ResNet with 32 images and the port's observers, two of them
    narrowed to an eighth of their range so that clipping there flips
    decisions: a case with wide margins between the taps."""
    jspec, tspec, jq, tq, folded, _, _ = family("resnet_basic")
    imgs = np.random.default_rng(5).integers(0, 256, (32, 32, 32, 3), dtype=np.uint8)
    labels = (np.arange(32) % 6).astype(np.int32)
    obs = tq.calibrate(tspec, place_folded(tspec, folded, "cpu"),
                       Batches(imgs, labels, 8, "cpu"), max_images=32)
    obs = {n: ObserverState(o.min, o.max / 8, True) if n in NARROW else o
           for n, o in obs.items()}
    return jspec, tspec, jq, tq, folded, (imgs, labels), obs


NARROW = ("l1b0o", "l2b0i0")


def test_sensitivity_matches_jax():
    """Rows by tap name: the same taps, ``logit_rmse`` within ``RMSE_RTOL``
    relative, flips within one image, the aggregate rows last, and the same
    two leading taps in the same order (their gap asserted)."""
    jspec, tspec, jq, tq, folded, data, obs = sweep_case()
    with jax.disable_jit():
        want = jsens.tap_sensitivity(jspec, jq, folded, obs, data, batch_size=8)
    got = tsens.tap_sensitivity(tspec, tq, folded, obs, data, batch_size=8, device="cpu")
    assert [r["tap"] for r in got][-2:] == ["__weights__", "__all__"]
    assert sorted(r["tap"] for r in got) == sorted(r["tap"] for r in want)
    w = {r["tap"]: r for r in want}
    for r in got:
        assert abs(r["logit_rmse"] - w[r["tap"]]["logit_rmse"]) <= RMSE_RTOL * w[r["tap"]][
            "logit_rmse"] + 1e-9, r
        assert abs(r["top1_flips"] - w[r["tap"]]["top1_flips"]) <= 1 / 32 + 1e-9, r
    # the two narrowed taps lead, apart by more than twice the tolerance
    assert set(r["tap"] for r in want[:2]) == set(NARROW)
    assert want[0]["logit_rmse"] - want[1]["logit_rmse"] > 2 * RMSE_RTOL * want[0]["logit_rmse"]
    assert want[1]["logit_rmse"] > 10 * want[2]["logit_rmse"]
    assert [r["tap"] for r in got][:2] == [r["tap"] for r in want][:2]


def test_automix_matches_jax():
    """The chosen float taps equal the JAX package's, on a case whose margins
    this test asserts: the two narrowed taps lead the ranking by far, and the
    chosen rung's flip rate sits at least one image inside the budget while
    the rung before sits at least one image outside it."""
    jspec, tspec, jq, tq, folded, data, obs = sweep_case()
    budget = 0.15
    with jax.disable_jit():
        j_taps, j_ladder = jauto.auto_mixed_policy(jspec, jq, folded, obs, data, batch_size=8,
                                                   flip_budget=budget)
    t_taps, t_ladder = tauto.auto_mixed_policy(tspec, tq, folded, obs, data, batch_size=8,
                                               flip_budget=budget, device="cpu")
    k = len(j_taps)
    assert k >= 1 and j_ladder[k]["top1_flips"] <= budget - 1 / 32
    assert j_ladder[k - 1]["top1_flips"] >= budget + 1 / 32
    assert t_taps == j_taps and len(t_ladder) == len(j_ladder)
    for a, b in zip(t_ladder, j_ladder):
        assert a["k"] == b["k"] and a["float_taps"] == b["float_taps"]
        assert abs(a["top1_flips"] - b["top1_flips"]) <= 1 / 32 + 1e-9
        assert abs(a["acc"] - b["acc"]) <= 1 / 32 + 1e-9
        assert abs(a["logit_rmse"] - b["logit_rmse"]) <= RMSE_RTOL * b["logit_rmse"] + 1e-9

