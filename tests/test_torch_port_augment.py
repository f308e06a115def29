"""Train-time augmentation of the port (``data/augment.py``) against the JAX
package's ``augment_images``, on the CPU.

The port cannot reproduce ``jax.random``'s bits, so the JAX draws are made
here with the JAX package's own key splitting and handed to the port's
``apply_augment``, whose output must then EQUAL JAX's: the arithmetic is
float32 op by op on both sides. The one reduction, the contrast mean, is
summed in float64 by the port (so it is the same on every device) and in
float32 by XLA; where the two means round apart a value can land on the
other side of a .5 and move by one. Measured on these inputs (two keys,
8x32x32x3 each): 2 of 49,152 values one apart in "everything" (contrast
after the gradient and the noise), 0 in every other case; ``MAX_DIFFERING``
bounds the share the test accepts.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import resnet_params_from_seed
from inference_efficient_vision_models_tpu.data.augment import augment_images as j_augment
from inference_efficient_vision_models_tpu_torch.data.augment import (
    DEFAULTS,
    apply_augment,
    augment_generator,
    augment_images,
    augment_options,
    draw_augment,
    make_augment_fn,
)
from inference_efficient_vision_models_tpu_torch.models import registry as treg
from inference_efficient_vision_models_tpu_torch.train.optim import adamw_init, tree_leaves
from inference_efficient_vision_models_tpu_torch.train.steps import (
    make_kd_train_step,
    make_train_step,
)

try:
    from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from tests.test_torch_port_resnet_float import tiny_spec_dict
except ImportError:
    from test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from test_torch_port_resnet_float import tiny_spec_dict

OFF = {"crop_pad": 0, "flip": False, "rot180": False, "brightness": 0.0, "contrast": 0.0}
CASES = {
    "flip": {**OFF, "flip": True},
    "rot180": {**OFF, "rot180": True},
    "crop": {**OFF, "crop_pad": 6},
    "brightness": {**OFF, "brightness": 0.15},
    "contrast": {**OFF, "contrast": 0.2},
    "illum_gradient": {**OFF, "illum_gradient": 0.5},
    "noise": {**OFF, "noise": 0.05},
    "defaults": {},
    "everything": {"illum_gradient": 0.5, "noise": 0.05},
}
# values allowed one apart from JAX's (contrast: the mean's rounding, above)
MAX_DIFFERING = 0.001


def images(n=8, s=32, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, s, s, 3), dtype=np.uint8)


def jax_draws(key, n: int, h: int, w: int, opts: dict) -> dict:
    """The draws of ``augment_images(key, ...)``, by its own key splitting,
    in the port's ``draw_augment`` layout."""
    o = {**DEFAULTS, **opts}
    kf, kx, ky, kb, kc = jax.random.split(key, 5)
    d = {}
    if o["flip"] or o["rot180"]:
        d["flip" if o["flip"] else "rot180"] = jax.random.bernoulli(kf, 0.5, (n,))
    if o["crop_pad"]:
        p = int(o["crop_pad"])
        d["crop"] = (p, jax.random.randint(ky, (n,), 0, 2 * p + 1),
                     jax.random.randint(kx, (n,), 0, 2 * p + 1))
    b, c = o["brightness"], o["contrast"]
    if b:
        d["delta"] = jax.random.uniform(kb, (n, 1, 1, 1), minval=-b, maxval=b) * 255.0
    if c:
        d["fac"] = jax.random.uniform(kc, (n, 1, 1, 1), minval=1.0 - c, maxval=1.0 + c)
    g = o["illum_gradient"]
    if g:
        d["grad"] = jax.random.uniform(jax.random.fold_in(kc, 1), (n, 2, 1, 1, 1),
                                       minval=-g, maxval=g) * 255.0
    if o["noise"]:
        kn = jax.random.fold_in(kb, 1)
        d["noise"] = (jax.random.uniform(kn, (n, 1, 1, 1), maxval=o["noise"]) * 255.0,
                      jax.random.normal(jax.random.fold_in(kn, 2), (n, h, w, 1)))

    def to_torch(v):
        if isinstance(v, tuple):
            return tuple(to_torch(t) for t in v)
        return v if isinstance(v, int) else torch.from_numpy(np.array(v))

    return {k: to_torch(v) for k, v in d.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_augment_at_jax_draws_equals_jax(case):
    x = images()
    n, h, w, _ = x.shape
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(j_augment(key, jnp.asarray(x), **CASES[case]))
        got = apply_augment(torch.from_numpy(x), jax_draws(key, n, h, w, CASES[case])).numpy()
        assert got.dtype == np.uint8 and got.shape == x.shape
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= 1, (case, diff.max())
        assert (diff > 0).mean() <= MAX_DIFFERING, (case, int((diff > 0).sum()))
        if case in ("flip", "rot180", "crop"):  # pure data movement: exact
            np.testing.assert_array_equal(got, ref)


def test_identity_when_all_off_and_draw_shapes():
    x = torch.from_numpy(images())
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(augment_images(gen, x, **OFF).numpy(), x.numpy())
    d = draw_augment(torch.Generator().manual_seed(0), 8, 32, 32, CASES["everything"])
    assert sorted(d) == ["crop", "delta", "fac", "flip", "grad", "noise"]
    p, oy, ox = d["crop"]
    assert p == 16 and 0 <= int(oy.min()) and int(ox.max()) <= 32
    assert float(d["delta"].abs().max()) <= 0.15 * 255 and d["grad"].shape == (8, 2, 1, 1, 1)
    assert 0.8 <= float(d["fac"].min()) and float(d["fac"].max()) <= 1.2
    assert d["noise"][1].shape == (8, 32, 32, 1)


def test_deterministic_per_seed_and_step():
    class Cfg:
        augment = True
        augment_illum_gradient = 0.5

    fn = make_augment_fn(Cfg)
    assert augment_options(Cfg)["illum_gradient"] == 0.5 and augment_options(Cfg)["flip"]
    assert make_augment_fn(type("Off", (), {"augment": False})) is None
    x = torch.from_numpy(images())
    a = fn(augment_generator(42, 3, "cpu"), x)
    np.testing.assert_array_equal(a.numpy(), fn(augment_generator(42, 3, "cpu"), x).numpy())
    assert (a != fn(augment_generator(42, 4, "cpu"), x)).any()
    assert (a != fn(augment_generator(43, 3, "cpu"), x)).any()


def _model(spec):
    p, s = resnet_params_from_seed(spec, 1)
    return [treg.params_from_jax(spec, t, "cpu") for t in (p, s)]


def test_train_steps_augment_the_batch_they_are_given():
    """A CE step and a KD step with ``augment_fn`` equal the same steps
    without it fed the batch augmented beforehand from the generator of
    (seed, opt.step): teacher and student see one augmented batch."""
    spec = treg.spec_from_dict(tiny_spec_dict("basic"))
    fn = make_augment_fn(type("Cfg", (), {"augment": True}))
    x = torch.from_numpy(images(4, 32, seed=2))
    labels, mask = torch.tensor([0, 1, 2, 3]), torch.ones(4)
    aug = fn(augment_generator(7, 0, "cpu"), x)
    assert (aug != x).any()
    p, s = _model(spec)
    t_p, t_s = _model(spec)
    kw = dict(learning_rate=1e-3, compute_dtype="float32")
    for make, extra in ((lambda **k: make_train_step(spec, **k), ()),
                        (lambda **k: make_kd_train_step(spec, spec, alpha=0.5, temperature=4.0,
                                                        **k), (t_p, t_s))):
        runs = []
        for step, batch in ((make(augment_fn=fn, augment_seed=7, **kw), (x, labels, mask)),
                            (make(**kw), (aug, labels, mask))):
            params = copy.deepcopy(p)
            new_p, _, opt, m = step(params, copy.deepcopy(s), adamw_init(params), *extra, batch)
            runs.append((float(m["loss"]), opt.step, [t.clone() for t in
                                                       tree_leaves(new_p)]))
        (l1, s1, w1), (l2, s2, w2) = runs
        assert l1 == l2 and s1 == s2 == 1
        for a, b in zip(w1, w2):
            assert torch.equal(a, b)
