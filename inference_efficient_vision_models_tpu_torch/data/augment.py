"""Device-side train-time augmentation, the port of the JAX package's
``data/augment.py``: random horizontal flip (or 180° rotation), random
crop from an edge-padded image, brightness and contrast jitter, and the
optional illumination-gradient and pixel-noise jitter, on the batch's own
device inside the train step.

The work is split in two: ``draw_augment`` draws every random number of a
batch from an explicit ``torch.Generator`` (seeded per (seed, step) by the
train step through ``core/prng``), and ``apply_augment`` is a deterministic
function of the images and those draws. The port cannot reproduce
``jax.random``'s bits, so the tests feed ``apply_augment`` the JAX
package's own draws and hold its output to ``augment_images``'s.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..core.prng import generator_for

# augment_images's keyword options and their defaults (the JAX package's)
DEFAULTS = {"crop_pad": 16, "flip": True, "rot180": False, "brightness": 0.15,
            "contrast": 0.2, "illum_gradient": 0.0, "noise": 0.0}


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return lo + (hi - lo) * u


def draw_augment(gen: torch.Generator, n: int, h: int, w: int, opts: Dict) -> Dict:
    """Every random number of one batch, on ``gen``'s device. ``opts``: the
    keyword options of ``augment_images`` (missing ones take ``DEFAULTS``).
    -> {"flip" or "rot180": bool (n,), "crop": (pad, oy (n,), ox (n,)),
    "delta": (n,1,1,1), "fac": (n,1,1,1), "grad": (n,2,1,1,1),
    "noise": (sigma (n,1,1,1), normal (n,h,w,1))}, one key per option that
    is on; the intensities are already in units of 0..255."""
    o = {**DEFAULTS, **opts}
    dev = gen.device
    d: Dict = {}
    if o["flip"] or o["rot180"]:
        d["flip" if o["flip"] else "rot180"] = torch.rand(n, generator=gen, device=dev) < 0.5
    if o["crop_pad"]:
        p = int(o["crop_pad"])
        oy = torch.randint(0, 2 * p + 1, (n,), generator=gen, device=dev)
        ox = torch.randint(0, 2 * p + 1, (n,), generator=gen, device=dev)
        d["crop"] = (p, oy, ox)
    b, c = float(o["brightness"]), float(o["contrast"])
    if b:
        d["delta"] = _uniform(gen, (n, 1, 1, 1), -b, b) * 255.0
    if c:
        d["fac"] = _uniform(gen, (n, 1, 1, 1), 1.0 - c, 1.0 + c)
    g = float(o["illum_gradient"])
    if g:
        d["grad"] = _uniform(gen, (n, 2, 1, 1, 1), -g, g) * 255.0
    s = float(o["noise"])
    if s:
        d["noise"] = (_uniform(gen, (n, 1, 1, 1), 0.0, s) * 255.0,
                      torch.randn((n, h, w, 1), generator=gen, device=dev))
    return d


def apply_augment(imgs_u8: torch.Tensor, draws: Dict) -> torch.Tensor:
    """uint8 NHWC -> augmented uint8 NHWC, the JAX ``augment_images``
    arithmetic in float32 at the given draws. The contrast mean is summed in
    float64 and rounded once to float32, so it is the same on every device."""
    n, h, w, c = imgs_u8.shape
    x = imgs_u8.float()
    if "flip" in draws:
        x = torch.where(draws["flip"][:, None, None, None], x.flip(2), x)
    if "rot180" in draws:
        x = torch.where(draws["rot180"][:, None, None, None], x.flip(1, 2), x)
    if "crop" in draws:
        p, oy, ox = draws["crop"]
        xp = F.pad(x.permute(0, 3, 1, 2), (p, p, p, p), mode="replicate").permute(0, 2, 3, 1)
        ar = lambda k: torch.arange(k, device=x.device)  # noqa: E731
        x = xp[ar(n)[:, None, None, None], (oy[:, None] + ar(h))[:, :, None, None],
               (ox[:, None] + ar(w))[:, None, :, None], ar(c)]
    if "delta" in draws:
        x = x + draws["delta"]
    if "fac" in draws:
        mean = x.double().mean(dim=(1, 2, 3), keepdim=True).float()
        x = (x - mean) * draws["fac"] + mean
    if "grad" in draws:
        g = draws["grad"]
        yy = (torch.arange(h, dtype=torch.float32, device=x.device)
              / torch.tensor(float(h), device=x.device) - 0.5)[None, :, None, None]
        xx = (torch.arange(w, dtype=torch.float32, device=x.device)
              / torch.tensor(float(w), device=x.device) - 0.5)[None, None, :, None]
        x = x + g[:, 0] * xx + g[:, 1] * yy
    if "noise" in draws:
        sig, z = draws["noise"]
        x = x + sig * z
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def augment_images(gen: torch.Generator, imgs_u8: torch.Tensor, **opts) -> torch.Tensor:
    """uint8 NHWC -> augmented uint8 NHWC with draws from ``gen`` (the
    options and defaults of the JAX package's ``augment_images``)."""
    n, h, w, _ = imgs_u8.shape
    return apply_augment(imgs_u8, draw_augment(gen, n, h, w, opts))


def augment_options(cfg) -> Dict:
    """A stage config's ``augment_*`` fields -> ``augment_images`` options."""
    return {k: type(v)(getattr(cfg, f"augment_{k}", v)) for k, v in DEFAULTS.items()}


def make_augment_fn(cfg):
    """cfg -> ``fn(gen, imgs_u8)``, or None when ``cfg.augment`` is falsy."""
    if not getattr(cfg, "augment", False):
        return None
    opts = augment_options(cfg)

    def fn(gen: torch.Generator, imgs_u8: torch.Tensor) -> torch.Tensor:
        return augment_images(gen, imgs_u8, **opts)

    return fn


def augment_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step ``step``: the same draws for the same
    (seed, step), as the JAX package's ``fold_in(PRNGKey(seed), step)``."""
    return generator_for(seed, "augment", int(step), device=device)

