"""Checkpoint interop: torchvision-style ResNet state_dicts -> the port's
(params, state), the ResNet part of the JAX package's
``models/torch_import.py``.

The reference's artifacts are torch ``state_dict`` pickles, sometimes wrapped
in ``{"model_state_dict": ...}`` and sometimes carrying a ``module.`` prefix
from DataParallel training; ``_strip`` removes both. Conv kernels stay OIHW
(the port's layout; ``resnet.place`` gives them their device's memory
layout); linear (O, I) becomes (I, O).
Pretrained weights come from an on-disk cache of ``.pth`` files only
(``$IEVM_WEIGHTS_DIR``, then ``$TORCH_HOME/hub/checkpoints``): nothing is
downloaded. The MobileNetV2, EfficientNet and ViT converters are not ported
yet (ROADMAP queue 1: ``torch_import`` for the other families).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Any, Dict, Tuple

import torch

from .resnet import place
from .widths import ResNetSpec


def _strip(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    if "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        # a copy, in fp32 on the CPU: the source may be mutated in place
        # later (BN running stats during a training forward)
        out[k] = torch.as_tensor(v).detach().to("cpu", torch.float32).clone()
    return out


def _family_check(spec) -> None:
    if not isinstance(spec, ResNetSpec):
        raise NotImplementedError(
            f"torch_import for {type(spec).__name__[:-4]} is not ported yet "
            f"(ROADMAP queue 1: torch_import for the other families)")


def from_torch_state_dict(spec: ResNetSpec, sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """(params, state) on the CPU from a torchvision-style ResNet state_dict."""
    _family_check(spec)
    sd = _strip(sd)

    def conv(key):
        return {"w": sd[key]}

    def bn(prefix):
        p = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
        s = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
        return p, s

    params: Dict[str, Any] = {"conv1": conv("conv1.weight")}
    state: Dict[str, Any] = {}
    params["bn1"], state["bn1"] = bn("bn1")
    n_convs = 2 if spec.block == "basic" else 3
    for s_i, depth in enumerate(spec.depths):
        lname = f"layer{s_i + 1}"
        lp, ls = {}, {}
        for b in range(depth):
            bp, bs = {}, {}
            for c in range(1, n_convs + 1):
                bp[f"conv{c}"] = conv(f"{lname}.{b}.conv{c}.weight")
                bp[f"bn{c}"], bs[f"bn{c}"] = bn(f"{lname}.{b}.bn{c}")
            if f"{lname}.{b}.downsample.0.weight" in sd:
                bp["down_conv"] = conv(f"{lname}.{b}.downsample.0.weight")
                bp["down_bn"], bs["down_bn"] = bn(f"{lname}.{b}.downsample.1")
            lp[str(b)], ls[str(b)] = bp, bs
        params[lname], state[lname] = lp, ls
    params["fc"] = {"w": sd["fc.weight"].t().contiguous(), "b": sd["fc.bias"]}
    return params, state


def _load_state_dict(path: str) -> Dict[str, Any]:
    # a full pickled module (the reference's pruned artifacts) needs the
    # pickle path, as in the JAX package: load only files you trust
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def load_torch_checkpoint(spec: ResNetSpec, path: str) -> Tuple[Dict, Dict]:
    """Load a reference ``.pth`` checkpoint (torch pickle) from disk -> CPU (params, state)."""
    _family_check(spec)
    return from_torch_state_dict(spec, _load_state_dict(path))


def cached_weight_dirs():
    env = os.environ.get("IEVM_WEIGHTS_DIR")
    torch_home = os.environ.get(
        "TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache", "torch")
    )
    dirs = [env] if env else []
    dirs.append(os.path.join(torch_home, "hub", "checkpoints"))
    return [d for d in dirs if d and os.path.isdir(d)]


def find_cached_weights(name: str):
    """-> path of a cached ``.pth`` for a model name (``<name>.pth``,
    ``<name>-*.pth`` or ``<name>_*.pth``, torchvision's cache naming), or None."""
    for d in cached_weight_dirs():
        exact = os.path.join(d, f"{name}.pth")
        if os.path.exists(exact):
            return exact
        hits = sorted(glob.glob(os.path.join(d, f"{name}-*.pth"))
                      + glob.glob(os.path.join(d, f"{name}_*.pth")))
        if hits:
            return hits[0]
    return None


def load_pretrained(spec, params, state, *, path: str | None = None):
    """ImageNet-init from a cached torch state_dict, keeping the given
    (random) classifier head; the result is on the head's device.

    Raises FileNotFoundError when no cache entry exists for ``spec.name``."""
    if path is None:
        path = find_cached_weights(spec.name)
    if path is None:
        raise FileNotFoundError(
            f"no cached weights for {spec.name!r} in "
            f"{cached_weight_dirs() or '$IEVM_WEIGHTS_DIR (unset)'}"
        )
    _family_check(spec)
    sd = _strip(_load_state_dict(path))
    rows = int(sd["fc.weight"].shape[0])
    spec_full = dataclasses.replace(spec, num_classes=rows) if rows != spec.num_classes else spec
    p2, s2 = from_torch_state_dict(spec_full, sd)
    dev = params["fc"]["w"].device
    p2, s2 = place(p2, dev), place(s2, dev)
    p2["fc"] = params["fc"]
    return p2, s2
