"""Checkpoint interop: torchvision-style ResNet, EfficientNet and MobileNetV2
state_dicts -> the port's (params, state), the CNN parts of the JAX
package's ``models/torch_import.py``.

The reference's artifacts are torch ``state_dict`` pickles, sometimes wrapped
in ``{"model_state_dict": ...}`` and sometimes carrying a ``module.`` prefix
from DataParallel training; ``_strip`` removes both. Conv kernels stay OIHW
(the port's layout, a depthwise kernel (C, 1, k, k); ``resnet.place`` gives
them their device's memory layout); linear (O, I) and an SE 1x1 conv
(O, I, 1, 1) become (I, O).
Pretrained weights come from an on-disk cache of ``.pth`` files only
(``$IEVM_WEIGHTS_DIR``, then ``$TORCH_HOME/hub/checkpoints``): nothing is
downloaded. The ViT converter is not ported yet (ROADMAP queue 1 item 15):
the port does not build the float ViT from a torch checkpoint.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Any, Dict, Tuple

import torch

from .efficientnet import EfficientNetSpec
from .mobilenet import MobileNetV2Spec
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
    if not isinstance(spec, (ResNetSpec, EfficientNetSpec, MobileNetV2Spec)):
        raise NotImplementedError(
            f"torch_import for {type(spec).__name__[:-4]} is not ported yet "
            f"(ROADMAP queue 1 item 15)")


def from_torch_state_dict(spec: ResNetSpec, sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """(params, state) on the CPU from a torchvision-style ResNet state_dict."""
    _family_check(spec)
    sd = _strip(sd)

    def conv(key):
        return {"w": sd[key]}

    bn = _bn(sd)
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


def _bn(sd):
    def bn(prefix):
        p = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
        s = {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]}
        return p, s
    return bn


def from_torch_state_dict_effnet(spec: EfficientNetSpec, sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """(params, state) on the CPU from a torchvision-style EfficientNet
    state_dict: ``features.0.{0,1}`` stem, ``features.{s+1}.{b}.block.{j}``
    MBConv with j = expand?, dw, SE (``fc1``/``fc2``, 1x1 convs with bias),
    project; ``features.{stages+1}.{0,1}`` last conv, ``classifier.1`` head."""
    sd = _strip(sd)
    bn = _bn(sd)

    def conv(key):
        return {"w": sd[key]}

    def se_fc(prefix):
        return {"w": sd[f"{prefix}.weight"][:, :, 0, 0].t().contiguous(),
                "b": sd[f"{prefix}.bias"]}

    params: Dict[str, Any] = {"stem": conv("features.0.0.weight")}
    state: Dict[str, Any] = {}
    params["stem_bn"], state["stem_bn"] = bn("features.0.1")
    for s_i, depth in enumerate(spec.depths):
        lp, ls = {}, {}
        for b in range(depth):
            pre = f"features.{s_i + 1}.{b}.block"
            bp, bs = {}, {}
            if spec.has_expand[s_i][b]:
                bp["expand"] = conv(f"{pre}.0.0.weight")
                bp["expand_bn"], bs["expand_bn"] = bn(f"{pre}.0.1")
                dw_i, se_i, proj_i = 1, 2, 3
            else:
                dw_i, se_i, proj_i = 0, 1, 2
            bp["dw"] = conv(f"{pre}.{dw_i}.0.weight")
            bp["dw_bn"], bs["dw_bn"] = bn(f"{pre}.{dw_i}.1")
            bp["se_reduce"] = se_fc(f"{pre}.{se_i}.fc1")
            bp["se_expand"] = se_fc(f"{pre}.{se_i}.fc2")
            bp["project"] = conv(f"{pre}.{proj_i}.0.weight")
            bp["project_bn"], bs["project_bn"] = bn(f"{pre}.{proj_i}.1")
            lp[str(b)], ls[str(b)] = bp, bs
        params[f"stage{s_i}"], state[f"stage{s_i}"] = lp, ls
    last_i = len(spec.depths) + 1
    params["last"] = conv(f"features.{last_i}.0.weight")
    params["last_bn"], state["last_bn"] = bn(f"features.{last_i}.1")
    params["fc"] = {"w": sd["classifier.1.weight"].t().contiguous(), "b": sd["classifier.1.bias"]}
    return params, state


def from_torch_state_dict_mbv2(spec: MobileNetV2Spec, sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """(params, state) on the CPU from a torchvision-style MobileNetV2
    state_dict: ``features.0.{0,1}`` stem, ``features.i.conv.{0.0, 0.1, 1.0,
    1.1, 2, 3}`` inverted residuals (t > 1) or ``conv.{0.0, 0.1, 1, 2}``
    (t = 1), numbered i = 1, 2, ... over all blocks, then the last conv
    ``features.{i}.{0,1}`` and the ``classifier.1`` head."""
    sd = _strip(sd)
    bn = _bn(sd)

    def conv(key):
        return {"w": sd[key]}

    params: Dict[str, Any] = {"stem": conv("features.0.0.weight")}
    state: Dict[str, Any] = {}
    params["stem_bn"], state["stem_bn"] = bn("features.0.1")
    feat_i = 1
    for s_i, depth in enumerate(spec.depths):
        lp, ls = {}, {}
        for b in range(depth):
            pre = f"features.{feat_i}.conv"
            bp, bs = {}, {}
            if spec.has_expand[s_i][b]:
                bp["expand"] = conv(f"{pre}.0.0.weight")
                bp["expand_bn"], bs["expand_bn"] = bn(f"{pre}.0.1")
                dw_pre, proj_i = f"{pre}.1", 2
            else:
                dw_pre, proj_i = f"{pre}.0", 1
            bp["dw"] = conv(f"{dw_pre}.0.weight")
            bp["dw_bn"], bs["dw_bn"] = bn(f"{dw_pre}.1")
            bp["project"] = conv(f"{pre}.{proj_i}.weight")
            bp["project_bn"], bs["project_bn"] = bn(f"{pre}.{proj_i + 1}")
            lp[str(b)], ls[str(b)] = bp, bs
            feat_i += 1
        params[f"stage{s_i}"], state[f"stage{s_i}"] = lp, ls
    params["last"] = conv(f"features.{feat_i}.0.weight")
    params["last_bn"], state["last_bn"] = bn(f"features.{feat_i}.1")
    params["fc"] = {"w": sd["classifier.1.weight"].t().contiguous(), "b": sd["classifier.1.bias"]}
    return params, state


def _convert(spec, sd: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """The family's converter, as the JAX package dispatches."""
    _family_check(spec)
    if isinstance(spec, EfficientNetSpec):
        return from_torch_state_dict_effnet(spec, sd)
    if isinstance(spec, MobileNetV2Spec):
        return from_torch_state_dict_mbv2(spec, sd)
    return from_torch_state_dict(spec, sd)


def _load_state_dict(path: str) -> Dict[str, Any]:
    # a full pickled module (the reference's pruned artifacts) needs the
    # pickle path, as in the JAX package: load only files you trust
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def load_torch_checkpoint(spec, path: str) -> Tuple[Dict, Dict]:
    """Load a reference ``.pth`` checkpoint (torch pickle) from disk -> CPU (params, state)."""
    return _convert(spec, _load_state_dict(path))


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

    Raises FileNotFoundError when no cache entry exists for ``spec.name``,
    ValueError when a converted leaf's shape differs from the given tree's
    (a cache file of another model or width)."""
    if path is None:
        path = find_cached_weights(spec.name)
    if path is None:
        raise FileNotFoundError(
            f"no cached weights for {spec.name!r} in "
            f"{cached_weight_dirs() or '$IEVM_WEIGHTS_DIR (unset)'}"
        )
    _family_check(spec)
    sd = _strip(_load_state_dict(path))
    # the converters expect the checkpoint's own (ImageNet) head; ours replaces it
    rows = next((int(sd[k].shape[0]) for k in ("fc.weight", "classifier.1.weight", "head.weight")
                 if k in sd), spec.num_classes)
    spec_full = dataclasses.replace(spec, num_classes=rows) if rows != spec.num_classes else spec
    p2, s2 = _convert(spec_full, sd)
    dev = params["fc"]["w"].device
    p2, s2 = place(p2, dev), place(s2, dev)
    p2["fc"] = params["fc"]
    _check_shapes((p2, s2), (params, state))
    return p2, s2


def _check_shapes(got, want, path: str = "") -> None:
    if isinstance(want, (dict, tuple)):
        keys = want.keys() if isinstance(want, dict) else range(len(want))
        if (got.keys() if isinstance(got, dict) else range(len(got))) != keys:
            raise ValueError(f"cached weights do not have the model's leaves at {path or '/'}")
        for k in keys:
            _check_shapes(got[k], want[k], f"{path}/{k}")
    elif tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"cached weight {path} has shape {tuple(got.shape)}, the model "
                         f"{tuple(want.shape)}")
