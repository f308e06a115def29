"""Conv–BatchNorm folding for the inference and quantization paths, the
port of the JAX package's ``compress/quant/fold.py`` (ResNet, EfficientNet
and MobileNetV2 parts).

In eval mode a BatchNorm is a per-channel affine map, so it folds into the
conv before it:

    W'[..., c] = W[..., c] · γ_c / sqrt(σ²_c + eps)
    b'_c       = β_c − μ_c · γ_c / sqrt(σ²_c + eps)

In float32 numpy on the host, on the JAX-layout trees (HWIO kernels), as the
JAX package folds: the folded leaves are the JAX package's bit for bit, and
the int8 conversion downstream quantizes the same numbers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ...models.resnet import BN_EPS
from ...models.widths import ResNetSpec


def _fold_one(conv_w, bn_p, bn_s) -> Tuple[np.ndarray, np.ndarray]:
    w = np.asarray(conv_w, np.float32)
    gamma = np.asarray(bn_p["scale"], np.float32)
    beta = np.asarray(bn_p["bias"], np.float32)
    mean = np.asarray(bn_s["mean"], np.float32)
    var = np.asarray(bn_s["var"], np.float32)
    inv = gamma / np.sqrt(var + BN_EPS)
    return w * inv.reshape(1, 1, 1, -1), beta - mean * inv


def fold_conv_bn(spec: ResNetSpec, params, state) -> Dict:
    """JAX-layout params/state -> the folded tree: each conv becomes
    {"w": HWIO, "b": [oc]}, the downsample ``down``; no BatchNorm."""
    out: Dict = {}
    out["conv1"] = dict(zip("wb", _fold_one(params["conv1"]["w"], params["bn1"], state["bn1"])))
    n_convs = 2 if spec.block == "basic" else 3
    for s, depth in enumerate(spec.depths):
        lname = f"layer{s + 1}"
        out[lname] = {}
        for b in range(depth):
            bp = params[lname][str(b)]
            bs = state[lname][str(b)]
            blk: Dict = {}
            for c in range(1, n_convs + 1):
                blk[f"conv{c}"] = dict(
                    zip("wb", _fold_one(bp[f"conv{c}"]["w"], bp[f"bn{c}"], bs[f"bn{c}"])))
            if "down_conv" in bp:
                blk["down"] = dict(
                    zip("wb", _fold_one(bp["down_conv"]["w"], bp["down_bn"], bs["down_bn"])))
            out[lname][str(b)] = blk
    out["fc"] = {"w": np.asarray(params["fc"]["w"], np.float32),
                 "b": np.asarray(params["fc"]["b"], np.float32)}
    return out


def fold_effnet(spec, params, state) -> Dict:
    """EfficientNet conv–BN fold, the layout of the params tree: stem /
    stage{s}/{b}/{expand?, dw, project} / last / fc, each conv {"w": HWIO, "b"}
    (a depthwise kernel folds on its HWIO output axis like any conv), and the
    SE gate's bias-carrying, BN-free fc pair copied through as fp32."""
    return _fold_mbconv(spec, params, state, se=True)


def fold_mbv2(spec, params, state) -> Dict:
    """MobileNetV2 conv–BN fold: ``fold_effnet``'s layout without the SE gate."""
    return _fold_mbconv(spec, params, state, se=False)


def _fold_mbconv(spec, params, state, *, se: bool) -> Dict:
    def fold(conv, bn, tree_p, tree_s):
        return dict(zip("wb", _fold_one(tree_p[conv]["w"], tree_p[bn], tree_s[bn])))

    out: Dict = {"stem": fold("stem", "stem_bn", params, state)}
    for s, depth in enumerate(spec.depths):
        sname = f"stage{s}"
        out[sname] = {}
        for b in range(depth):
            bp, bs = params[sname][str(b)], state[sname][str(b)]
            blk: Dict = {}
            if spec.has_expand[s][b]:
                blk["expand"] = fold("expand", "expand_bn", bp, bs)
            blk["dw"] = fold("dw", "dw_bn", bp, bs)
            blk["project"] = fold("project", "project_bn", bp, bs)
            for k in ("se_reduce", "se_expand") if se else ():
                blk[k] = {"w": np.asarray(bp[k]["w"], np.float32),
                          "b": np.asarray(bp[k]["b"], np.float32)}
            out[sname][str(b)] = blk
    out["last"] = fold("last", "last_bn", params, state)
    out["fc"] = {"w": np.asarray(params["fc"]["w"], np.float32),
                 "b": np.asarray(params["fc"]["b"], np.float32)}
    return out
