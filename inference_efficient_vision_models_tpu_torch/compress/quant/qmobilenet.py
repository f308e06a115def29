"""Quantized MobileNetV2: calibration taps, conversion, and the unfused and
mixed static-INT8 forwards, the port of the JAX package's
``compress/quant/qmobilenet.py``.

* ``apply_folded``: the fp32 (or fp16 / bf16) forward of the BN-folded
  model with the activation taps the conversion consumes (``input``,
  ``stem``, ``s{s}b{b}e`` / ``d`` / ``o`` per block, ``head``, ``feat``);
* ``convert_static_int8``: weights -> per-channel symmetric int8,
  activations -> quint8 affine qparams from the observers, the ImageNet
  normalization folded into the stem (raw uint8 input); numpy on the host,
  as the JAX package converts, so the integer leaves are the JAX package's;
* ``block_int8`` (a block of the unfused executor): the 1x1 expand on the
  int8 matmul kernel (fp32 out, ReLU6 and the requant as glue), the
  depthwise conv on the int8 depthwise kernel with its ReLU6 epilogue
  (``ops/dwconv_int8``), the project on the int8 matmul kernel (fp32 out,
  then the residual and the requant); ``block_mixed``: the depthwise conv
  on bf16-rounded operands accumulated in fp32 (the JAX package's
  ``preferred_element_type=f32`` conv), then ReLU6 and the requant.

Activations are shifted quint8 (int8 ``q - 128``) NHWC, requantized by true
division as the JAX executor does (``_requant``: round(y / s)); kernel A's
int8-out route multiplies by 1/s, which rounds some ties one quantum apart,
so every 1x1 conv takes kernel A's fp32 output and glue. ``impl="plain"``
runs every kernel's plain PyTorch version on any device; a CPU tensor
always takes them. The executors (``apply_int8``, ``apply_int8_mixed``),
the stem, the head, the device leaves, the served model and its loader are
``qeffnet``'s, which run this module's blocks with ReLU6 in place of SiLU;
``fusedpath`` runs the fused executor over the same artifact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...models.mobilenet import MobileNetV2Spec, relu6
from ...models.resnet import _conv_w
from ...utils.device import exact_fp32
from . import qeffnet
from .fold import fold_mbv2 as fold  # noqa: F401  (the family-module API)
from .observers import ObserverState, quantize_weight_per_channel
# the family-module API that both MBConv families share
from .qeffnet import (  # noqa: F401
    QEffNetInt8Unfused,
    _act_qparams,
    _qconv_params,
    apply_int8,
    apply_int8_mixed,
    from_jax_qmodel,
    load_static_int8,
    restore_derived,
    serializable,
)
from .qresnet import _requant, tapper

__all__ = ["ADAROUND_SKIP", "fold", "apply_folded", "calibrate", "convert_static_int8",
           "serializable", "restore_derived", "block_int8", "block_mixed", "block_plan",
           "apply_int8", "apply_int8_mixed", "QEffNetInt8Unfused", "from_jax_qmodel",
           "load_static_int8"]

ACT = "relu6"  # the family's activation, as the kernels name it

# the conversion transforms the stem kernel (the normalization fold) before
# quantizing it, so AdaRound cannot target its grid
ADAROUND_SKIP = ("stem",)


# --------------------------------------------------------------------------
# the folded float forward and its taps
# --------------------------------------------------------------------------


def _conv_f(x, leaf, stride: int, padding: int, *, groups: int = 1, act: bool = False):
    y = F.conv2d(x, leaf["w"], leaf["b"], stride=stride, padding=padding, groups=groups)
    return relu6(y) if act else y


def apply_folded(spec: MobileNetV2Spec, folded: Dict, x, *, with_taps: bool = False,
                 return_features: bool = False, tap_fn=None):
    """Forward of the folded model (``qresnet.place_folded``) on NHWC float
    images in the model's dtype -> logits, or the pooled features, or
    (logits, taps) with ``with_taps``; taps NHWC as the JAX package's (views
    on the GPU). ``tap_fn(name, t) -> t'`` intercepts each tap (NHWC) and its
    result re-enters the flow (``qresnet.tapper``). fp32 runs with TF32 off."""
    taps: Dict[str, torch.Tensor] = {}
    tap = tapper(taps, tap_fn)

    with exact_fp32():
        x = tap("input", _conv_w(x.permute(0, 3, 1, 2)))
        t = tap("stem", _conv_f(x, folded["stem"], 2, 1, act=True))
        for s, depth in enumerate(spec.depths):
            for b in range(depth):
                blk = folded[f"stage{s}"][str(b)]
                h = t
                if spec.has_expand[s][b]:
                    h = tap(f"s{s}b{b}e", _conv_f(h, blk["expand"], 1, 0, act=True))
                h = _conv_f(h, blk["dw"], spec.block_stride(s, b), 1,
                            groups=blk["dw"]["w"].shape[0], act=True)
                h = tap(f"s{s}b{b}d", h)
                h = _conv_f(h, blk["project"], 1, 0)
                if spec.has_residual(s, b):
                    h = h + t
                t = tap(f"s{s}b{b}o", h)
        t = tap("head", _conv_f(t, folded["last"], 1, 0, act=True))
        feats = tap("feat", t.mean(dim=(2, 3)))
        if return_features:
            return feats
        logits = feats @ folded["fc"]["w"] + folded["fc"]["b"]
    return (logits, taps) if with_taps else logits


def calibrate(spec: MobileNetV2Spec, folded: Dict, batches, *, max_images: int = 256,
              averaging_constant=0.01, **observer_kw) -> Dict[str, ObserverState]:
    """Activation-range calibration over at most ``max_images``
    (``calib.calibrate_taps``: TF32 and cuDNN off)."""
    from .calib import calibrate_taps

    return calibrate_taps(apply_folded, spec, folded, batches, max_images=max_images,
                          averaging_constant=averaging_constant, **observer_kw)


# --------------------------------------------------------------------------
# conversion (numpy on the host)
# --------------------------------------------------------------------------


def convert_static_int8(spec: MobileNetV2Spec, folded: Dict, observers: Dict[str, ObserverState],
                        *, fold_input: bool = True, image_size=(224, 224)) -> Dict:
    """Folded fp32 model (JAX layout, numpy) + calibrated observers -> the
    static-int8 tree the JAX package writes (numpy; int32 leaves int32).
    ``fold_input=True`` folds the ImageNet normalization into the stem,
    which then consumes raw uint8."""
    from . import stemfold

    q: Dict = {}
    s_in, zp_in = _act_qparams(observers["input"])
    q["input"] = {"scale": s_in, "zp": zp_in}
    if fold_input:
        q["stem"] = stemfold.make_u8_stem(folded["stem"]["w"], folded["stem"]["b"],
                                          observers["stem"], stride=2, padding=1,
                                          image_size=image_size)
    else:
        q["stem"] = _qconv_params(folded["stem"]["w"], folded["stem"]["b"], observers["stem"])
    for s, depth in enumerate(spec.depths):
        sname = f"stage{s}"
        q[sname] = {}
        for b in range(depth):
            blk = folded[sname][str(b)]
            out: Dict = {}
            if spec.has_expand[s][b]:
                out["expand"] = _qconv_params(blk["expand"]["w"], blk["expand"]["b"],
                                              observers[f"s{s}b{b}e"])
            out["dw"] = _qconv_params(blk["dw"]["w"], blk["dw"]["b"], observers[f"s{s}b{b}d"])
            out["project"] = _qconv_params(blk["project"]["w"], blk["project"]["b"])
            out["out_scale"], out["out_zp"] = _act_qparams(observers[f"s{s}b{b}o"])
            q[sname][str(b)] = out
    q["last"] = _qconv_params(folded["last"]["w"], folded["last"]["b"], observers["head"])
    f_scale, f_zp = _act_qparams(observers["feat"])
    w_q, w_scale = quantize_weight_per_channel(np.asarray(folded["fc"]["w"], np.float32),
                                               channel_axis=1)
    q["fc"] = {
        "w_q": w_q,
        "w_scale": w_scale,
        "w_sum": w_q.sum(axis=0, dtype=np.int32),
        "bias": np.asarray(folded["fc"]["b"], np.float32),
        "in_scale": f_scale,
        "in_zp": f_zp,
    }
    return q


# --------------------------------------------------------------------------
# the int8 blocks (the executors, the served model and its loader are
# ``qeffnet``'s, which run either family's blocks)
# --------------------------------------------------------------------------


def block_int8(blk: Dict, x_in: torch.Tensor, in_s: float, in_z: int, *, kernel: int = 3,
               stride: int, residual: bool, impl: str = "kernel") -> torch.Tensor:
    """One inverted-residual block of the unfused int8 op chain -> int8 in the
    block-out domain: expand (kernel A, fp32 out, ReLU6 + requant), depthwise
    (kernel E with ReLU6), project (kernel A, fp32 out), residual, requant."""
    del kernel  # the depthwise kernel's size is its weight's
    h, h_s, h_z = qeffnet._expand(blk, x_in, in_s, in_z, impl, ACT)
    d = blk["dw"]
    h = qeffnet._dw_int8(h, h_s, h_z, d, stride, impl, ACT)
    return qeffnet._project_out(h, d["out_scale"], d["out_zp"], blk, x_in, in_s, in_z,
                                residual, impl)


def block_mixed(blk: Dict, x_in: torch.Tensor, in_s: float, in_z: int, *, kernel: int = 3,
                stride: int, residual: bool, impl: str = "kernel") -> torch.Tensor:
    """The mixed-precision block: the 1x1 expand and project stay int8
    (kernel A), the depthwise conv runs ``qeffnet._dw_bf16`` (bf16-rounded
    operands, fp32 accumulator), then ReLU6 and the requant into the
    calibrated depthwise domain."""
    h, h_s, h_z = qeffnet._expand(blk, x_in, in_s, in_z, impl, ACT)
    d = blk["dw"]
    h = _requant(relu6(qeffnet._dw_bf16(h, h_s, h_z, d, kernel, stride)), d["out_scale"],
                 d["out_zp"])
    return qeffnet._project_out(h, d["out_scale"], d["out_zp"], blk, x_in, in_s, in_z,
                                residual, impl)


def block_plan(spec: MobileNetV2Spec):
    """(name, kernel, stride, residual) of every inverted-residual block, in order."""
    return [(f"s{s}b{b}", 3, spec.block_stride(s, b), spec.has_residual(s, b))
            for s, depth in enumerate(spec.depths) for b in range(depth)]
