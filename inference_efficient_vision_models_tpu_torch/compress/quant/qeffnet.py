"""Quantized EfficientNet: calibration taps, conversion, and the unfused and
mixed static-INT8 forwards, the port of the JAX package's
``compress/quant/qeffnet.py``.

* ``apply_folded``: the fp32 (or fp16 / bf16) forward of the BN-folded
  model with the activation taps the conversion consumes (``input``,
  ``stem``, ``s{s}b{b}e`` / ``d`` / ``se`` / ``o`` per block, ``head``,
  ``feat``);
* ``convert_static_int8``: weights -> per-channel symmetric int8 (the SE
  matrices too: they compute in fp32 but store int8), activations -> quint8
  affine qparams from the observers, the ImageNet normalization folded into
  the stem (raw uint8 input); numpy on the host, as the JAX package
  converts, so the integer leaves are the JAX package's;
* ``apply_int8`` (the unfused executor): per block the 1x1 expand on the
  int8 matmul kernel (fp32 out, SiLU and the requant as glue), the depthwise
  conv on the int8 depthwise kernel (``ops/dwconv_int8``), the SE gate in
  fp32 PyTorch as the JAX package computes it in ``jnp``, the project on the
  int8 matmul kernel (fp32 out, then the residual and the requant);
  ``apply_int8_mixed``: the same artifact with the depthwise conv on
  bf16-rounded operands accumulated in fp32 (the JAX package's
  ``preferred_element_type=f32`` conv) and its SiLU output fed straight to
  the SE gate.

Activations are shifted quint8 (int8 ``q - 128``) NHWC, requantized by true
division as the JAX executors do. ``impl="plain"`` runs every kernel's
plain PyTorch version on any device; a CPU tensor always takes them. The
executors, the stem, the head, the device leaves, ``QEffNetInt8Unfused`` and
its loader serve MobileNetV2 too, with ``qmobilenet``'s blocks and ReLU6
(the family module is ``engine.quant_module(spec)``). ``fusedpath`` runs the
fused executor over the same artifact and shares the stem, the head and the
loaded leaves with this module.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...core.artifacts import load_checkpoint_raw
from ...models.efficientnet import EfficientNetSpec
from ...models.mobilenet import MobileNetV2Spec
from ...models.registry import spec_from_dict
from ...models.resnet import _conv_w
from ...ops.dwconv_int8 import depthwise_conv_int8, depthwise_conv_int8_plain
from ...ops.int8_matmul import int8_matmul_requant, int8_matmul_requant_plain, pack_weight
from ...utils.device import DeviceLike, exact_fp32, resolve_device
from . import stemfold
from .fold import fold_effnet as fold  # noqa: F401  (the family-module API)
from .observers import (
    ObserverState,
    dequantize_affine_shifted,
    minmax_qparams_affine,
    quantize_weight_per_channel,
)
from .qresnet import _conv_leaf, _requant, _t32, tapper

__all__ = ["ADAROUND_SKIP", "fold", "apply_folded", "calibrate", "convert_static_int8",
           "serializable", "restore_derived", "apply_int8", "apply_int8_mixed",
           "QEffNetInt8Unfused", "from_jax_qmodel", "load_static_int8"]


ACT = "silu"  # the family's activation, as the kernels name it

# the conversion transforms the stem kernel (the normalization fold) before
# quantizing it, so AdaRound cannot target its grid
ADAROUND_SKIP = ("stem",)


def _silu(y: torch.Tensor) -> torch.Tensor:
    """y * sigmoid(y), the JAX package's ``_silu``: the SiLU of the code that
    runs as PyTorch ops here (the folded forward, the SE gate, the glue after
    a 1x1 conv's fp32 output); the kernels keep their own."""
    return y * torch.sigmoid(y)


def _glue_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """The activation after a 1x1 conv's fp32 output, as the family's JAX
    ``_conv_q`` applies it: ``_silu``, or ReLU6 as min(max(y, 0), 6)."""
    return _silu(y) if act == "silu" else torch.clamp(y, 0.0, 6.0)


# --------------------------------------------------------------------------
# the folded float forward and its taps
# --------------------------------------------------------------------------


def _conv_f(x, leaf, stride: int, padding: int, *, groups: int = 1, act: bool = False):
    y = F.conv2d(x, leaf["w"], leaf["b"], stride=stride, padding=padding, groups=groups)
    return _silu(y) if act else y


def _se_f(h, se_r, se_e):
    pooled = h.mean(dim=(2, 3))
    s = _silu(pooled @ se_r["w"] + se_r["b"])
    s = torch.sigmoid(s @ se_e["w"] + se_e["b"])
    return h * s[:, :, None, None]


def apply_folded(spec: EfficientNetSpec, folded: Dict, x, *, with_taps: bool = False,
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
            k = spec.stage_kernels[s]
            for b in range(depth):
                blk = folded[f"stage{s}"][str(b)]
                h = t
                if spec.has_expand[s][b]:
                    h = tap(f"s{s}b{b}e", _conv_f(h, blk["expand"], 1, 0, act=True))
                h = _conv_f(h, blk["dw"], spec.block_stride(s, b), (k - 1) // 2,
                            groups=blk["dw"]["w"].shape[0], act=True)
                h = tap(f"s{s}b{b}d", h)
                h = tap(f"s{s}b{b}se", _se_f(h, blk["se_reduce"], blk["se_expand"]))
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


def calibrate(spec: EfficientNetSpec, folded: Dict, batches, *, max_images: int = 256,
              averaging_constant=0.01, **observer_kw) -> Dict[str, ObserverState]:
    """Activation-range calibration over at most ``max_images``
    (``calib.calibrate_taps``: TF32 and cuDNN off)."""
    from .calib import calibrate_taps

    return calibrate_taps(apply_folded, spec, folded, batches, max_images=max_images,
                          averaging_constant=averaging_constant, **observer_kw)


# --------------------------------------------------------------------------
# conversion (numpy on the host)
# --------------------------------------------------------------------------


def _qconv_params(w, b, obs_out=None) -> Dict:
    w_q, w_scale = quantize_weight_per_channel(np.asarray(w, np.float32), channel_axis=3)
    d = {
        "w_q": w_q,
        "w_scale": w_scale,
        "w_sum": w_q.sum(axis=(0, 1, 2), dtype=np.int32),
        "bias": np.asarray(b, np.float32),
    }
    if obs_out is not None:
        scale, zp = minmax_qparams_affine(obs_out.min, obs_out.max)
        d["out_scale"] = np.float32(scale)
        d["out_zp"] = np.int32(zp)
    return d


def _q_se(se) -> Dict:
    """SE (in, out) matrix -> int8 weight + per-output-channel scale."""
    w_q, w_scale = quantize_weight_per_channel(np.asarray(se["w"], np.float32), channel_axis=1)
    return {"w_q": w_q, "w_scale": w_scale, "b": np.asarray(se["b"], np.float32)}


def _deq_se(se: Dict) -> np.ndarray:
    """SE (in, out) int8 matrix + per-output-channel scale -> fp32."""
    return np.asarray(se["w_q"]).astype(np.float32) * np.asarray(se["w_scale"], np.float32)


def _act_qparams(obs) -> tuple:
    scale, zp = minmax_qparams_affine(obs.min, obs.max)
    return np.float32(scale), np.int32(zp)


def convert_static_int8(spec: EfficientNetSpec, folded: Dict, observers: Dict[str, ObserverState],
                        *, fold_input: bool = True, image_size=(224, 224)) -> Dict:
    """Folded fp32 model (JAX layout, numpy) + calibrated observers -> the
    static-int8 tree the JAX package writes (numpy; int32 leaves int32, as
    JAX's 32-bit arrays store them). ``fold_input=True`` folds the ImageNet
    normalization into the stem, which then consumes raw uint8."""
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
            out["se_reduce"] = _q_se(blk["se_reduce"])
            out["se_expand"] = _q_se(blk["se_expand"])
            out["se_scale"], out["se_zp"] = _act_qparams(observers[f"s{s}b{b}se"])
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


def serializable(qmodel: Dict) -> Dict:
    """Checkpoint view: the derived stem offset map left out."""
    if "stem" in qmodel and "e" in qmodel["stem"] and "w_fp" in qmodel["stem"]:
        stem = {k: v for k, v in qmodel["stem"].items() if k not in stemfold.DERIVED_KEYS}
        return {**qmodel, "stem": stem}
    return qmodel


def restore_derived(qmodel: Dict) -> Dict:
    """Add the stem offset map a checkpoint leaves out (``serializable``'s inverse)."""
    if "stem" in qmodel and "w_fp" in qmodel["stem"] and "e" not in qmodel["stem"]:
        return {**qmodel, "stem": stemfold.restore_offsets(qmodel["stem"])}
    return qmodel


# --------------------------------------------------------------------------
# loading: the converted tree's leaves on a device
# --------------------------------------------------------------------------


def stem_and_head_leaves(spec: EfficientNetSpec, qm: Dict, dev: torch.device) -> Dict:
    """The u8 stem, the head conv ``last`` (with its input qparams: the last
    block's output) and the fc of a converted tree (``restore_derived``
    applied) on ``dev``: what every executor shares."""
    st = qm["stem"]
    if "e" not in st:
        raise NotImplementedError("only the normalization-folded u8 stem is ported")
    n_stem = int(np.asarray(st["bias"]).shape[0])
    last_blk = qm[f"stage{len(spec.depths) - 1}"][str(spec.depths[-1] - 1)]
    return {
        "stem": {
            "w": pack_weight(torch.from_numpy(np.array(st["w_q"], np.int8)).to(dev)),
            "w_scale": _t32(st["w_scale"]).to(dev),
            "bias": _t32(st["bias"]).to(dev),
            "w_sum": torch.zeros(n_stem, dtype=torch.int32, device=dev),  # zp_s = 0
            "e": _t32(st["e"]).to(dev),
            "stride": int(st["stride"]),
            "pad": int(st["pad"]),
            "out_scale": float(np.float32(st["out_scale"])),
            "out_zp": int(st["out_zp"]),
        },
        "last": {**_conv_leaf(qm["last"], dev),
                 "in_scale": float(np.float32(last_blk["out_scale"])),
                 "in_zp": int(last_blk["out_zp"])},
        "fc": {**_conv_leaf(qm["fc"], dev),
               "in_scale": float(np.float32(qm["fc"]["in_scale"])),
               "in_zp": int(qm["fc"]["in_zp"])},
    }


def _block_leaves(blk: Dict, dev: torch.device, mixed: bool) -> Dict:
    """One converted block's leaves on ``dev``: the depthwise conv, the SE
    gate where the block has one (EfficientNet), the project conv, the
    block-out qparams, the expand conv where there is one and, ``mixed``, the
    bf16 depthwise kernel."""
    d = blk["dw"]
    out: Dict = {
        "dw": {"w_q": torch.from_numpy(np.array(d["w_q"], np.int8)).to(dev),
               "w_scale": _t32(d["w_scale"]).to(dev), "bias": _t32(d["bias"]).to(dev),
               "out_scale": float(np.float32(d["out_scale"])), "out_zp": int(d["out_zp"])},
        "project": _conv_leaf(blk["project"], dev),
        "out_scale": float(np.float32(blk["out_scale"])),
        "out_zp": int(blk["out_zp"]),
    }
    if "se_reduce" in blk:
        out.update({
            "se_reduce": {"w": torch.from_numpy(_deq_se(blk["se_reduce"])).to(dev),
                          "b": _t32(blk["se_reduce"]["b"]).to(dev)},
            "se_expand": {"w": torch.from_numpy(_deq_se(blk["se_expand"])).to(dev),
                          "b": _t32(blk["se_expand"]["b"]).to(dev)},
            "se_scale": float(np.float32(blk["se_scale"])),
            "se_zp": int(blk["se_zp"])})
    if "expand" in blk:
        out["expand"] = _conv_leaf(blk["expand"], dev)
    if mixed:
        # the depthwise kernel dequantized and rounded to bf16 (the JAX
        # package's (w_q * w_scale).astype(bf16)), kept as fp32 values in
        # the (C, 1, k, k) layout of a grouped conv
        w = (np.asarray(d["w_q"], np.float32) * np.asarray(d["w_scale"], np.float32))
        w_bf = torch.from_numpy(w).to(torch.bfloat16).float().permute(3, 2, 0, 1)
        out["dw"]["w_bf16"] = _conv_w(w_bf.to(dev))
    return out


# --------------------------------------------------------------------------
# the int8 forwards
# --------------------------------------------------------------------------


def _mm(impl: str):
    return int8_matmul_requant if impl == "kernel" else int8_matmul_requant_plain


def conv1x1(x_s: torch.Tensor, zp: int, in_scale: float, qc: Dict, *, impl: str) -> torch.Tensor:
    """``_conv_q(..., 1, 0, act=False, requant=False)``: a 1x1 int8 conv on the
    int8 matmul kernel -> fp32 NHWC."""
    n, h, w, c = x_s.shape
    y = _mm(impl)(x_s.reshape(-1, c), qc["w"], qc["w_scale"], qc["bias"], qc["w_sum"],
                  in_scale=in_scale, in_zp=zp)
    return y.reshape(n, h, w, -1)


def conv1x1_act_requant(x_s: torch.Tensor, zp: int, in_scale: float, qc: Dict, *,
                        impl: str, act: str = ACT) -> torch.Tensor:
    """``_conv_q(..., 1, 0, act=True, requant=True)`` of a 1x1 conv (an expand
    conv, the head conv ``last``): the int8 matmul kernel with fp32 out, then
    the activation (SiLU, or MobileNetV2's ReLU6) and the requant by true
    division as glue (the kernel's int8-out route multiplies by 1/s_out)."""
    return _requant(_glue_act(conv1x1(x_s, zp, in_scale, qc, impl=impl), act),
                    qc["out_scale"], qc["out_zp"])


def _se_requant(h_f: torch.Tensor, blk: Dict) -> torch.Tensor:
    """The SE gate in fp32 on the dequantized hidden map (N, H, W, C), as the
    JAX package computes it, then the requant into the SE output domain."""
    pooled = h_f.mean(dim=(1, 2))
    g = _silu(pooled @ blk["se_reduce"]["w"] + blk["se_reduce"]["b"])
    g = torch.sigmoid(g @ blk["se_expand"]["w"] + blk["se_expand"]["b"])
    return _requant(h_f * g[:, None, None, :], blk["se_scale"], blk["se_zp"])


def _project_out(h: torch.Tensor, h_s: float, h_z: int, blk: Dict, x_in, in_s, in_z,
                 residual: bool, impl: str):
    """The project conv of ``h`` (int8 in the (h_s, h_z) domain: the SE gate's
    output, or the depthwise conv's without one) on kernel A with fp32 out,
    the residual, the requant into the block-out domain."""
    y = conv1x1(h, h_z, h_s, blk["project"], impl=impl)
    if residual:
        y = y + dequantize_affine_shifted(x_in, in_s, in_z)
    return _requant(y, blk["out_scale"], blk["out_zp"])


def _expand(blk: Dict, x_in, in_s, in_z, impl: str, act: str = ACT):
    if "expand" not in blk:
        return x_in, in_s, in_z
    e = blk["expand"]
    return (conv1x1_act_requant(x_in, in_z, in_s, e, impl=impl, act=act), e["out_scale"],
            e["out_zp"])


def _dw_int8(h: torch.Tensor, h_s: float, h_z: int, d: Dict, stride: int, impl: str,
             act: str = ACT) -> torch.Tensor:
    """The depthwise conv on kernel E (its plain version with ``impl="plain"``)
    with the family's activation, requantized into its calibrated domain."""
    dw = depthwise_conv_int8 if impl == "kernel" else depthwise_conv_int8_plain
    return dw(h, d["w_q"], d["w_scale"], d["bias"], stride=stride, in_scale=h_s, in_zp=h_z,
              out_scale=d["out_scale"], out_zp=d["out_zp"], act=act)


def _dw_bf16(h: torch.Tensor, h_s: float, h_z: int, d: Dict, kernel: int,
             stride: int) -> torch.Tensor:
    """The mixed executor's depthwise conv: bf16-rounded operands, an fp32
    accumulator and output plus the bias (the JAX package's bf16 conv with
    ``preferred_element_type=f32``; TF32 off) -> fp32 NHWC, before the
    activation."""
    pad = (kernel - 1) // 2
    h_bf = dequantize_affine_shifted(h, h_s, h_z).to(torch.bfloat16).float()
    with exact_fp32():
        acc = F.conv2d(_conv_w(h_bf.permute(0, 3, 1, 2)), d["w_bf16"], stride=stride,
                       padding=pad, groups=d["w_bf16"].shape[0])
    return acc.permute(0, 2, 3, 1) + d["bias"]


def block_int8(blk: Dict, x_in: torch.Tensor, in_s: float, in_z: int, *, kernel: int,
               stride: int, residual: bool, impl: str = "kernel") -> torch.Tensor:
    """One MBConv block of the unfused int8 op chain -> int8 in the block-out
    domain: expand (kernel A), depthwise (kernel E), SE gate (fp32), project
    (kernel A), residual, requant."""
    del kernel  # the depthwise kernel's size is its weight's
    h, h_s, h_z = _expand(blk, x_in, in_s, in_z, impl)
    d = blk["dw"]
    h = _dw_int8(h, h_s, h_z, d, stride, impl)
    h = _se_requant(dequantize_affine_shifted(h, d["out_scale"], d["out_zp"]), blk)
    return _project_out(h, blk["se_scale"], blk["se_zp"], blk, x_in, in_s, in_z, residual, impl)


def block_mixed(blk: Dict, x_in: torch.Tensor, in_s: float, in_z: int, *, kernel: int,
                stride: int, residual: bool, impl: str = "kernel") -> torch.Tensor:
    """The mixed-precision MBConv block: the 1x1 expand and project stay int8
    (kernel A), the depthwise conv runs ``_dw_bf16``, and its SiLU output
    feeds the fp32 SE gate directly: no depthwise requant."""
    h, h_s, h_z = _expand(blk, x_in, in_s, in_z, impl)
    h = _se_requant(_silu(_dw_bf16(h, h_s, h_z, blk["dw"], kernel, stride)), blk)
    return _project_out(h, blk["se_scale"], blk["se_zp"], blk, x_in, in_s, in_z, residual, impl)


def stem_int8(q: Dict, x: torch.Tensor, *, impl: str, act: str = ACT) -> torch.Tensor:
    """Raw uint8 images -> the stem's int8 output (the first block's input);
    ``act`` is the family's ("relu6" for MobileNetV2)."""
    stem = q["stem"]
    y = stemfold.apply_u8_stem(stem, x, stride=stem["stride"], pad=stem["pad"], act=act,
                               impl=impl)
    return _requant(y, stem["out_scale"], stem["out_zp"])


def head_logits(q: Dict, cur: torch.Tensor, *, impl: str, act: str = ACT) -> torch.Tensor:
    """The last block's int8 output -> fp32 logits: 1x1 head conv + the
    family's activation + requant, mean pool of the dequantized map, int8 fc
    on the float features."""
    last = q["last"]
    cur = conv1x1_act_requant(cur, last["in_zp"], last["in_scale"], last, impl=impl, act=act)
    feats = dequantize_affine_shifted(cur, last["out_scale"], last["out_zp"]).mean(dim=(1, 2))
    fc = q["fc"]
    return _mm(impl)(feats, fc["w"], fc["w_scale"], fc["bias"], fc["w_sum"],
                     in_scale=fc["in_scale"], in_zp=fc["in_zp"])


def block_plan(spec: EfficientNetSpec):
    """(name, kernel, stride, residual) of every MBConv block, in order."""
    return [(f"s{s}b{b}", spec.stage_kernels[s], spec.block_stride(s, b), spec.has_residual(s, b))
            for s, depth in enumerate(spec.depths) for b in range(depth)]


# --------------------------------------------------------------------------
# the unfused and mixed executors of both MBConv families
# --------------------------------------------------------------------------


def _apply_with_blocks(spec, q: Dict, x: torch.Tensor, *, mixed: bool,
                       impl: str) -> torch.Tensor:
    """The stem, every block by the family's ``block_int8`` (``block_mixed``
    with ``mixed``) in its ``block_plan``, the head, with its ``ACT``; the
    family module is ``quant_module(spec)`` (this module or ``qmobilenet``)."""
    from .engine import quant_module

    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    fam = quant_module(spec)
    block_fn = fam.block_mixed if mixed else fam.block_int8
    cur = stem_int8(q, x, impl=impl, act=fam.ACT)
    cur_s, cur_z = q["stem"]["out_scale"], q["stem"]["out_zp"]
    for name, k, stride, residual in fam.block_plan(spec):
        blk = q["blocks"][name]
        cur = block_fn(blk, cur, cur_s, cur_z, kernel=k, stride=stride, residual=residual,
                       impl=impl)
        cur_s, cur_z = blk["out_scale"], blk["out_zp"]
    return head_logits(q, cur, impl=impl, act=fam.ACT)


def apply_int8(spec, q: Dict, x: torch.Tensor, *, impl: str = "kernel") -> torch.Tensor:
    """Static-INT8 forward of the unfused executor of an EfficientNet or a
    MobileNetV2 -> fp32 logits; ``x`` is raw uint8 NHWC."""
    return _apply_with_blocks(spec, q, x, mixed=False, impl=impl)


def apply_int8_mixed(spec, q: Dict, x: torch.Tensor, *, impl: str = "kernel") -> torch.Tensor:
    """The mixed-precision executor over the same artifact (the family's
    ``block_mixed``)."""
    return _apply_with_blocks(spec, q, x, mixed=True, impl=impl)


@dataclasses.dataclass
class QEffNetInt8Unfused:
    """A static-INT8 EfficientNet or MobileNetV2 on one device, run by the
    unfused (``executor="int8"``) or the mixed (``"mixed"``) executor; call it
    on raw uint8 images (B, H, W, 3)."""

    spec: object  # EfficientNetSpec | MobileNetV2Spec
    q: Dict
    executor: str = "int8"

    def __call__(self, x: torch.Tensor, *, impl: str = "kernel") -> torch.Tensor:
        fn = apply_int8 if self.executor == "int8" else apply_int8_mixed
        return fn(self.spec, self.q, x, impl=impl)


def from_jax_qmodel(spec_dict: Dict, qmodel_np: Dict, device: DeviceLike = None, *,
                    executor: str = "int8") -> QEffNetInt8Unfused:
    """A converted static-int8 EfficientNet or MobileNetV2 tree (nested dicts
    of numpy arrays, as ``convert_static_int8`` or ``msgpack_restore`` gives
    it) -> the port's model on ``device``, for the ``"int8"`` or ``"mixed"``
    executor."""
    if executor not in ("int8", "mixed"):
        raise ValueError(f"unknown executor {executor!r}")
    dev = resolve_device(device)
    spec = spec_from_dict(spec_dict)
    if not isinstance(spec, (EfficientNetSpec, MobileNetV2Spec)):
        raise NotImplementedError(f"the unfused executors serve EfficientNet and MobileNetV2, "
                                  f"got {type(spec).__name__}")
    qm = restore_derived(qmodel_np)
    q = stem_and_head_leaves(spec, qm, dev)
    q["blocks"] = {f"s{s}b{b}": _block_leaves(qm[f"stage{s}"][str(b)], dev, executor == "mixed")
                   for s, depth in enumerate(spec.depths) for b in range(depth)}
    return QEffNetInt8Unfused(spec, q, executor)


def load_static_int8(fold_dir: str, device: DeviceLike = None, *,
                     executor: str = "int8") -> QEffNetInt8Unfused:
    """A stage-4 EfficientNet or MobileNetV2 artifact directory -> the model.
    The mixed executor reads ``model_static_int8_mixed.msgpack``, else the
    shared ``model_static_int8.msgpack``."""
    with open(os.path.join(fold_dir, "spec.json")) as f:
        spec_dict = json.load(f)
    which = "static_int8"
    if executor == "mixed" and os.path.exists(
            os.path.join(fold_dir, "model_static_int8_mixed.msgpack")):
        which = "static_int8_mixed"
    return from_jax_qmodel(spec_dict, load_checkpoint_raw(fold_dir, which), device,
                           executor=executor)
