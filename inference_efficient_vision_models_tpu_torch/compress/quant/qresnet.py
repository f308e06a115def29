"""Quantized ResNet: the folded float forward with its calibration taps, the
static-INT8 conversion, and the int8 forward on the two int8 kernels.

The port of the JAX package's ``compress/quant/qresnet.py``:

* ``apply_folded``: the fp32 (or fp16/bf16) forward of the BN-folded model,
  with the activation taps the conversion consumes (what the reference's
  ``prepare_fx`` observers record);
* ``convert_static_int8``: weights -> per-channel symmetric int8,
  activations -> quint8 affine qparams from the observers, the ImageNet
  normalization folded into the stem; numpy on the host, as the JAX package
  converts, so the integer leaves are the JAX package's;
* ``apply_int8``: the static-INT8 forward. Activations are
shifted quint8 (int8 ``q - 128``) in NHWC, weights per-channel symmetric
int8. Every conv runs through a hand-written kernel:

* 3x3 stride-1 convs -> ``conv3x3_s1_int8`` (direct, halo padded in-kernel);
  a basic block's conv2 also adds the identity, applies the ReLU and
  requantizes in its epilogue, so the block's fp32 sum never exists;
* the s2d stem, 3x3 stride-2 convs, 1x1 convs and the fc ->
  ``int8_matmul_requant`` (through im2col for the convs).

``impl="plain"`` runs the same forward with the kernels' plain PyTorch
versions on any device, the reference the kernel path is held against on
the GPU. A CPU tensor always takes the plain versions.

The model is loaded from the JAX package's converted pytree (nested dicts
of numpy arrays): weights are packed once into the kernels' layout and
per-tensor qparams become Python numbers, so a forward needs no host sync.
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
from ...data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ...models.registry import spec_from_dict
from ...models.resnet import _conv_w, place
from ...models.widths import ResNetSpec
from ...ops.conv3x3 import conv3x3_s1_int8, conv3x3_s1_int8_plain
from ...ops.im2col import conv_int8_im2col
from ...ops.int8_matmul import int8_matmul_requant, int8_matmul_requant_plain, pack_weight
from ...ops.space_to_depth import remap_stem_weights_s2d, space_to_depth_device
from ...utils.device import DeviceLike, exact_fp32, resolve_device
from .fold import fold_conv_bn as fold  # noqa: F401  (the family-module API)
from .observers import (
    ObserverState,
    dequantize_affine_shifted,
    minmax_qparams_affine,
    quantize_weight_per_channel,
)


# --------------------------------------------------------------------------
# the folded float forward and its taps
# --------------------------------------------------------------------------


def place_folded(folded: Dict, device: DeviceLike = None, dtype=None) -> Dict:
    """A folded tree in the JAX layout (numpy or CPU tensors, HWIO kernels)
    -> the tree ``apply_folded`` takes: tensors on ``device`` (the GPU unless
    ``device="cpu"``), OIHW kernels, floating leaves cast to ``dtype`` if given."""

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.array(tree))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.permute(3, 2, 0, 1) if t.ndim == 4 else t

    return place(conv(folded), device)


def _conv_f(x, leaf, stride: int, padding: int, relu: bool, groups: int = 1):
    y = F.conv2d(x, leaf["w"], leaf["b"], stride=stride, padding=padding, groups=groups)
    return F.relu(y) if relu else y


def apply_folded(spec: ResNetSpec, folded: Dict, x, *, with_taps: bool = False,
                 return_features: bool = False):
    """Forward of the folded model (``place_folded``) on NHWC float images in
    the model's dtype -> logits, or the pooled features (pre-classifier), or
    (logits, taps) with ``with_taps``.

    The taps are the quantization points the conversion consumes, NHWC as
    the JAX package's (views on the GPU, whose activations are channels-last).
    fp32 runs with TF32 off."""
    taps: Dict[str, torch.Tensor] = {}

    def tap(name, t):
        taps[name] = t.permute(0, 2, 3, 1) if t.ndim == 4 else t
        return t

    with exact_fp32():
        x = tap("input", _conv_w(x.permute(0, 3, 1, 2)))
        t = tap("stem", _conv_f(x, folded["conv1"], 2, 3, relu=True))
        t = F.max_pool2d(t, 3, 2, 1)

        for s, depth in enumerate(spec.depths):
            for b in range(depth):
                blk = folded[f"layer{s + 1}"][str(b)]
                stride = spec.block_stride(s, b)
                identity = t
                if spec.block == "basic":
                    h = _conv_f(t, blk["conv1"], stride, 1, relu=True)
                    h = tap(f"l{s}b{b}i0", h)
                    h = _conv_f(h, blk["conv2"], 1, 1, relu=False)
                else:
                    h = _conv_f(t, blk["conv1"], 1, 0, relu=True)
                    h = tap(f"l{s}b{b}i0", h)
                    h = _conv_f(h, blk["conv2"], stride, 1, relu=True, groups=spec.groups)
                    h = tap(f"l{s}b{b}i1", h)
                    h = _conv_f(h, blk["conv3"], 1, 0, relu=False)
                if "down" in blk:
                    identity = _conv_f(t, blk["down"], stride, 0, relu=False)
                t = tap(f"l{s}b{b}o", F.relu(h + identity))

        feats = tap("feat", t.mean(dim=(2, 3)))
        if return_features:
            return feats
        logits = feats @ folded["fc"]["w"] + folded["fc"]["b"]
    return (logits, taps) if with_taps else logits


def calibrate(spec: ResNetSpec, folded: Dict, batches, *, max_images: int = 256,
              averaging_constant=0.01, **observer_kw) -> Dict[str, ObserverState]:
    """Activation-range calibration over at most ``max_images`` (the
    reference's budget); ``observer='minmax'|'percentile'|'entropy'``
    (``calib.calibrate_taps``)."""
    from .calib import calibrate_taps

    return calibrate_taps(apply_folded, spec, folded, batches, max_images=max_images,
                          averaging_constant=averaging_constant, **observer_kw)


# --------------------------------------------------------------------------
# conversion (numpy on the host)
# --------------------------------------------------------------------------


def _t32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a copy: msgpack leaves are read-only


def restore_stem_offsets(stem: Dict) -> Dict:
    """(Re)compute the derived affine-offset maps ``e`` / ``e4`` of the
    normalization-folded stem, on the CPU in fp32:

        E = conv_zero-pad(d_img, w_fp) + 128 * s_w * sum(w_q)

    with ``d = -mean/std``; ``e4`` is the same for the s2d 4x4 stem. Both
    are (1, H/2, W/2, C) NHWC float32 numpy arrays, as the JAX package keeps them."""
    d = -_t32(IMAGENET_MEAN) / _t32(IMAGENET_STD)
    h, wid = (int(v) for v in np.asarray(stem["input_hw"]))
    w_fp = _t32(stem["w_fp"])  # (7, 7, 3, C) HWIO
    w_q = _t32(stem["w_q"])
    w_scale = _t32(stem["w_scale"])
    w4_q = _t32(stem["w4_q"])
    w4_scale = _t32(stem["w4_scale"])

    d_img = d.reshape(1, 3, 1, 1).expand(1, 3, h, wid)
    conv_d = F.conv2d(d_img, w_fp.permute(3, 2, 0, 1), stride=2, padding=3)
    e = conv_d.permute(0, 2, 3, 1) + 128.0 * w_scale * w_q.sum(dim=(0, 1, 2))
    d12 = d.repeat(4).reshape(1, 12, 1, 1).expand(1, 12, h // 2, wid // 2)
    conv_d4 = F.conv2d(F.pad(d12, (2, 1, 2, 1)),
                       remap_stem_weights_s2d(w_fp).permute(3, 2, 0, 1))
    e4 = conv_d4.permute(0, 2, 3, 1) + 128.0 * w4_scale * w4_q.sum(dim=(0, 1, 2))
    return {**stem, "e": e.contiguous().numpy(), "e4": e4.contiguous().numpy()}


STEM_DERIVED_KEYS = ("e", "e4")


def _folded_input_stem(spec, folded, obs_out, image_size) -> Dict:
    """The stem conv with the ImageNet normalization folded in, consuming raw
    uint8: W' = W * k (k_c = 1 / (255 sigma_c)) quantized per channel, in the
    7x7 and the space-to-depth 4x4 form; the offset maps ``e`` / ``e4`` are
    derived (``restore_stem_offsets``) from the stored fp32 kernel ``w_fp``."""
    w = np.asarray(folded["conv1"]["w"], np.float32)  # (7, 7, 3, C)
    b = np.asarray(folded["conv1"]["b"], np.float32)
    k = 1.0 / (255.0 * np.asarray(IMAGENET_STD, np.float32))
    w_prime = w * k.reshape(1, 1, 3, 1)
    w_q, w_scale = quantize_weight_per_channel(w_prime, channel_axis=3)
    w4_q, w4_scale = quantize_weight_per_channel(
        remap_stem_weights_s2d(torch.from_numpy(w_prime)).numpy(), channel_axis=3)
    scale, zp = minmax_qparams_affine(obs_out.min, obs_out.max)
    stem = {
        "w_q": w_q,
        "w_scale": w_scale,
        "w_fp": w.astype(np.float32),  # the exact offset term conv(d, W) needs it
        "bias": b,
        "w4_q": w4_q,
        "w4_scale": w4_scale,
        "input_hw": np.asarray(image_size, np.int32),
        "out_scale": np.float32(scale),
        "out_zp": np.int32(zp),
    }
    return restore_stem_offsets(stem)


def serializable(qmodel: Dict) -> Dict:
    """Checkpoint view of a static-int8 model: the derived offset maps left out."""
    if "stem" not in qmodel or "e" not in qmodel.get("stem", {}):
        return qmodel
    stem = {k: v for k, v in qmodel["stem"].items() if k not in STEM_DERIVED_KEYS}
    return {**qmodel, "stem": stem}


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


def convert_static_int8(spec: ResNetSpec, folded: Dict, observers: Dict[str, ObserverState],
                        *, image_size=(224, 224)) -> Dict:
    """Folded fp32 model (JAX layout, numpy) + calibrated observers -> the
    static-int8 tree the JAX package writes (numpy; its int32 leaves int32,
    as JAX's 32-bit arrays store them). The ImageNet normalization is folded
    into the stem (the JAX package's default ``fold_input=True``, the only
    stem the int8 executor runs), so the model consumes raw uint8 pixels
    with an exact input quantization."""
    q: Dict = {}
    s_in, zp_in = minmax_qparams_affine(observers["input"].min, observers["input"].max)
    q["input"] = {"scale": np.float32(s_in), "zp": np.int32(zp_in)}
    q["stem"] = _folded_input_stem(spec, folded, observers["stem"], image_size)
    for s, depth in enumerate(spec.depths):
        lname = f"layer{s + 1}"
        q[lname] = {}
        for b in range(depth):
            blk = folded[lname][str(b)]
            out: Dict = {"conv1": _qconv_params(blk["conv1"]["w"], blk["conv1"]["b"],
                                                observers[f"l{s}b{b}i0"])}
            if spec.block == "basic":
                out["conv2"] = _qconv_params(blk["conv2"]["w"], blk["conv2"]["b"])
            else:
                out["conv2"] = _qconv_params(blk["conv2"]["w"], blk["conv2"]["b"],
                                             observers[f"l{s}b{b}i1"])
                out["conv3"] = _qconv_params(blk["conv3"]["w"], blk["conv3"]["b"])
            if "down" in blk:
                out["down"] = _qconv_params(blk["down"]["w"], blk["down"]["b"])
            o_scale, o_zp = minmax_qparams_affine(observers[f"l{s}b{b}o"].min,
                                                  observers[f"l{s}b{b}o"].max)
            out["out_scale"] = np.float32(o_scale)
            out["out_zp"] = np.int32(o_zp)
            q[lname][str(b)] = out

    f_scale, f_zp = minmax_qparams_affine(observers["feat"].min, observers["feat"].max)
    w_q, w_scale = quantize_weight_per_channel(np.asarray(folded["fc"]["w"], np.float32),
                                               channel_axis=1)
    q["fc"] = {
        "w_q": w_q,
        "w_scale": w_scale,
        "w_sum": w_q.sum(axis=0, dtype=np.int32),
        "bias": np.asarray(folded["fc"]["b"], np.float32),
        "in_scale": np.float32(f_scale),
        "in_zp": np.int32(f_zp),
    }
    return q


def restore_derived(qmodel: Dict) -> Dict:
    """Add the stem offsets a checkpoint leaves out."""
    if "stem" in qmodel and "input_hw" in qmodel["stem"] and "e" not in qmodel["stem"]:
        return {**qmodel, "stem": restore_stem_offsets(qmodel["stem"])}
    return qmodel


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------


def _conv_leaf(leaf: Dict, device: torch.device) -> Dict:
    out = {
        "w": pack_weight(torch.from_numpy(np.array(leaf["w_q"], np.int8)).to(device)),
        "w_scale": _t32(leaf["w_scale"]).to(device),
        "bias": _t32(leaf["bias"]).to(device),
        "w_sum": torch.from_numpy(np.array(leaf["w_sum"], np.int32)).to(device),
    }
    if "out_scale" in leaf:
        out["out_scale"] = float(np.float32(leaf["out_scale"]))
        out["out_zp"] = int(leaf["out_zp"])
    return out


@dataclasses.dataclass
class QResNetInt8:
    """A static-INT8 ResNet on one device; call it on raw uint8 images
    (B, H, W, 3) or their space-to-depth layout (B, H/2, W/2, 12)."""

    spec: ResNetSpec
    q: Dict

    def __call__(self, x: torch.Tensor, *, impl: str = "kernel") -> torch.Tensor:
        return apply_int8(self.spec, self.q, x, impl=impl)


def from_jax_qmodel(spec_dict: Dict, qmodel_np: Dict, device: DeviceLike = None) -> QResNetInt8:
    """The JAX package's converted static-int8 pytree (nested dicts of numpy
    arrays, as ``msgpack_restore`` gives it) -> the port's model on ``device``."""
    dev = resolve_device(device)
    spec = spec_from_dict(spec_dict)
    if spec.groups > 1:
        raise NotImplementedError("grouped int8 convs (ResNeXt) are not ported yet")
    qm = restore_derived(qmodel_np)
    st = qm["stem"]
    if "e4" not in st:
        raise NotImplementedError("only the normalization-folded s2d stem is ported")
    n_stem = int(np.asarray(st["bias"]).shape[0])
    q: Dict = {
        "stem": {
            "w": pack_weight(torch.from_numpy(np.array(st["w4_q"], np.int8)).to(dev)),
            "w_scale": _t32(st["w4_scale"]).to(dev),
            "bias": _t32(st["bias"]).to(dev),
            "w_sum": torch.zeros(n_stem, dtype=torch.int32, device=dev),  # zp_s = 0
            "e4": _t32(st["e4"]).to(dev),
            "out_scale": float(np.float32(st["out_scale"])),
            "out_zp": int(st["out_zp"]),
        }
    }
    for s, depth in enumerate(spec.depths):
        lname = f"layer{s + 1}"
        q[lname] = {}
        for b in range(depth):
            blk = qm[lname][str(b)]
            q[lname][str(b)] = {
                **{k: _conv_leaf(v, dev) for k, v in blk.items() if isinstance(v, dict)},
                "out_scale": float(np.float32(blk["out_scale"])),
                "out_zp": int(blk["out_zp"]),
            }
    fc = qm["fc"]
    q["fc"] = {
        **_conv_leaf(fc, dev),
        "in_scale": float(np.float32(fc["in_scale"])),
        "in_zp": int(fc["in_zp"]),
    }
    return QResNetInt8(spec, q)


def load_static_int8(fold_dir: str, device: DeviceLike = None) -> QResNetInt8:
    """A stage-4 artifact directory (``spec.json`` + ``model_static_int8.msgpack``)
    -> the port's model on ``device``."""
    with open(os.path.join(fold_dir, "spec.json")) as f:
        spec_dict = json.load(f)
    return from_jax_qmodel(spec_dict, load_checkpoint_raw(fold_dir, "static_int8"), device)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _requant(y: torch.Tensor, scale: float, zp: int) -> torch.Tensor:
    # true division as the JAX executor does (a 0-d tensor: CUDA divides by
    # a Python scalar as y * (1/s))
    s = torch.full((), scale, dtype=torch.float32, device=y.device)
    q = torch.round(y / s) + float(zp)
    return (torch.clamp(q, 0.0, 255.0) - 128.0).to(torch.int8)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride 2 / pad 1 max pool of int8 NHWC, padded with -128: the max
    of nine strided views, exact in the quantized domain (monotonic)."""
    n, h, w, c = x.shape
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=-128)
    out = None
    for dy in range(3):
        for dx in range(3):
            v = xp[:, dy : dy + 2 * (ho - 1) + 1 : 2, dx : dx + 2 * (wo - 1) + 1 : 2, :]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


def _conv_q(x_s, zp, in_scale, qc, stride, padding, *, relu, requant, impl):
    """One quantized conv: the direct 3x3 kernel for 3x3/s1/p1, else im2col +
    the int8 matmul kernel. Returns int8 (requant) or fp32, NHWC."""
    rq = dict(out_scale=qc["out_scale"], out_zp=qc["out_zp"]) if requant else {}
    if qc["w"].shape[:2] == (3, 3) and stride == 1 and padding == 1:
        fn = conv3x3_s1_int8 if impl == "kernel" else conv3x3_s1_int8_plain
        return fn(x_s, qc["w"], qc["w_scale"], qc["bias"], qc["w_sum"],
                  in_scale=in_scale, in_zp=zp, relu=relu, **rq)
    return conv_int8_im2col(x_s, qc["w"], qc["w_scale"], qc["bias"], qc["w_sum"],
                            stride=stride, padding=padding, in_scale=in_scale, in_zp=zp,
                            relu=relu, backend=impl, **rq)


def basic_block(blk: Dict, x_in: torch.Tensor, in_scale: float, in_zp: int, stride: int, *,
                impl: str = "kernel") -> torch.Tensor:
    """One basic block -> its int8 output. conv1 (+ ReLU, requant), then
    conv2, whose epilogue adds the identity (the downsample's fp32 output, or
    the block's own int8 input dequantized), applies the ReLU and requantizes
    by division: the JAX executor's ``requant(relu(h + identity))``, with the
    block's fp32 sum never written out."""
    if "down" in blk:
        identity = _conv_q(x_in, in_zp, in_scale, blk["down"], stride, 0,
                           relu=False, requant=False, impl=impl)
    else:
        identity = ("int8", x_in, in_scale, in_zp)
    c1, c2 = blk["conv1"], blk["conv2"]
    a_q = _conv_q(x_in, in_zp, in_scale, c1, stride, 1, relu=True, requant=True, impl=impl)
    conv = conv3x3_s1_int8 if impl == "kernel" else conv3x3_s1_int8_plain
    return conv(a_q, c2["w"], c2["w_scale"], c2["bias"], c2["w_sum"],
                in_scale=c1["out_scale"], in_zp=c1["out_zp"], residual=identity,
                out_scale=blk["out_scale"], out_zp=blk["out_zp"])


def apply_int8(spec: ResNetSpec, q: Dict, x: torch.Tensor, *, impl: str = "kernel") -> torch.Tensor:
    """Static-INT8 inference -> fp32 logits (B, num_classes).

    ``x`` is raw uint8 images (B, H, W, 3) or their s2d layout (B, H/2, W/2, 12);
    the ImageNet normalization is folded into the stem."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    stem = q["stem"]
    if x.dtype != torch.uint8:
        raise ValueError(f"expected raw uint8 images, got {x.dtype}")
    if x.shape[-1] == 3:
        x = space_to_depth_device(x)
    if x.shape[-1] != stem["w"].shape[2]:
        raise ValueError(f"expected 3 or {stem['w'].shape[2]} input channels, got {x.shape[-1]}")

    # stem: u8 -> u - 128 (exact), pad (2, 1) with -128, 4x4/s1 int8 conv with
    # no zp correction (in_zp = 128 -> zp_s = 0), then + e4, ReLU, requant
    x_p = F.pad((x.to(torch.int16) - 128).to(torch.int8), (0, 0, 2, 1, 2, 1), value=-128)
    y = conv_int8_im2col(x_p, stem["w"], stem["w_scale"], stem["bias"], stem["w_sum"],
                         stride=1, padding=0, in_scale=1.0, in_zp=128, backend=impl)
    cur = _requant(torch.relu(y + stem["e4"]), stem["out_scale"], stem["out_zp"])
    cur_scale, cur_zp = stem["out_scale"], stem["out_zp"]
    cur = _max_pool(cur)

    for s, depth in enumerate(spec.depths):
        for b in range(depth):
            blk = q[f"layer{s + 1}"][str(b)]
            stride = spec.block_stride(s, b)
            if spec.block == "basic":
                cur = basic_block(blk, cur, cur_scale, cur_zp, stride, impl=impl)
            else:
                x_in, in_s, in_z = cur, cur_scale, cur_zp
                a_q = _conv_q(x_in, in_z, in_s, blk["conv1"], 1, 0,
                              relu=True, requant=True, impl=impl)
                b_q = _conv_q(a_q, blk["conv1"]["out_zp"], blk["conv1"]["out_scale"],
                              blk["conv2"], stride, 1, relu=True, requant=True, impl=impl)
                h = _conv_q(b_q, blk["conv2"]["out_zp"], blk["conv2"]["out_scale"],
                            blk["conv3"], 1, 0, relu=False, requant=False, impl=impl)
                if "down" in blk:
                    identity = _conv_q(x_in, in_z, in_s, blk["down"], stride, 0,
                                       relu=False, requant=False, impl=impl)
                else:
                    identity = dequantize_affine_shifted(x_in, in_s, in_z)
                cur = _requant(torch.relu(h + identity), blk["out_scale"], blk["out_zp"])
            cur_scale, cur_zp = blk["out_scale"], blk["out_zp"]

    feats = dequantize_affine_shifted(cur, cur_scale, cur_zp).mean(dim=(1, 2))
    fc = q["fc"]
    mm = int8_matmul_requant if impl == "kernel" else int8_matmul_requant_plain
    return mm(feats, fc["w"], fc["w_scale"], fc["bias"], fc["w_sum"],
              in_scale=fc["in_scale"], in_zp=fc["in_zp"])
