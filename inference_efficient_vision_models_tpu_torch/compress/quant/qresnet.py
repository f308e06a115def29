"""Static-INT8 ResNet forward on the two int8 kernels.

The port of the JAX package's ``compress/quant/qresnet.py`` executor
(``restore_stem_offsets``, ``apply_int8`` and its helpers). Activations are
shifted quint8 (int8 ``q - 128``) in NHWC, weights per-channel symmetric
int8. Every conv runs through a hand-written kernel:

* 3x3 stride-1 convs -> ``conv3x3_s1_int8`` (direct, halo padded in-kernel);
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
from ...models.widths import ResNetSpec
from ...ops.conv3x3 import conv3x3_s1_int8, conv3x3_s1_int8_plain
from ...ops.im2col import conv_int8_im2col
from ...ops.int8_matmul import int8_matmul_requant, int8_matmul_requant_plain, pack_weight
from ...ops.space_to_depth import remap_stem_weights_s2d, space_to_depth_device
from ...utils.device import DeviceLike, resolve_device
from .observers import dequantize_affine_shifted

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
            x_in, in_s, in_z = cur, cur_scale, cur_zp
            if spec.block == "basic":
                a_q = _conv_q(x_in, in_z, in_s, blk["conv1"], stride, 1,
                              relu=True, requant=True, impl=impl)
                h = _conv_q(a_q, blk["conv1"]["out_zp"], blk["conv1"]["out_scale"],
                            blk["conv2"], 1, 1, relu=False, requant=False, impl=impl)
            else:
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
