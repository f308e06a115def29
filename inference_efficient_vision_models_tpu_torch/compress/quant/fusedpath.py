"""Whole-block fused int8 MBConv forward (EfficientNet and MobileNetV2).

The port of the JAX package's ``compress/quant/fusedpath.py``. ``pack_fused``
packs each converted static-int8 MBConv block into the operand layout of
``ops.fused_mbconv`` once, in numpy on the host: requant scalars in one row,
zp * sum(w) corrections folded into bias vectors, depthwise weights as exact
fp32 integers. ``apply_int8_fused`` then runs the network with one
``fused_mbconv_block`` call per block (every block, stride 2 included: the
CUDA kernels have no lowering envelope, so ``fusable`` / ``pick_nb`` of the
TPU path have no counterpart here). An EfficientNet block takes SiLU and its
SE gate (three launches), a MobileNetV2 block ReLU6 and no gate (two). The
stem and the head conv run the int8 matmul kernel; the activation, requant,
the mean pool and the fc's float input stay as in the unfused executor
(``qeffnet``); the family module (``engine.quant_module``: ``qeffnet`` or
``qmobilenet``) gives the activation and the block plan.

``QEffNetInt8`` is the served model of either family:
``load_static_int8_fused(fold_dir)`` reads a stage-4 artifact,
``from_jax_qmodel`` carries the JAX package's converted pytree (numpy
leaves) onto a device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch

from ...core.artifacts import load_checkpoint_raw
from ...models.efficientnet import EfficientNetSpec
from ...models.mobilenet import MobileNetV2Spec
from ...models.registry import spec_from_dict
from ...ops.fused_mbconv import fused_mbconv_block, fused_mbconv_block_plain, to_device_packed
from ...utils.device import DeviceLike, resolve_device
from . import qeffnet
from .engine import quant_module
# the stem and head of both families (``act`` picks the family's), and
# EfficientNet's block plan, which callers import from here
from .qeffnet import block_plan, head_logits, stem_int8  # noqa: F401

__all__ = ["pack_fused", "apply_int8_fused", "QEffNetInt8", "from_jax_qmodel",
           "load_static_int8_fused"]


def _scal_row(
    in_scale, in_zp, e, d_scale, d_zp, q_scale, q_zp, o_scale, o_zp
) -> np.ndarray:
    row = np.zeros((1, 12), np.float32)
    row[0, 0] = float(in_zp) - 128.0
    if e is not None:
        row[0, 1] = 1.0 / float(e[0])
        row[0, 2] = float(e[1])
    row[0, 3] = 1.0 / float(d_scale)
    row[0, 4] = float(d_zp)
    row[0, 5] = float(d_scale)
    row[0, 6] = 1.0 / float(q_scale)
    row[0, 7] = float(q_zp)
    row[0, 8] = 1.0 / float(o_scale)
    row[0, 9] = float(o_zp)
    row[0, 10] = float(in_scale)          # residual dequant
    row[0, 11] = float(in_zp) - 128.0
    return row


def _pack_block(blk: Dict, in_scale, in_zp, *, se: bool) -> Dict:
    out: Dict = {}
    if "expand" in blk:
        e = blk["expand"]
        eff = np.float32(in_scale) * np.asarray(e["w_scale"], np.float32)
        out["we"] = np.asarray(e["w_q"]).reshape(e["w_q"].shape[-2], e["w_q"].shape[-1])
        out["ve"] = np.stack([
            eff,
            np.asarray(e["bias"], np.float32)
            - (float(in_zp) - 128.0) * np.asarray(e["w_sum"], np.float32) * eff,
        ])
        dw_in_scale = float(e["out_scale"])
        e_pair = (e["out_scale"], e["out_zp"])
    else:
        dw_in_scale = float(in_scale)
        e_pair = None

    d = blk["dw"]
    kk = d["w_q"].shape[0] * d["w_q"].shape[1]
    out["wdw"] = np.asarray(d["w_q"], np.float32).reshape(kk, d["w_q"].shape[-1])
    out["vdw"] = np.stack([
        dw_in_scale * np.asarray(d["w_scale"], np.float32),
        np.asarray(d["bias"], np.float32),
    ])

    if se:
        out["srw"] = np.asarray(qeffnet._deq_se(blk["se_reduce"]), np.float32)
        out["srb"] = np.asarray(blk["se_reduce"]["b"], np.float32).reshape(1, -1)
        out["sew"] = np.asarray(qeffnet._deq_se(blk["se_expand"]), np.float32)
        out["seb"] = np.asarray(blk["se_expand"]["b"], np.float32).reshape(1, -1)
        q_scale, q_zp = float(blk["se_scale"]), float(blk["se_zp"])
    else:
        q_scale, q_zp = float(d["out_scale"]), float(d["out_zp"])

    p = blk["project"]
    effp = np.float32(q_scale) * np.asarray(p["w_scale"], np.float32)
    out["wp"] = np.asarray(p["w_q"]).reshape(p["w_q"].shape[-2], p["w_q"].shape[-1])
    out["vp"] = np.stack([
        effp,
        np.asarray(p["bias"], np.float32)
        - (q_zp - 128.0) * np.asarray(p["w_sum"], np.float32) * effp,
    ])
    out["scal"] = _scal_row(
        in_scale, in_zp, e_pair,
        d["out_scale"], d["out_zp"], q_scale, q_zp,
        blk["out_scale"], blk["out_zp"],
    )
    return out


def pack_fused(spec, q: Dict) -> Dict:
    """Per-block fused-kernel operands (numpy) for a converted static-int8
    model; ``q`` is the JAX package's pytree with numpy leaves."""
    se = isinstance(spec, EfficientNetSpec)
    qf: Dict = {}
    cur_scale, cur_zp = float(q["stem"]["out_scale"]), float(q["stem"]["out_zp"])
    for s, depth in enumerate(spec.depths):
        for b in range(depth):
            blk = q[f"stage{s}"][str(b)]
            qf[f"s{s}b{b}"] = _pack_block(blk, cur_scale, cur_zp, se=se)
            cur_scale, cur_zp = blk["out_scale"], blk["out_zp"]
    return qf


# --------------------------------------------------------------------------
# the served model
# --------------------------------------------------------------------------


@dataclasses.dataclass
class QEffNetInt8:
    """A static-INT8 EfficientNet or MobileNetV2 on one device, run by the
    fused executor; call it on raw uint8 images (B, H, W, 3)."""

    spec: object  # EfficientNetSpec | MobileNetV2Spec
    q: Dict    # stem, last, fc leaves on the device
    qf: Dict   # per-block packed operands on the device

    def __call__(self, x: torch.Tensor, *, impl: str = "kernel") -> torch.Tensor:
        return apply_int8_fused(self.spec, self.q, self.qf, x, impl=impl)


def from_jax_qmodel(spec_dict: Dict, qmodel_np: Dict, device: DeviceLike = None) -> QEffNetInt8:
    """The JAX package's converted static-int8 EfficientNet or MobileNetV2
    pytree (nested dicts of numpy arrays, as ``msgpack_restore`` gives it) ->
    the port's fused-executor model on ``device``."""
    dev = resolve_device(device)
    spec = spec_from_dict(spec_dict)
    if not isinstance(spec, (EfficientNetSpec, MobileNetV2Spec)):
        raise NotImplementedError(f"the fused executor serves MBConv networks, got "
                                  f"{type(spec).__name__}")
    qm = qeffnet.restore_derived(qmodel_np)
    q = qeffnet.stem_and_head_leaves(spec, qm, dev)
    qf = {k: to_device_packed(v, dev) for k, v in pack_fused(spec, qm).items()}
    return QEffNetInt8(spec, q, qf)


def load_static_int8_fused(fold_dir: str, device: DeviceLike = None) -> QEffNetInt8:
    """A stage-4 EfficientNet or MobileNetV2 artifact directory (``spec.json`` and
    ``model_static_int8_fused.msgpack``, else ``model_static_int8.msgpack``,
    the file the fused executor shares with the unfused one) -> the model."""
    with open(os.path.join(fold_dir, "spec.json")) as f:
        spec_dict = json.load(f)
    which = ("static_int8_fused"
             if os.path.exists(os.path.join(fold_dir, "model_static_int8_fused.msgpack"))
             else "static_int8")
    return from_jax_qmodel(spec_dict, load_checkpoint_raw(fold_dir, which), device)


def apply_int8_fused(spec, q: Dict, qf: Dict, x: torch.Tensor, *,
                     impl: str = "kernel") -> torch.Tensor:
    """Static-int8 forward with one fused block call per MBConv block ->
    fp32 logits (B, num_classes), with the family's stem, activation and
    head. ``x`` is raw uint8 NHWC; ``impl="plain"`` runs every kernel's plain
    PyTorch version (the reference the kernel path is held against on the
    GPU); a CPU tensor always takes them."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    fam = quant_module(spec)
    block = fused_mbconv_block if impl == "kernel" else fused_mbconv_block_plain
    cur = stem_int8(q, x, impl=impl, act=fam.ACT)
    for name, k, stride, residual in fam.block_plan(spec):
        cur = block(cur, qf[name], kernel=k, stride=stride, act=fam.ACT,
                    x_res=cur if residual else None)
    return head_logits(q, cur, impl=impl, act=fam.ACT)
