"""Static-INT8 ViT forward on the int8 matmul kernel.

The port of the JAX package's ``compress/quant/qvit.py`` static executor
(``restore_derived``, ``_static_dense``, ``_mlp_pair_fused``,
``_int8_attention``, ``apply_int8``, ``apply_int8_bf16``). Weights are
per-output-channel symmetric int8, every dense layer has calibrated input
qparams, and the patch embed is the normalization-folded u8 stem (raw uint8
pixels in). Every dense layer runs ``int8_matmul_requant``, which quantizes
its float input inside the kernel: the patch embed, qkv, proj, mlp1 (GELU in
the epilogue), mlp2 and the head, 50 launches per ViT-Tiny forward.
LayerNorm, attention and the residual adds stay plain PyTorch.

``act_dtype`` is the activation carrier between layers: fp32 (the reference
protocol) or bf16 (``apply_int8_bf16``; the attention tail then runs in bf16,
softmax included). Routing follows the device as the JAX package's follows
its backend: on a GPU a 16-bit carrier takes the int8-intermediate MLP pair
(``_mlp_pair_fused``, the TPU's route), on the CPU the two MLP denses stay
separate, as the JAX package runs off the TPU. ``impl="plain"`` keeps the
routing and swaps every kernel for its plain PyTorch version, the reference
the kernel path is held against on the GPU; a CPU tensor always takes them.

The JAX ``_static_dense_fast`` has no separate counterpart: ``_static_dense``
already is one fused kernel call (quantize, int32 dot, affine, GELU, cast),
the chain the JAX docstring calls bit-for-bit equal.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch

from ...core.artifacts import load_checkpoint_raw
from ...models.registry import spec_from_dict
from ...models.vit import ViTSpec, layer_norm
from ...ops.int8_matmul import int8_matmul_requant, int8_matmul_requant_plain, pack_weight
from ...utils.device import DeviceLike, resolve_device
from . import stemfold
from .qresnet import _conv_leaf, _t32

__all__ = ["QViTInt8", "apply_int8", "apply_int8_bf16", "from_jax_qmodel", "load_static_int8",
           "restore_derived"]


def restore_derived(qmodel: Dict) -> Dict:
    """A VALID patch embed stores its offset vector ``e``; only a padded stem
    (``w_fp`` without ``e``) has an offset map to rebuild."""
    pe = qmodel.get("patch_embed", {})
    if "w_fp" in pe and "e" not in pe:
        return {**qmodel, "patch_embed": stemfold.restore_offsets(pe)}
    return qmodel


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------


def _dense_leaf(d: Dict, dev: torch.device) -> Dict:
    """A static dense layer: the packed weight and the epilogue vectors on the
    device, the input qparams as Python numbers so a forward needs no host
    sync."""
    return {**_conv_leaf({**d, "bias": d["b"]}, dev),
            "in_scale": float(np.float32(d["in_scale"])), "in_zp": int(d["in_zp"])}


def _ln_leaf(p: Dict, dev: torch.device) -> Dict:
    return {"scale": _t32(p["scale"]).to(dev), "bias": _t32(p["bias"]).to(dev)}


@dataclasses.dataclass
class QViTInt8:
    """A static-INT8 ViT on one device with its activation carrier; call it
    on raw uint8 images (B, H, W, 3)."""

    spec: ViTSpec
    q: Dict
    act_dtype: torch.dtype = torch.float32

    def __call__(self, x: torch.Tensor, *, impl: str = "kernel") -> torch.Tensor:
        return apply_int8(self.spec, self.q, x, self.act_dtype, impl=impl)


def from_jax_qmodel(spec_dict: Dict, qmodel_np: Dict, device: DeviceLike = None,
                    act_dtype: torch.dtype = torch.float32) -> QViTInt8:
    """The JAX package's converted static-int8 ViT pytree (nested dicts of
    numpy arrays, as ``msgpack_restore`` gives it) -> the port's model on
    ``device``; every weight is packed once here."""
    dev = resolve_device(device)
    spec = spec_from_dict(spec_dict)
    if not isinstance(spec, ViTSpec):
        raise ValueError(f"expected a ViT spec, got {type(spec).__name__}")
    if act_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"act_dtype must be float32 or bfloat16, got {act_dtype}")
    qm = restore_derived(qmodel_np)
    pe = qm["patch_embed"]
    if "e" not in pe:
        raise NotImplementedError("only the normalization-folded u8 patch embed is ported "
                                  "(artifacts converted with fold_input=True)")
    n_pe = int(np.asarray(pe["bias"]).shape[0])
    q: Dict = {
        "patch_embed": {
            "w": pack_weight(torch.from_numpy(np.array(pe["w_q"], np.int8)).to(dev)),
            "w_scale": _t32(pe["w_scale"]).to(dev),
            "bias": _t32(pe["bias"]).to(dev),
            "w_sum": torch.zeros(n_pe, dtype=torch.int32, device=dev),  # zp_s = 0
            "e": _t32(pe["e"]).to(dev),
        },
        "cls_token": _t32(qm["cls_token"]).to(dev),
        "pos_embed": _t32(qm["pos_embed"]).to(dev),
        "norm": _ln_leaf(qm["norm"], dev),
        "head": _dense_leaf(qm["head"], dev),
        "blocks": {},
    }
    for i in range(spec.depth):
        blk = qm["blocks"][str(i)]
        q["blocks"][str(i)] = {
            "ln1": _ln_leaf(blk["ln1"], dev),
            "ln2": _ln_leaf(blk["ln2"], dev),
            **{name: _dense_leaf(blk[name], dev) for name in ("qkv", "proj", "mlp1", "mlp2")},
        }
    return QViTInt8(spec, q, act_dtype)


def load_static_int8(fold_dir: str, device: DeviceLike = None, *,
                     act_dtype: torch.dtype = torch.float32) -> QViTInt8:
    """A stage-4 ViT artifact directory -> the model. The bf16 carrier reads
    ``model_static_int8_bf16.msgpack`` where it exists, else the shared
    ``model_static_int8.msgpack``, as the JAX ``load_quantized`` does."""
    with open(os.path.join(fold_dir, "spec.json")) as f:
        spec_dict = json.load(f)
    which = "static_int8"
    if act_dtype == torch.bfloat16 and os.path.exists(
            os.path.join(fold_dir, "model_static_int8_bf16.msgpack")):
        which = "static_int8_bf16"
    return from_jax_qmodel(spec_dict, load_checkpoint_raw(fold_dir, which), device, act_dtype)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _matmul(impl: str):
    return int8_matmul_requant if impl == "kernel" else int8_matmul_requant_plain


def _static_dense(x: torch.Tensor, qd: Dict, *, impl: str, out_dtype=None,
                  act=None) -> torch.Tensor:
    """(..., K) float -> (..., N) through a calibrated int8 matmul: quantize,
    int32 dot, fp32 affine, optional erf-GELU, cast to ``out_dtype`` or
    ``x.dtype``, all in one kernel call."""
    shape = x.shape
    y = _matmul(impl)(x.reshape(-1, shape[-1]).contiguous(), qd["w"], qd["w_scale"], qd["bias"],
                      qd["w_sum"], in_scale=qd["in_scale"], in_zp=qd["in_zp"], act=act,
                      out_dtype=out_dtype or x.dtype)
    return y.reshape(*shape[:-1], -1)


def _mlp_pair_fused(z: torch.Tensor, qd1: Dict, qd2: Dict, out_dtype, *,
                    impl: str) -> torch.Tensor:
    """mlp1 (+GELU) -> mlp2 with the hidden tensor kept int8: mlp1's epilogue
    requantizes straight to mlp2's input qparams, so the (B*T, 4*D) hidden
    makes one int8 round trip and mlp2 reads it without a quantize. It skips
    the bf16 rounding of the hidden that the separate route takes."""
    shape = z.shape
    mm = _matmul(impl)
    z8 = mm(z.reshape(-1, shape[-1]).contiguous(), qd1["w"], qd1["w_scale"], qd1["bias"],
            qd1["w_sum"], in_scale=qd1["in_scale"], in_zp=qd1["in_zp"], act="gelu",
            out_scale=qd2["in_scale"], out_zp=qd2["in_zp"])
    y = mm(z8, qd2["w"], qd2["w_scale"], qd2["bias"], qd2["w_sum"], in_scale=qd2["in_scale"],
           in_zp=qd2["in_zp"], out_dtype=out_dtype)
    return y.reshape(*shape[:-1], -1)


def _int8_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, hd: int,
                    act_dtype) -> torch.Tensor:
    """The attention tail (B, H, T, hd): in fp32 throughout for the fp32
    carrier; with a 16-bit carrier the products, the score tensor and the
    softmax are in the carrier dtype, the scale rounded to it first, as the
    JAX executor multiplies by ``jnp.asarray(hd**-0.5, act_dtype)``."""
    if act_dtype == torch.float32:
        att = torch.softmax((qh @ kh.transpose(-1, -2)) * hd**-0.5, dim=-1)
        return att @ vh
    qh, kh, vh = (t.to(act_dtype) for t in (qh, kh, vh))
    scale = float(torch.tensor(hd**-0.5, dtype=act_dtype))
    att = torch.softmax((qh @ kh.transpose(-1, -2)) * scale, dim=-1)
    return att @ vh


def _use_pair_route(x: torch.Tensor) -> bool:
    """The int8-intermediate MLP pair on a GPU, as the JAX package takes its
    fused Pallas pair on the TPU only."""
    return x.device.type == "cuda"


def apply_int8(spec: ViTSpec, q: Dict, x: torch.Tensor, act_dtype=torch.float32, *,
               impl: str = "kernel") -> torch.Tensor:
    """Static-INT8 ViT forward: raw uint8 NHWC images -> fp32 logits
    (B, num_classes). ``act_dtype`` is the inter-layer carrier; quantization,
    the affine dequantization and LayerNorm statistics stay fp32."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    t = stemfold.apply_u8_stem(q["patch_embed"], x, stride=spec.patch, pad=0, act="none",
                               impl=impl)
    b = t.shape[0]
    cls = q["cls_token"].expand(b, 1, spec.dim)
    h = (torch.cat([cls, t.reshape(b, -1, spec.dim)], dim=1) + q["pos_embed"]).to(act_dtype)

    pair = act_dtype != torch.float32 and _use_pair_route(x)
    hd = spec.head_dim
    for i in range(spec.depth):
        blk = q["blocks"][str(i)]
        heads = blk["qkv"]["w"].n // (3 * hd)
        qkv = _static_dense(layer_norm(h, blk["ln1"]), blk["qkv"], impl=impl)
        qh, kh, vh = (qkv.reshape(b, -1, 3, heads, hd)[:, :, j].transpose(1, 2) for j in range(3))
        out = _int8_attention(qh, kh, vh, hd, act_dtype).transpose(1, 2).reshape(b, -1, heads * hd)
        h = h + _static_dense(out, blk["proj"], impl=impl)
        z = layer_norm(h, blk["ln2"])
        if pair:
            h = h + _mlp_pair_fused(z, blk["mlp1"], blk["mlp2"], act_dtype, impl=impl)
        else:
            z = _static_dense(z, blk["mlp1"], act="gelu", impl=impl)
            h = h + _static_dense(z, blk["mlp2"], impl=impl)

    h = layer_norm(h, q["norm"])
    return _static_dense(h[:, 0], q["head"], out_dtype=torch.float32, impl=impl)


def apply_int8_bf16(spec: ViTSpec, q: Dict, x: torch.Tensor, *,
                    impl: str = "kernel") -> torch.Tensor:
    """The ``static_int8_bf16`` executor: the same artifact, bf16 carrier."""
    return apply_int8(spec, q, x, torch.bfloat16, impl=impl)
