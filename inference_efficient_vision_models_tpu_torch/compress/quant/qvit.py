"""Quantized ViT: calibration taps, the static and dynamic INT8 conversions
and their forwards on the int8 matmul kernel, the port of the JAX package's
``compress/quant/qvit.py``.

* ``fold`` / ``apply_folded``: a ViT has no BatchNorm, so the folded model
  is its fp32 params (JAX layout); ``apply_folded`` is the float forward,
  with the activation taps the conversion consumes at every dense layer's
  input (``input``, ``b{i}qkv``, ``b{i}proj``, ``b{i}mlp1``, ``b{i}mlp2``,
  ``head``);
* ``convert_static_int8``: per-output-channel symmetric int8 weights,
  calibrated input qparams for every dense layer, the ImageNet
  normalization folded into a u8 patch embed (raw uint8 pixels in); numpy
  on the host as the JAX package converts, so the integer leaves are its;
* the static executor (``apply_int8``, ``apply_int8_bf16``): every dense
  layer runs ``int8_matmul_requant``, which quantizes its float input
  inside the kernel: the patch embed, qkv, proj, mlp1 (GELU in the
  epilogue), mlp2 and the head, 50 launches per ViT-Tiny forward;
* ``convert_dynamic_int8`` / ``apply_dynamic_int8``: every dense layer int8
  with a per-batch activation scale (torch ``quantize_dynamic`` semantics),
  found on the device and read by the kernel's dynamic route
  (``int8_matmul_requant_dynamic``): 49 launches per ViT-Tiny forward, the
  patch embed a float conv as in JAX, the GELU exact-erf glue on mlp1's
  fp32 output.

LayerNorm, attention and the residual adds stay plain PyTorch. ``act_dtype``
is the activation carrier between layers: fp32 (the reference protocol) or
bf16 (``apply_int8_bf16``; the attention tail then runs in bf16, softmax
included). Routing follows the device as the JAX package's follows its
backend: on a GPU a 16-bit carrier takes the int8-intermediate MLP pair
(``_mlp_pair_fused``, the TPU's route; ``IEVM_VIT_MLP_FUSE=0`` takes two
separate denses, as in JAX), on the CPU the two MLP denses stay separate, as
the JAX package runs off the TPU. ``impl="plain"`` keeps the routing and
swaps every kernel for its plain PyTorch version, the reference the kernel
path is held against on the GPU; a CPU tensor always takes them.

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
from ...data.pipeline import normalize_images
from ...models import vit as vit_mod
from ...models.registry import spec_from_dict
from ...models.vit import ViTSpec, layer_norm
from ...ops.im2col import patch_matrix
from ...ops.int8_matmul import (
    dynamic_qparams,
    int8_matmul_requant,
    int8_matmul_requant_dynamic,
    int8_matmul_requant_dynamic_plain,
    int8_matmul_requant_plain,
    pack_weight,
)
from ...utils.device import DeviceLike, exact_fp32, resolve_device
from . import stemfold
from .observers import (
    ObserverState,
    minmax_qparams_affine,
    quantize_weight_per_channel,
)
from .qresnet import _conv_leaf, _t32

__all__ = ["ADAROUND_SKIP", "fold", "place_folded", "apply_folded", "calibrate",
           "convert_static_int8", "serializable", "restore_derived", "convert_dynamic_int8",
           "QViTInt8", "QViTDynamic", "apply_int8", "apply_int8_bf16", "apply_dynamic_int8",
           "from_jax_qmodel", "from_dynamic_qmodel", "load_static_int8"]

_DENSE = ("qkv", "proj", "mlp1", "mlp2")

# the conversion transforms the patch-embed kernel (the normalization fold)
# before quantizing it, so AdaRound cannot target its grid
ADAROUND_SKIP = ("patch_embed",)


# --------------------------------------------------------------------------
# the folded float model and its taps
# --------------------------------------------------------------------------


def fold(spec: ViTSpec, params, state) -> Dict:
    """A ViT has no BatchNorm: the folded model is a copy of its fp32 params
    (JAX layout, numpy)."""
    del spec, state
    return _f32_tree(params)


def place_folded(folded: Dict, device: DeviceLike = None, dtype=None) -> Dict:
    """A folded tree in the JAX layout (numpy or CPU tensors) -> tensors on
    ``device``, the layouts kept (the ViT's HWIO patch embed is a matrix to
    ``apply``), floating leaves cast to ``dtype`` if given."""
    dev = resolve_device(device)

    def put(tree):
        if isinstance(tree, dict):
            return {k: put(v) for k, v in tree.items()}
        t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.array(tree))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return put(folded)


def _patch_embed(spec: ViTSpec, x: torch.Tensor, pe: Dict) -> torch.Tensor:
    """The VALID stride-p patch conv in x's dtype (fp32 on the served paths)
    as one matmul over the patch matrix -> (B, tokens - 1, dim)."""
    y = patch_matrix(x, spec.patch) @ pe["w"].to(x.dtype).reshape(-1, spec.dim) + pe["b"].to(
        x.dtype)
    return y.reshape(x.shape[0], -1, spec.dim)


def apply_folded(spec: ViTSpec, folded: Dict, x, *, with_taps: bool = False,
                 return_features: bool = False, stem_out=None, tap_fn=None):
    """Forward of the folded model (``place_folded``) on NHWC float images in
    the compute dtype (fp32 unless ``x`` is fp16 or bf16) -> logits, or the
    fp32 cls features, or (logits, taps) with ``with_taps`` (the JAX taps
    forward's order of operations, in x's dtype: fp32 as JAX runs it, or
    another for a calibration control). ``tap_fn(name, t) -> t'`` intercepts
    each tap and its result re-enters the flow; it takes the taps forward, as
    ``with_taps`` does (differentiable: no fused MLP). ``stem_out`` (a
    precomputed patch-embed map) skips the patch conv, serving only. fp32
    runs with TF32 off."""
    if stem_out is not None and (with_taps or tap_fn is not None):
        raise ValueError("stem_out is a serving hook: it takes no taps")
    with exact_fp32():
        if not with_taps and tap_fn is None:
            src = stem_out if stem_out is not None else x
            dtype = src.dtype if src.dtype in (torch.bfloat16, torch.float16) else torch.float32
            out, _ = vit_mod.apply(spec, folded, {}, x, compute_dtype=dtype,
                                   return_features=return_features, patch_out=stem_out)
            return out
        taps: Dict[str, torch.Tensor] = {}

        def tap(name, t):
            taps[name] = t
            return t if tap_fn is None else tap_fn(name, t)

        x = tap("input", x)
        tokens = _patch_embed(spec, x, folded["patch_embed"])
        b = tokens.shape[0]
        cls = folded["cls_token"].expand(b, 1, spec.dim)
        h = torch.cat([cls, tokens], dim=1) + folded["pos_embed"]
        hd = spec.head_dim
        for i in range(spec.depth):
            blk = folded["blocks"][str(i)]
            heads = blk["qkv"]["w"].shape[1] // (3 * hd)
            z = tap(f"b{i}qkv", layer_norm(h, blk["ln1"]))
            qkv = (z @ blk["qkv"]["w"] + blk["qkv"]["b"]).reshape(b, -1, 3, heads, hd)
            qh, kh, vh = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            att = torch.softmax((qh @ kh.transpose(-1, -2)) * hd**-0.5, dim=-1)
            out = tap(f"b{i}proj", (att @ vh).transpose(1, 2).reshape(b, -1, heads * hd))
            # (h + out w) + b: the JAX taps forward adds the bias last
            h = h + out @ blk["proj"]["w"] + blk["proj"]["b"]
            z = tap(f"b{i}mlp1", layer_norm(h, blk["ln2"]))
            z = tap(f"b{i}mlp2", gelu_erf(z @ blk["mlp1"]["w"] + blk["mlp1"]["b"]))
            h = h + z @ blk["mlp2"]["w"] + blk["mlp2"]["b"]
        feats = tap("head", layer_norm(h, folded["norm"])[:, 0])
        logits = feats @ folded["head"]["w"] + folded["head"]["b"]
    return (logits, taps) if with_taps else logits


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU as ``jax.nn.gelu(approximate=False)`` writes it:
    0.5 x erfc(-x sqrt(1/2)), in x's dtype."""
    sqrt_half = float(np.sqrt(0.5).astype(np.float32))
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def calibrate(spec: ViTSpec, folded: Dict, batches, *, max_images: int = 256,
              averaging_constant=0.01, **observer_kw) -> Dict[str, ObserverState]:
    """Every dense layer's input range over at most ``max_images``
    (``calib.calibrate_taps``: TF32 and cuDNN off)."""
    from .calib import calibrate_taps

    return calibrate_taps(apply_folded, spec, folded, batches, max_images=max_images,
                          averaging_constant=averaging_constant, **observer_kw)


# --------------------------------------------------------------------------
# conversions (numpy on the host)
# --------------------------------------------------------------------------


def _qdense_params(d) -> Dict:
    """A dense layer's int8 weights (per output channel) without input qparams."""
    w_q, w_scale = quantize_weight_per_channel(np.asarray(d["w"], np.float32), channel_axis=1)
    return {"w_q": w_q, "w_scale": w_scale, "w_sum": w_q.sum(axis=0, dtype=np.int32),
            "b": np.asarray(d["b"], np.float32)}


def _static_dense_params(d, obs_in) -> Dict:
    scale, zp = minmax_qparams_affine(obs_in.min, obs_in.max)
    return {**_qdense_params(d), "in_scale": np.float32(scale), "in_zp": np.int32(zp)}


def _f32_tree(tree):
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    return np.array(tree, np.float32)


def convert_static_int8(spec: ViTSpec, folded: Dict, observers: Dict[str, ObserverState], *,
                        fold_input: bool = True, image_size=(224, 224)) -> Dict:
    """Folded fp32 ViT (JAX layout, numpy) + calibrated observers -> the
    static-int8 tree the JAX package writes (numpy; int32 leaves int32):
    every dense layer with fixed input qparams; ``fold_input=True`` makes the
    patch embed the u8 int8 conv with the normalization folded in (its
    output stays fp32)."""
    q: Dict = {
        "cls_token": np.array(folded["cls_token"], np.float32),
        "pos_embed": np.array(folded["pos_embed"], np.float32),
        "norm": _f32_tree(folded["norm"]),
        "head": _static_dense_params(folded["head"], observers["head"]),
        "blocks": {},
    }
    s_in, zp_in = minmax_qparams_affine(observers["input"].min, observers["input"].max)
    q["input"] = {"scale": np.float32(s_in), "zp": np.int32(zp_in)}
    if fold_input:
        q["patch_embed"] = stemfold.make_u8_stem(
            folded["patch_embed"]["w"], folded["patch_embed"]["b"],
            ObserverState(0.0, 0.0, True),  # the output stays fp32: no requant
            stride=spec.patch, padding=0, image_size=image_size)
    else:
        q["patch_embed"] = _f32_tree(folded["patch_embed"])
    for i in range(spec.depth):
        blk = folded["blocks"][str(i)]
        q["blocks"][str(i)] = {
            "ln1": _f32_tree(blk["ln1"]), "ln2": _f32_tree(blk["ln2"]),
            **{name: _static_dense_params(blk[name], observers[f"b{i}{name}"])
               for name in _DENSE},
        }
    return q


def serializable(qmodel: Dict) -> Dict:
    """The tree an artifact stores: a VALID patch embed's offset vector ``e``
    is tiny and stays; only a padded stem's offset map (``w_fp`` present)
    would be derived, and ViT patch embeds never have one."""
    pe = qmodel.get("patch_embed", {})
    if "w_fp" in pe and "e" in pe:
        return {**qmodel, "patch_embed": {k: v for k, v in pe.items()
                                          if k not in stemfold.DERIVED_KEYS}}
    return qmodel


def convert_dynamic_int8(spec: ViTSpec, params) -> Dict:
    """fp32 ViT params (JAX layout, numpy) -> the dynamic-int8 tree: every
    dense layer (qkv, proj, mlp1, mlp2, head) int8 per output channel with no
    input qparams, the rest fp32 as it was."""
    q: Dict = {
        "patch_embed": _f32_tree(params["patch_embed"]),
        "cls_token": np.array(params["cls_token"], np.float32),
        "pos_embed": np.array(params["pos_embed"], np.float32),
        "norm": _f32_tree(params["norm"]),
        "head": _qdense_params(params["head"]),
        "blocks": {},
    }
    for i in range(spec.depth):
        blk = params["blocks"][str(i)]
        q["blocks"][str(i)] = {"ln1": _f32_tree(blk["ln1"]), "ln2": _f32_tree(blk["ln2"]),
                               **{name: _qdense_params(blk[name]) for name in _DENSE}}
    return q


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


@dataclasses.dataclass
class QViTDynamic:
    """A dynamic-INT8 ViT on one device; call it on raw uint8 images
    (B, H, W, 3): it normalizes them on the device, as the JAX loader's
    forward does."""

    spec: ViTSpec
    q: Dict
    act_dtype: torch.dtype = torch.float32

    def __call__(self, x: torch.Tensor, *, impl: str = "kernel") -> torch.Tensor:
        return apply_dynamic_int8(self.spec, self.q, normalize_images(x), self.act_dtype,
                                  impl=impl)


def _dyn_leaf(d: Dict, dev: torch.device) -> Dict:
    """A dynamic dense layer: the packed weight and the epilogue vectors."""
    return _conv_leaf({**d, "bias": d["b"]}, dev)


def from_dynamic_qmodel(spec: ViTSpec, qmodel_np: Dict, device: DeviceLike = None,
                        act_dtype: torch.dtype = torch.float32) -> QViTDynamic:
    """A dynamic-int8 ViT tree (``convert_dynamic_int8``, or its artifact as
    the reader gives it) -> the model on ``device``; every weight packed once."""
    dev = resolve_device(device)
    qm = qmodel_np
    q: Dict = {
        "patch_embed": {"w": _t32(qm["patch_embed"]["w"]).to(dev),
                        "b": _t32(qm["patch_embed"]["b"]).to(dev)},
        "cls_token": _t32(qm["cls_token"]).to(dev),
        "pos_embed": _t32(qm["pos_embed"]).to(dev),
        "norm": _ln_leaf(qm["norm"], dev),
        "head": _dyn_leaf(qm["head"], dev),
        "blocks": {},
    }
    for i in range(spec.depth):
        blk = qm["blocks"][str(i)]
        q["blocks"][str(i)] = {"ln1": _ln_leaf(blk["ln1"], dev), "ln2": _ln_leaf(blk["ln2"], dev),
                               **{name: _dyn_leaf(blk[name], dev) for name in _DENSE}}
    return QViTDynamic(spec, q, act_dtype)


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
    fused Pallas pair on the TPU only; ``IEVM_VIT_MLP_FUSE=0`` takes two
    independent denses there too, as it does in JAX."""
    return x.device.type == "cuda" and os.environ.get("IEVM_VIT_MLP_FUSE", "1") == "1"


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


# --------------------------------------------------------------------------
# the dynamic executor
# --------------------------------------------------------------------------


def _dyn_dense(x: torch.Tensor, qd: Dict, *, impl: str, out_dtype=None) -> torch.Tensor:
    """(..., K) float -> (..., N) through a dynamic int8 matmul: the qparams
    of the whole activation found on its device (``dynamic_qparams``, in
    fp32), then the kernel's dynamic route (quantize, int32 dot, fp32
    affine), cast to ``out_dtype`` or ``x.dtype``. No host sync."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    mm = int8_matmul_requant_dynamic if impl == "kernel" else int8_matmul_requant_dynamic_plain
    y = mm(x2, qd["w"], qd["w_scale"], qd["bias"], qd["w_sum"], dynamic_qparams(x2),
           out_dtype=out_dtype or x.dtype)
    return y.reshape(*shape[:-1], -1)


def apply_dynamic_int8(spec: ViTSpec, q: Dict, x: torch.Tensor, act_dtype=torch.float32, *,
                       impl: str = "kernel") -> torch.Tensor:
    """Dynamic-INT8 ViT forward: normalized NHWC fp32 images -> fp32 logits.
    The patch embed is a float conv (fp32, TF32 off); every dense layer is
    int8 with per-batch activation qparams. ``act_dtype`` is the inter-layer
    carrier; quantization and dequantization run in fp32 whatever it is."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    with exact_fp32():
        tokens = _patch_embed(spec, x.float(), q["patch_embed"])
    b = tokens.shape[0]
    cls = q["cls_token"].expand(b, 1, spec.dim)
    h = (torch.cat([cls, tokens], dim=1) + q["pos_embed"]).to(act_dtype)
    hd = spec.head_dim
    for i in range(spec.depth):
        blk = q["blocks"][str(i)]
        heads = blk["qkv"]["w"].n // (3 * hd)
        qkv = _dyn_dense(layer_norm(h, blk["ln1"]), blk["qkv"], impl=impl)
        qh, kh, vh = (qkv.reshape(b, -1, 3, heads, hd)[:, :, j].transpose(1, 2) for j in range(3))
        with exact_fp32():
            out = _int8_attention(qh, kh, vh, hd, act_dtype)
        out = out.transpose(1, 2).reshape(b, -1, heads * hd)
        h = h + _dyn_dense(out, blk["proj"], impl=impl)
        z = gelu_erf(_dyn_dense(layer_norm(h, blk["ln2"]), blk["mlp1"], impl=impl))
        h = h + _dyn_dense(z, blk["mlp2"], impl=impl)
    h = layer_norm(h, q["norm"])
    return _dyn_dense(h[:, 0], q["head"], out_dtype=torch.float32, impl=impl)
