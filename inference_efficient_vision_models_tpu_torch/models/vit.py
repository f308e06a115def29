"""Functional Vision Transformer (timm-style patch16 ViT).

The port of the JAX package's ``models/vit.py``: plain functions on a nested
dict of tensors that keeps the JAX layouts (HWIO patch embed, (in, out)
linears), so ``params_from_jax`` carries weights across without a transpose.
Pre-norm blocks, a learnable cls token and position embeddings, exact-erf
GELU MLP; no BatchNorm, so there is no state. The patch embed is a stride-p
VALID conv, computed as one matmul over the patch matrix.

``apply`` has the family signature ``registry.apply_model`` calls:
``(spec, params, state, x, *, train, compute_dtype, ...) -> (out, state)``,
with an empty ``state`` passed through (``init`` returns ``(params, {})``
as the JAX ``init`` does). The forward is differentiable by autograd, which
trains the family. ``fused_mlp=True`` runs mlp1 + GELU through
``ops.fused_dense`` (the hand-written CUDA kernel on a CUDA tensor), which
is forward-only, as the JAX Pallas kernel has no VJP: asking for it while
autograd records raises. The other dense layers, attention and LayerNorm
are plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.fused_dense import dense_gelu, dense_gelu_plain
from ..ops.im2col import patch_matrix
from ..utils.device import DeviceLike, resolve_device

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    """``heads``/``mlp_ratio`` describe the stock architecture; structured
    pruning records per-block widths in ``head_counts``/``mlp_hidden``
    (None = uniform stock). ``dim // heads`` stays the per-head dim."""

    name: str
    patch: int
    dim: int
    depth: int
    heads: int
    mlp_ratio: float
    num_classes: int
    image_size: int = 224
    in_chans: int = 3
    head_counts: Optional[Tuple[int, ...]] = None
    mlp_hidden: Optional[Tuple[int, ...]] = None

    @property
    def tokens(self) -> int:
        return 1 + (self.image_size // self.patch) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    def block_heads(self, i: int) -> int:
        return self.head_counts[i] if self.head_counts is not None else self.heads

    def block_mlp_hidden(self, i: int) -> int:
        if self.mlp_hidden is not None:
            return self.mlp_hidden[i]
        return int(self.dim * self.mlp_ratio)

    def with_widths(self, head_counts=None, mlp_hidden=None) -> "ViTSpec":
        return dataclasses.replace(
            self,
            head_counts=tuple(head_counts) if head_counts is not None else self.head_counts,
            mlp_hidden=tuple(mlp_hidden) if mlp_hidden is not None else self.mlp_hidden,
        )

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["__kind__"] = "vit"
        return d

    @staticmethod
    def from_dict(d: Dict) -> "ViTSpec":
        d = {k: v for k, v in d.items() if k not in ("__kind__", "__extra__")}
        for k in ("head_counts", "mlp_hidden"):
            if d.get(k) is not None:
                d[k] = tuple(int(v) for v in d[k])
        return ViTSpec(**d)


_VIT_TABLE = {
    "vit_tiny_patch16_224": (192, 12, 3),
    "vit_small_patch16_224": (384, 12, 6),
    "vit_base_patch16_224": (768, 12, 12),
}


def vit_spec(name: str, num_classes: int = 6, image_size: int = 224) -> ViTSpec:
    if name not in _VIT_TABLE:
        raise ValueError(f"unknown vit variant {name!r} (have {sorted(_VIT_TABLE)})")
    dim, depth, heads = _VIT_TABLE[name]
    return ViTSpec(name=name, patch=16, dim=dim, depth=depth, heads=heads,
                   mlp_ratio=4.0, num_classes=num_classes, image_size=image_size)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


def init(spec: ViTSpec, generator: torch.Generator, device: DeviceLike = None
         ) -> Tuple[Dict, Dict]:
    """(params, {}): truncated normal (±2 std) with std 0.02 for every
    weight, zero biases, unit LayerNorms, as the JAX ``init`` draws them
    (not the same numbers: ``generator`` is torch's), and no state (no
    BatchNorm). On the GPU unless ``device="cpu"``; the draws happen on the
    generator's device and move."""
    dev = resolve_device(device)

    def tn(*shape):
        t = torch.empty(shape, device=generator.device)
        t = torch.nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)
        return t.to(dev)

    def ln(d):
        return {"scale": torch.ones(d, device=dev), "bias": torch.zeros(d, device=dev)}

    def linear(cin, cout):
        return {"w": tn(cin, cout), "b": torch.zeros(cout, device=dev)}

    d = spec.dim
    params: Dict = {
        "patch_embed": {"w": tn(spec.patch, spec.patch, spec.in_chans, d),
                        "b": torch.zeros(d, device=dev)},
        "cls_token": tn(1, 1, d),
        "pos_embed": tn(1, spec.tokens, d),
        "norm": ln(d),
        "head": linear(d, spec.num_classes),
        "blocks": {},
    }
    for i in range(spec.depth):
        attn_dim = spec.block_heads(i) * spec.head_dim
        hidden = spec.block_mlp_hidden(i)
        params["blocks"][str(i)] = {
            "ln1": ln(d), "qkv": linear(d, 3 * attn_dim), "proj": linear(attn_dim, d),
            "ln2": ln(d), "mlp1": linear(d, hidden), "mlp2": linear(hidden, d),
        }
    return params, {}


def params_from_jax(tree, device: DeviceLike = None) -> Dict:
    """The JAX package's ViT params (nested dicts of numpy arrays) -> the
    port's, same keys and layouts, fp32 on ``device``. Also converts the
    (empty) state and AdamW moments, which share the params' structure."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(dev)


def params_to_jax(tree) -> Dict:
    """The inverse of ``params_from_jax``: nested dicts of fp32 numpy arrays
    (C-contiguous copies, never views of the tensors), the same layouts."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy().copy()


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return int(params.numel())


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """Statistics and affine in fp32 (population variance; fp64 for an fp64
    x), cast back to x.dtype."""
    x32 = x if x.dtype == torch.float64 else x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + LN_EPS) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def _attention(x: torch.Tensor, p: Dict, hd: int, dtype) -> torch.Tensor:
    """``hd`` is the per-head dim; the head count comes from the qkv weight."""
    b, t, _ = x.shape
    heads = p["qkv"]["w"].shape[1] // (3 * hd)
    qkv = (x @ p["qkv"]["w"].to(dtype)) + p["qkv"]["b"].to(dtype)
    q, k, v = (qkv.reshape(b, t, 3, heads, hd)[:, :, j].transpose(1, 2) for j in range(3))
    att = (q @ k.transpose(-1, -2)) * (hd**-0.5)
    att = torch.softmax(att.float(), dim=-1).to(dtype)
    out = (att @ v).transpose(1, 2).reshape(b, t, heads * hd)
    return (out @ p["proj"]["w"].to(dtype)) + p["proj"]["b"].to(dtype)


def apply(
    spec: ViTSpec,
    params: Dict,
    state: Dict,
    x: Optional[torch.Tensor],
    *,
    train: bool = False,
    compute_dtype=torch.float32,
    return_features: bool = False,
    patch_out: Optional[torch.Tensor] = None,
    fused_mlp: bool = False,
    impl: str = "kernel",
) -> Tuple[torch.Tensor, Dict]:
    """Forward: NHWC float images -> (logits (B, num_classes) fp32, state),
    or the fp32 cls features with ``return_features``; ``state`` passes
    through (no dropout or BatchNorm, so ``train`` changes nothing).

    ``patch_out`` (a precomputed (B, H/p, W/p, dim) patch-embed activation)
    skips the patch conv; ``x`` is then ignored. ``fused_mlp=True`` runs
    mlp1 + GELU through ``dense_gelu`` (``impl="plain"``: its plain version,
    the reference the kernel path is held against on the GPU), forward only;
    otherwise it is ``gelu(m @ w + b)`` with exact erf."""
    del train
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    dtype = compute_dtype
    if patch_out is None:
        pe = patch_matrix(x.to(dtype), spec.patch) @ params["patch_embed"]["w"].to(dtype).reshape(
            -1, spec.dim) + params["patch_embed"]["b"].to(dtype)
        b = x.shape[0]
    else:
        pe = patch_out.to(dtype)
        b = pe.shape[0]
    tokens = pe.reshape(b, -1, spec.dim)
    cls = params["cls_token"].to(dtype).expand(b, 1, spec.dim)
    h = torch.cat([cls, tokens], dim=1) + params["pos_embed"].to(dtype)

    mlp1 = dense_gelu if impl == "kernel" else dense_gelu_plain
    for i in range(spec.depth):
        blk = params["blocks"][str(i)]
        h = h + _attention(layer_norm(h, blk["ln1"]), blk, spec.head_dim, dtype)
        m = layer_norm(h, blk["ln2"])
        w1, b1 = blk["mlp1"]["w"].to(dtype), blk["mlp1"]["b"].to(dtype)
        if fused_mlp:
            if torch.is_grad_enabled() and (m.requires_grad or w1.requires_grad):
                raise ValueError("fused_mlp=True is forward-only (the fused kernel has no "
                                 "backward): train with the default fused_mlp=False")
            m = mlp1(m, w1, b1)
        else:
            m = torch.nn.functional.gelu((m @ w1) + b1, approximate="none")
        h = h + ((m @ blk["mlp2"]["w"].to(dtype)) + blk["mlp2"]["b"].to(dtype))

    h = layer_norm(h, params["norm"])
    feats = h[:, 0].float()  # cls token
    if return_features:
        return feats, state
    # fp32 head, as JAX promotes a 16-bit head of a cast model
    return feats @ params["head"]["w"].float() + params["head"]["b"].float(), state
