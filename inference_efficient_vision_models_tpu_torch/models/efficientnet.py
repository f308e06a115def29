"""Functional float EfficientNet (MBConv: inverted residuals + squeeze-
excitation), the port of the JAX package's ``models/efficientnet.py``.

Plain functions on nested dicts of tensors with the JAX package's keys
(``stem``, ``stem_bn``, ``stage{s}/{b}/{expand,dw,se_reduce,se_expand,project}``
and their BatchNorms, ``last``, ``last_bn``, ``fc``), in the layouts of
``models.resnet``: OIHW conv kernels (a depthwise kernel (C, 1, k, k)) in
channels-last memory on the GPU, (in, out) SE and fc matrices;
``params_from_jax`` / ``params_to_jax`` convert from and to the JAX layout
(HWIO, a depthwise kernel (k, k, 1, C)) in which checkpoints are stored.
Casts follow the JAX package: each conv computes in the compute dtype, the
BatchNorms and the SE squeeze in fp32; fp32 forwards run with TF32 off.
Stochastic depth and the classifier dropout are left out, as in the JAX
package (both are the identity in eval).

Structure (B0; B1..B7 via width/depth multipliers + the divisible-by-8 rule):
  3x3/2 stem conv -> BN -> SiLU
  7 stages of MBConv blocks (t, c, n, s, k):
    (1,16,1,1,3) (6,24,2,2,3) (6,40,2,2,5) (6,80,3,2,3)
    (6,112,3,1,5) (6,192,4,2,5) (6,320,1,1,3)
    block = [1x1 expand -> BN -> SiLU]? -> kxk depthwise(s) -> BN -> SiLU
            -> SE(squeeze = block_cin // 4) -> 1x1 project -> BN,
            residual add when stride=1 and cin=cout
  1x1 conv -> 1280 -> BN -> SiLU -> global average pool -> linear head
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from ..utils.device import DeviceLike, exact_fp32, resolve_device
from .resnet import _conv_w, batch_norm, conv2d, param_count, params_from_jax, params_to_jax

__all__ = ["EfficientNetSpec", "efficientnet_spec", "init", "apply", "silu", "se_gate",
           "depthwise_conv2d", "param_count", "params_from_jax", "params_to_jax"]

Params = Dict[str, Any]
State = Dict[str, Any]

# stock B0 table: (expansion t, out channels c, repeats n, first stride s,
# depthwise kernel k), torchvision efficientnet's bneck_conf rows
_EFFNET_SETTING = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# (width_mult, depth_mult) per variant, torchvision _efficientnet_conf
_VARIANTS = {
    "efficientnet_b0": (1.0, 1.0),
    "efficientnet_b1": (1.0, 1.1),
    "efficientnet_b2": (1.1, 1.2),
    "efficientnet_b3": (1.2, 1.4),
    "efficientnet_b4": (1.4, 1.8),
    "efficientnet_b5": (1.6, 2.2),
    "efficientnet_b6": (1.8, 2.6),
    "efficientnet_b7": (2.0, 3.1),
}


def _make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision's channel rounding: nearest multiple, never <90% of v."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@dataclasses.dataclass(frozen=True)
class EfficientNetSpec:
    """Complete shape description of a (possibly pruned) EfficientNet.

    ``stage_widths[s]`` is the project-conv output width shared by every
    block in stage ``s``. ``hidden_widths[s][b]`` is the expanded
    (depthwise + SE-gated) width; ``has_expand[s][b]`` says whether the
    block has a 1x1 expand conv; ``se_widths[s][b]`` is the SE squeeze width.
    """

    name: str
    depths: Tuple[int, ...]
    stage_widths: Tuple[int, ...]
    stage_strides: Tuple[int, ...]
    stage_kernels: Tuple[int, ...]
    hidden_widths: Tuple[Tuple[int, ...], ...]
    has_expand: Tuple[Tuple[bool, ...], ...]
    se_widths: Tuple[Tuple[int, ...], ...]
    stem_width: int
    last_width: int
    num_classes: int
    in_chans: int = 3

    def block_in_width(self, s: int, b: int) -> int:
        if b > 0:
            return self.stage_widths[s]
        return self.stem_width if s == 0 else self.stage_widths[s - 1]

    def block_stride(self, s: int, b: int) -> int:
        return self.stage_strides[s] if b == 0 else 1

    def has_residual(self, s: int, b: int) -> bool:
        return (
            self.block_stride(s, b) == 1
            and self.block_in_width(s, b) == self.stage_widths[s]
        )

    def feature_width(self) -> int:
        return self.last_width

    def with_widths(self, stage_widths=None, hidden_widths=None, stem_width: int | None = None,
                    last_width: int | None = None, se_widths=None) -> "EfficientNetSpec":
        """The same network at other widths (the pruner's edit)."""
        return dataclasses.replace(
            self,
            stage_widths=tuple(stage_widths) if stage_widths is not None else self.stage_widths,
            hidden_widths=(_freeze(hidden_widths) if hidden_widths is not None
                           else self.hidden_widths),
            stem_width=stem_width if stem_width is not None else self.stem_width,
            last_width=last_width if last_width is not None else self.last_width,
            se_widths=_freeze(se_widths) if se_widths is not None else self.se_widths,
        )

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["__kind__"] = "efficientnet"
        return d

    @staticmethod
    def from_dict(d: Dict) -> "EfficientNetSpec":
        d = {k: v for k, v in d.items() if k not in ("__kind__", "__extra__")}
        for k in ("depths", "stage_widths", "stage_strides", "stage_kernels"):
            d[k] = tuple(d[k])
        for k in ("hidden_widths", "se_widths"):
            d[k] = _freeze(d[k])
        d["has_expand"] = tuple(tuple(bool(x) for x in st) for st in d["has_expand"])
        return EfficientNetSpec(**d)


def _freeze(nested) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(int(w) for w in st) for st in nested)


def efficientnet_spec(
    name: str = "efficientnet_b0", num_classes: int = 6, in_chans: int = 3
) -> EfficientNetSpec:
    """Stock torchvision-compatible EfficientNet-B0..B7 descriptor."""
    if name not in _VARIANTS:
        raise ValueError(f"unknown efficientnet variant {name!r}; have {sorted(_VARIANTS)}")
    wm, dm = _VARIANTS[name]

    depths, widths, strides, kernels = [], [], [], []
    hidden: List[List[int]] = []
    expand: List[List[bool]] = []
    se: List[List[int]] = []
    stem = _make_divisible(32 * wm)
    cin = stem
    for t, c, n, s, k in _EFFNET_SETTING:
        c = _make_divisible(c * wm)
        n = int(math.ceil(n * dm))
        depths.append(n)
        widths.append(c)
        strides.append(s)
        kernels.append(k)
        h_row, e_row, se_row = [], [], []
        for b in range(n):
            block_cin = cin if b == 0 else c
            h_row.append(_make_divisible(block_cin * t) if t != 1 else block_cin)
            e_row.append(t != 1)
            # torchvision SqueezeExcitation(expanded, max(1, block_cin // 4))
            se_row.append(max(1, block_cin // 4))
        cin = c
        hidden.append(h_row)
        expand.append(e_row)
        se.append(se_row)
    return EfficientNetSpec(
        name=name,
        depths=tuple(depths),
        stage_widths=tuple(widths),
        stage_strides=tuple(strides),
        stage_kernels=tuple(kernels),
        hidden_widths=_freeze(hidden),
        has_expand=tuple(tuple(r) for r in expand),
        se_widths=_freeze(se),
        stem_width=stem,
        # torchvision: 4 x last stage width (1280 for B0)
        last_width=4 * widths[-1],
        num_classes=num_classes,
        in_chans=in_chans,
    )


# --------------------------------------------------------------------------
# init (torchvision's EfficientNet scheme)
# --------------------------------------------------------------------------


def init(spec: EfficientNetSpec, generator: torch.Generator, device: DeviceLike = None
         ) -> Tuple[Params, State]:
    """Random parameters drawn as the JAX ``init`` draws them (not the same
    numbers: ``generator`` is torch's): Kaiming-normal fan_out convs (a
    depthwise kernel's fan is k*k), unit BN, SE 1x1 convs as (in, out)
    matrices with zero bias, a uniform ±1/sqrt(num_classes) fc with zero
    bias. On the GPU unless ``device="cpu"``."""
    dev = resolve_device(device)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=generator.device) * std).to(dev)

    def conv(kh, kw, cin, cout):
        return {"w": _conv_w(normal((cout, cin, kh, kw), math.sqrt(2.0 / (kh * kw * cout))))}

    def dw(k, c):
        return {"w": _conv_w(normal((c, 1, k, k), math.sqrt(2.0 / (k * k))))}

    def se(cin, cout):
        return {"w": normal((cin, cout), math.sqrt(2.0 / cout)),
                "b": torch.zeros(cout, device=dev)}

    def bn(c):
        return ({"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)},
                {"mean": torch.zeros(c, device=dev), "var": torch.ones(c, device=dev)})

    params: Params = {"stem": conv(3, 3, spec.in_chans, spec.stem_width)}
    state: State = {}
    params["stem_bn"], state["stem_bn"] = bn(spec.stem_width)
    for s, depth in enumerate(spec.depths):
        k = spec.stage_kernels[s]
        lp, ls = {}, {}
        for b in range(depth):
            cin, h, cout = spec.block_in_width(s, b), spec.hidden_widths[s][b], spec.stage_widths[s]
            bp: Params = {}
            bs: State = {}
            if spec.has_expand[s][b]:
                bp["expand"] = conv(1, 1, cin, h)
                bp["expand_bn"], bs["expand_bn"] = bn(h)
            elif h != cin:
                raise ValueError(f"t=1 block ({s}, {b}) needs hidden width {h} == input {cin}")
            bp["dw"] = dw(k, h)
            bp["dw_bn"], bs["dw_bn"] = bn(h)
            sq = spec.se_widths[s][b]
            bp["se_reduce"] = se(h, sq)
            bp["se_expand"] = se(sq, h)
            bp["project"] = conv(1, 1, h, cout)
            bp["project_bn"], bs["project_bn"] = bn(cout)
            lp[str(b)], ls[str(b)] = bp, bs
        params[f"stage{s}"], state[f"stage{s}"] = lp, ls
    params["last"] = conv(1, 1, spec.stage_widths[-1], spec.last_width)
    params["last_bn"], state["last_bn"] = bn(spec.last_width)
    bound = 1.0 / math.sqrt(spec.num_classes)
    u = torch.rand((spec.last_width, spec.num_classes), generator=generator,
                   device=generator.device)
    params["fc"] = {"w": (u * (2 * bound) - bound).to(dev),
                    "b": torch.zeros(spec.num_classes, device=dev)}
    return params, state


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def depthwise_conv2d(x, w, stride: int = 1, padding: int = 1, dtype=None):
    """Depthwise conv of an NCHW view, kernel (C, 1, k, k), groups = C (the
    JAX package's ``models/mobilenet.py:depthwise_conv2d``, which XLA's conv
    computes; here cuDNN or PyTorch's own depthwise kernel)."""
    return conv2d(x, w, stride=stride, padding=padding, dtype=dtype, groups=w.shape[0])


def se_gate(h: torch.Tensor, p_reduce, p_expand) -> torch.Tensor:
    """Squeeze-excitation: global mean -> reduce -> SiLU -> expand -> sigmoid
    -> scale, the squeeze path in fp32 whatever ``h``'s dtype."""
    pooled = h.float().mean(dim=(2, 3))
    s = silu(pooled @ p_reduce["w"] + p_reduce["b"])
    s = torch.sigmoid(s @ p_expand["w"] + p_expand["b"])
    return h * s[:, :, None, None].to(h.dtype)


def apply(
    spec: EfficientNetSpec,
    params: Params,
    state: State,
    x: torch.Tensor,
    *,
    train: bool = False,
    compute_dtype=torch.float32,
    return_features: bool = False,
):
    """Forward: NHWC float images -> (logits fp32, new_state), or with
    ``return_features`` the pooled fp32 features instead of the logits."""
    with exact_fp32():
        new_state: State = {}
        h = _conv_w(x.permute(0, 3, 1, 2))
        h = conv2d(h, params["stem"]["w"], stride=2, padding=1, dtype=compute_dtype)
        h, new_state["stem_bn"] = batch_norm(h, params["stem_bn"], state["stem_bn"], train=train)
        h = silu(h)
        for s, depth in enumerate(spec.depths):
            sname = f"stage{s}"
            new_state[sname] = {}
            for b in range(depth):
                h, new_state[sname][str(b)] = _apply_block(
                    spec, params[sname][str(b)], state[sname][str(b)], h, s, b,
                    train=train, compute_dtype=compute_dtype)
        h = conv2d(h, params["last"]["w"], stride=1, padding=0, dtype=compute_dtype)
        h, new_state["last_bn"] = batch_norm(h, params["last_bn"], state["last_bn"], train=train)
        h = silu(h)
        feats = h.float().mean(dim=(2, 3))
        if return_features:
            return feats, new_state
        return feats @ params["fc"]["w"] + params["fc"]["b"], new_state


def _apply_block(spec, p, st, x, s, b, *, train, compute_dtype):
    k = spec.stage_kernels[s]
    new_st: State = {}
    h = x
    if spec.has_expand[s][b]:
        h = conv2d(h, p["expand"]["w"], stride=1, padding=0, dtype=compute_dtype)
        h, new_st["expand_bn"] = batch_norm(h, p["expand_bn"], st["expand_bn"], train=train)
        h = silu(h)
    h = depthwise_conv2d(h, p["dw"]["w"], stride=spec.block_stride(s, b), padding=(k - 1) // 2,
                         dtype=compute_dtype)
    h, new_st["dw_bn"] = batch_norm(h, p["dw_bn"], st["dw_bn"], train=train)
    h = se_gate(silu(h), p["se_reduce"], p["se_expand"])
    h = conv2d(h, p["project"]["w"], stride=1, padding=0, dtype=compute_dtype)
    h, new_st["project_bn"] = batch_norm(h, p["project_bn"], st["project_bn"], train=train)
    if spec.has_residual(s, b):
        h = h + x
    return h, new_st
