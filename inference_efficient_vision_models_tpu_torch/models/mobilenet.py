"""Functional float MobileNetV2 (inverted residuals, depthwise convs), the
port of the JAX package's ``models/mobilenet.py``.

Plain functions on nested dicts of tensors with the JAX package's keys
(``stem``, ``stem_bn``, ``stage{s}/{b}/{expand,dw,project}`` and their
BatchNorms, ``last``, ``last_bn``, ``fc``), in the layouts of
``models.resnet``: OIHW conv kernels (a depthwise kernel (C, 1, 3, 3)) in
channels-last memory on the GPU, an (in, out) fc matrix; ``params_from_jax``
/ ``params_to_jax`` convert from and to the JAX layout (HWIO, a depthwise
kernel (3, 3, 1, C)) in which checkpoints are stored. Casts follow the JAX
package: each conv computes in the compute dtype, the BatchNorms in fp32;
fp32 forwards run with TF32 off. The classifier dropout is left out, as in
the JAX package (the identity in eval).

Structure (stock 1.0x multiplier; ``mobilenet_v2_050`` / ``_075`` / ``_140``
scale the widths as torchvision's ``width_mult`` does):
  3x3/2 stem conv -> BN -> ReLU6
  7 stages of inverted-residual blocks (t, c, n, s):
    (1,16,1,1) (6,24,2,2) (6,32,3,2) (6,64,4,2) (6,96,3,1) (6,160,3,2) (6,320,1,1)
    block = [1x1 expand -> BN -> ReLU6]? -> 3x3 depthwise(s) -> BN -> ReLU6
            -> 1x1 project -> BN, residual add when stride=1 and cin=cout
  1x1 conv -> 1280 -> BN -> ReLU6 -> global average pool -> linear head
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from ..utils.device import DeviceLike, exact_fp32, resolve_device
from .efficientnet import depthwise_conv2d
from .resnet import _conv_w, batch_norm, conv2d, param_count, params_from_jax, params_to_jax

__all__ = ["MobileNetV2Spec", "mobilenet_v2_spec", "init", "apply", "relu6",
           "depthwise_conv2d", "param_count", "params_from_jax", "params_to_jax"]

Params = Dict[str, Any]
State = Dict[str, Any]

# stock (expansion t, out channels c, repeats n, first stride s) table,
# torchvision mobilenet_v2's inverted_residual_setting
_MBV2_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


@dataclasses.dataclass(frozen=True)
class MobileNetV2Spec:
    """Complete shape description of a (possibly pruned) MobileNetV2.

    ``stage_widths[s]`` is the project-conv output width shared by every
    block in stage ``s`` (residual adds couple them). ``hidden_widths[s][b]``
    is the expanded (depthwise) width of block ``b``: a free prunable group
    when ``has_expand[s][b]``; otherwise (t=1 blocks) it equals the block's
    input width and belongs to the input's coupled group.
    """

    name: str
    depths: Tuple[int, ...]
    stage_widths: Tuple[int, ...]
    stage_strides: Tuple[int, ...]
    hidden_widths: Tuple[Tuple[int, ...], ...]
    has_expand: Tuple[Tuple[bool, ...], ...]
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
                    last_width: int | None = None) -> "MobileNetV2Spec":
        """The same network at other widths (the pruner's edit)."""
        return dataclasses.replace(
            self,
            stage_widths=tuple(stage_widths) if stage_widths is not None else self.stage_widths,
            hidden_widths=(_freeze(hidden_widths) if hidden_widths is not None
                           else self.hidden_widths),
            stem_width=stem_width if stem_width is not None else self.stem_width,
            last_width=last_width if last_width is not None else self.last_width,
        )

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["__kind__"] = "mobilenet_v2"
        return d

    @staticmethod
    def from_dict(d: Dict) -> "MobileNetV2Spec":
        d = {k: v for k, v in d.items() if k not in ("__kind__", "__extra__")}
        for k in ("depths", "stage_widths", "stage_strides"):
            d[k] = tuple(d[k])
        d["hidden_widths"] = _freeze(d["hidden_widths"])
        d["has_expand"] = tuple(tuple(bool(x) for x in st) for st in d["has_expand"])
        return MobileNetV2Spec(**d)


def _freeze(nested) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(int(w) for w in st) for st in nested)


def _make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision's channel rounding: nearest multiple, never <90% of v."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def mobilenet_v2_spec(name: str = "mobilenet_v2", num_classes: int = 6, in_chans: int = 3
                      ) -> MobileNetV2Spec:
    """torchvision-compatible MobileNetV2 descriptor; ``name`` may carry a
    width-multiplier suffix (``mobilenet_v2_050`` / ``_075`` / ``_140``:
    0.5x / 0.75x / 1.4x, divisible-by-8 rounding, the last conv scaled only
    above 1.0x)."""
    wm = 1.0
    suffix = name.removeprefix("mobilenet_v2").lstrip("_")
    if suffix:
        wm = int(suffix) / 100.0
    stem = _make_divisible(32 * wm) if wm != 1.0 else 32
    depths, widths, strides = [], [], []
    hidden: List[List[int]] = []
    expand: List[List[bool]] = []
    cin = stem
    for t, c, n, s in _MBV2_SETTING:
        if wm != 1.0:
            c = _make_divisible(c * wm)
        depths.append(n)
        widths.append(c)
        strides.append(s)
        h_row, e_row = [], []
        for b in range(n):
            h_row.append(int(round((cin if b == 0 else c) * t)))
            e_row.append(t != 1)
            cin = c
        hidden.append(h_row)
        expand.append(e_row)
    return MobileNetV2Spec(
        name=name,
        depths=tuple(depths),
        stage_widths=tuple(widths),
        stage_strides=tuple(strides),
        hidden_widths=_freeze(hidden),
        has_expand=tuple(tuple(r) for r in expand),
        stem_width=stem,
        last_width=_make_divisible(1280 * max(1.0, wm)) if wm != 1.0 else 1280,
        num_classes=num_classes,
        in_chans=in_chans,
    )


# --------------------------------------------------------------------------
# init (torchvision's MobileNetV2 scheme)
# --------------------------------------------------------------------------


def init(spec: MobileNetV2Spec, generator: torch.Generator, device: DeviceLike = None
         ) -> Tuple[Params, State]:
    """Random parameters drawn as the JAX ``init`` draws them (not the same
    numbers: ``generator`` is torch's): Kaiming-normal fan_out convs (a
    depthwise kernel's fan is k*k), unit BN, an N(0, 0.01) fc with zero bias.
    On the GPU unless ``device="cpu"``."""
    dev = resolve_device(device)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=generator.device) * std).to(dev)

    def conv(kh, kw, cin, cout):
        return {"w": _conv_w(normal((cout, cin, kh, kw), math.sqrt(2.0 / (kh * kw * cout))))}

    def bn(c):
        return ({"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)},
                {"mean": torch.zeros(c, device=dev), "var": torch.ones(c, device=dev)})

    params: Params = {"stem": conv(3, 3, spec.in_chans, spec.stem_width)}
    state: State = {}
    params["stem_bn"], state["stem_bn"] = bn(spec.stem_width)
    for s, depth in enumerate(spec.depths):
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
            bp["dw"] = {"w": _conv_w(normal((h, 1, 3, 3), math.sqrt(2.0 / 9)))}
            bp["dw_bn"], bs["dw_bn"] = bn(h)
            bp["project"] = conv(1, 1, h, cout)
            bp["project_bn"], bs["project_bn"] = bn(cout)
            lp[str(b)], ls[str(b)] = bp, bs
        params[f"stage{s}"], state[f"stage{s}"] = lp, ls
    params["last"] = conv(1, 1, spec.stage_widths[-1], spec.last_width)
    params["last_bn"], state["last_bn"] = bn(spec.last_width)
    params["fc"] = {"w": normal((spec.last_width, spec.num_classes), 0.01),
                    "b": torch.zeros(spec.num_classes, device=dev)}
    return params, state


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def apply(
    spec: MobileNetV2Spec,
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
        h = relu6(h)
        for s, depth in enumerate(spec.depths):
            sname = f"stage{s}"
            new_state[sname] = {}
            for b in range(depth):
                h, new_state[sname][str(b)] = _apply_block(
                    spec, params[sname][str(b)], state[sname][str(b)], h, s, b,
                    train=train, compute_dtype=compute_dtype)
        h = conv2d(h, params["last"]["w"], stride=1, padding=0, dtype=compute_dtype)
        h, new_state["last_bn"] = batch_norm(h, params["last_bn"], state["last_bn"], train=train)
        h = relu6(h)
        feats = h.float().mean(dim=(2, 3))
        if return_features:
            return feats, new_state
        return feats @ params["fc"]["w"] + params["fc"]["b"], new_state


def _apply_block(spec, p, st, x, s, b, *, train, compute_dtype):
    new_st: State = {}
    h = x
    if spec.has_expand[s][b]:
        h = conv2d(h, p["expand"]["w"], stride=1, padding=0, dtype=compute_dtype)
        h, new_st["expand_bn"] = batch_norm(h, p["expand_bn"], st["expand_bn"], train=train)
        h = relu6(h)
    h = depthwise_conv2d(h, p["dw"]["w"], stride=spec.block_stride(s, b), padding=1,
                         dtype=compute_dtype)
    h, new_st["dw_bn"] = batch_norm(h, p["dw_bn"], st["dw_bn"], train=train)
    h = relu6(h)
    h = conv2d(h, p["project"]["w"], stride=1, padding=0, dtype=compute_dtype)
    h, new_st["project_bn"] = batch_norm(h, p["project_bn"], st["project_bn"], train=train)
    if spec.has_residual(s, b):
        h = h + x
    return h, new_st
