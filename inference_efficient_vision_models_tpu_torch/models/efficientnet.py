"""EfficientNet width descriptors: the port's copy of the spec part of the
JAX package's ``models/efficientnet.py`` (the float model comes later).

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
from typing import Dict, List, Tuple

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
