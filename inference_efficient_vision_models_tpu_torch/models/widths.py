"""ResNet width descriptors: every prunable channel count is a field, so a
(possibly pruned) architecture is rebuilt from its spec JSON alone. The
port's copy of the JAX package's ``models/widths.py`` (ResNet part)."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    """Complete shape description of a (possibly pruned) ResNet.

    ``stage_widths[s]`` is the output width of every block in stage ``s``
    (post-expansion for bottleneck nets); ``inner_widths[s][b]`` are the
    widths of the non-final convs of block ``b``: one entry for a basic
    block (conv1), two for a bottleneck (conv1, conv2). ``groups`` > 1 makes
    every bottleneck conv2 grouped (ResNeXt)."""

    name: str
    block: str  # 'basic' | 'bottleneck'
    depths: Tuple[int, ...]
    stage_widths: Tuple[int, ...]
    inner_widths: Tuple[Tuple[Tuple[int, ...], ...], ...]
    stem_width: int
    num_classes: int
    in_chans: int = 3
    groups: int = 1

    def block_in_width(self, s: int, b: int) -> int:
        if b > 0:
            return self.stage_widths[s]
        return self.stem_width if s == 0 else self.stage_widths[s - 1]

    def block_stride(self, s: int, b: int) -> int:
        return 2 if (s > 0 and b == 0) else 1

    def has_downsample(self, s: int, b: int) -> bool:
        return self.block_stride(s, b) != 1 or self.block_in_width(s, b) != self.stage_widths[s]

    @property
    def stem_tied_to_stage0(self) -> bool:
        """True when the stem output sits in stage 0's residual group (a
        basic-block net: stage 0 has no downsample, so pruning the stem
        width prunes every stage-0 block output with it)."""
        return not self.has_downsample(0, 0)

    def with_widths(self, stage_widths=None, inner_widths=None,
                    stem_width: int | None = None) -> "ResNetSpec":
        """The spec with some widths replaced (the pruner's edit)."""
        return dataclasses.replace(
            self,
            stage_widths=tuple(stage_widths) if stage_widths is not None else self.stage_widths,
            inner_widths=(_freeze_inner(inner_widths) if inner_widths is not None
                          else self.inner_widths),
            stem_width=stem_width if stem_width is not None else self.stem_width,
        )

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict) -> "ResNetSpec":
        d = {k: v for k, v in d.items() if k != "__extra__"}
        d["depths"] = tuple(d["depths"])
        d["stage_widths"] = tuple(d["stage_widths"])
        d["inner_widths"] = _freeze_inner(d["inner_widths"])
        return ResNetSpec(**d)


def _freeze_inner(inner) -> Tuple[Tuple[Tuple[int, ...], ...], ...]:
    return tuple(tuple(tuple(int(w) for w in blk) for blk in stage) for stage in inner)


def _uniform_inner(block: str, depths, planes) -> Tuple:
    n_inner = 1 if block == "basic" else 2
    return _freeze_inner([[(p,) * n_inner for _ in range(d)] for d, p in zip(depths, planes)])


_PLANES = (64, 128, 256, 512)

# Bottleneck depth layouts keyed by torchvision's depth naming.
_DEPTH_TABLE = {
    26: (2, 2, 2, 2),
    38: (3, 3, 3, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}

_TABLE = {
    # name: (block, depths, expansion, groups, base_width)
    "resnet18": ("basic", (2, 2, 2, 2), 1, 1, 64),
    "resnet34": ("basic", (3, 4, 6, 3), 1, 1, 64),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 4, 1, 64),
    "resnet101": ("bottleneck", (3, 4, 23, 3), 4, 1, 64),
    "resnet152": ("bottleneck", (3, 8, 36, 3), 4, 1, 64),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), 4, 32, 4),
    "resnext101_32x8d": ("bottleneck", (3, 4, 23, 3), 4, 32, 8),
    "resnext26_32x4d": ("bottleneck", (2, 2, 2, 2), 4, 32, 4),
    "wide_resnet50_2": ("bottleneck", (3, 4, 6, 3), 4, 1, 128),
    "wide_resnet101_2": ("bottleneck", (3, 4, 23, 3), 4, 1, 128),
}

_RESNEXT_RE = re.compile(r"^resnext(\d+)_(\d+)x(\d+)d$")
_WIDE_RE = re.compile(r"^wide_resnet(\d+)_(\d+)$")


def _parse_resnet_name(name: str):
    """``resnext<D>_<G>x<W>d`` / ``wide_resnet<D>_<k>`` -> table row, or None."""
    m = _RESNEXT_RE.match(name)
    if m:
        depth, groups, base_width = map(int, m.groups())
        if depth in _DEPTH_TABLE and groups >= 1 and base_width >= 1:
            return ("bottleneck", _DEPTH_TABLE[depth], 4, groups, base_width)
        return None
    m = _WIDE_RE.match(name)
    if m:
        depth, k = map(int, m.groups())
        if depth in _DEPTH_TABLE and k >= 1:
            return ("bottleneck", _DEPTH_TABLE[depth], 4, 1, 64 * k)
    return None


def resnet_spec(name: str, num_classes: int = 6, in_chans: int = 3) -> ResNetSpec:
    """Stock torchvision-compatible ResNet specs, by name."""
    row = _TABLE.get(name) or _parse_resnet_name(name)
    if row is None:
        raise ValueError(
            f"unknown resnet variant: {name!r} (have {sorted(_TABLE)}, or any parametric "
            f"'resnext<D>_<G>x<W>d' / 'wide_resnet<D>_<k>' name with D in {sorted(_DEPTH_TABLE)})"
        )
    block, depths, expansion, groups, base_width = row
    stage_widths = tuple(p * expansion for p in _PLANES)
    if groups > 1 or base_width != 64:
        inner_planes = tuple(p * base_width // 64 * groups for p in _PLANES)
    else:
        inner_planes = _PLANES
    return ResNetSpec(
        name=name,
        block=block,
        depths=depths,
        stage_widths=stage_widths,
        inner_widths=_uniform_inner(block, depths, inner_planes),
        stem_width=64,
        num_classes=num_classes,
        in_chans=in_chans,
        groups=groups,
    )
