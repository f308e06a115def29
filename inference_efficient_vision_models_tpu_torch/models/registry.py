"""Spec JSON -> spec dataclass. The port has the ResNet, EfficientNet and
ViT families so far."""

from __future__ import annotations

from typing import Dict, Union

from .efficientnet import EfficientNetSpec
from .vit import ViTSpec
from .widths import ResNetSpec


def spec_from_dict(d: Dict) -> Union[ResNetSpec, EfficientNetSpec, ViTSpec]:
    """Spec JSON -> ResNetSpec, EfficientNetSpec or ViTSpec, dispatched as the
    JAX package's ``spec_from_dict`` does; MobileNetV2 dicts (``__kind__`` or
    ``hidden_widths``) are not ported yet."""
    kind = d.get("__kind__")
    if kind == "vit" or (kind is None and "patch" in d):
        return ViTSpec.from_dict(d)
    if kind == "efficientnet" or (kind is None and "se_widths" in d):
        return EfficientNetSpec.from_dict(d)
    if kind is not None or "hidden_widths" in d:
        raise NotImplementedError(f"model family {kind or 'mobilenet_v2'} is not ported yet")
    return ResNetSpec.from_dict(d)
