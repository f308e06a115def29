"""Spec JSON -> spec dataclass. The port has the ResNet and EfficientNet
families so far."""

from __future__ import annotations

from typing import Dict, Union

from .efficientnet import EfficientNetSpec
from .widths import ResNetSpec


def spec_from_dict(d: Dict) -> Union[ResNetSpec, EfficientNetSpec]:
    """Spec JSON -> ResNetSpec or EfficientNetSpec; the other families'
    dicts carry ``__kind__`` or family-specific keys and are not ported yet."""
    kind = d.get("__kind__")
    if kind == "efficientnet" or (kind is None and "se_widths" in d):
        return EfficientNetSpec.from_dict(d)
    if kind is not None or any(k in d for k in ("patch", "hidden_widths")):
        raise NotImplementedError(f"model family {kind or 'non-resnet'} is not ported yet")
    return ResNetSpec.from_dict(d)
