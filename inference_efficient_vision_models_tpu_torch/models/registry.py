"""Spec JSON -> spec dataclass. The port has the ResNet family so far."""

from __future__ import annotations

from typing import Dict

from .widths import ResNetSpec


def spec_from_dict(d: Dict) -> ResNetSpec:
    """Spec JSON -> ResNetSpec; other families' dicts carry ``__kind__`` or
    family-specific keys and are not ported yet."""
    kind = d.get("__kind__")
    if kind is not None or any(k in d for k in ("patch", "se_widths", "hidden_widths")):
        raise NotImplementedError(f"model family {kind or 'non-resnet'} is not ported yet")
    return ResNetSpec.from_dict(d)
