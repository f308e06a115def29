"""Structured pruning (stage 3) of the ResNet family and EfficientNet."""

from .engine import StructuredPruningEngine, prune_model
from .graph import group_slices

__all__ = ["StructuredPruningEngine", "group_slices", "prune_model"]
