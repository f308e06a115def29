"""The run's guard against the JAX package: no module whose top-level name
(the part before the first dot) is one of these may be loaded in the
process that prints the result. Names are compared whole: the port's name
begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "inference_efficient_vision_models_tpu")


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
