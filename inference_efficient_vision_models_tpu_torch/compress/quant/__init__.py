"""Stage 4: quantization of every family (the port of the JAX package's
``compress/quant``), with the accuracy tools: QAT, AdaRound, the per-tap
sensitivity sweep and the automix search.

The JAX package's exports, resolved on first access: the kernels' modules
(``ops``) import ``observers`` from here, so this package imports nothing
when it loads."""

import importlib

_EXPORTS = {
    "ObserverState": "observers",
    "minmax_qparams_affine": "observers",
    "minmax_qparams_symmetric_per_channel": "observers",
    "QuantizationEngine": "engine",
    "quant_module": "engine",
    "tap_sensitivity": "sensitivity",
    "make_switch_forward": "sensitivity",
    "auto_mixed_policy": "automix",
}
_MODULES = ("qresnet", "qmobilenet", "qeffnet", "qvit", "wo4", "wo8")

__all__ = [*_EXPORTS, *_MODULES]


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    if name in _MODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
