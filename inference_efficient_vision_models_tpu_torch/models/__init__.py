"""The model zoo: the four families' specs and float models, and the
registry's entry points (the JAX package's ``models`` exports)."""

from . import efficientnet, mobilenet, resnet, vit
from .efficientnet import EfficientNetSpec, efficientnet_spec
from .mobilenet import MobileNetV2Spec, mobilenet_v2_spec
from .registry import (
    apply_model,
    create_model,
    make_spec,
    model_module,
    register_model,
    registered_models,
    spec_from_dict,
)
from .vit import ViTSpec, vit_spec
from .widths import ResNetSpec, resnet_spec

__all__ = [
    "resnet",
    "vit",
    "mobilenet",
    "efficientnet",
    "ResNetSpec",
    "ViTSpec",
    "MobileNetV2Spec",
    "EfficientNetSpec",
    "resnet_spec",
    "vit_spec",
    "mobilenet_v2_spec",
    "efficientnet_spec",
    "create_model",
    "make_spec",
    "model_module",
    "apply_model",
    "spec_from_dict",
    "register_model",
    "registered_models",
]
