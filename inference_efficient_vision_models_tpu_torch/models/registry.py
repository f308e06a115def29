"""Model zoo: spec JSON / names -> spec dataclasses, and the float models'
generic entry points (the port of the JAX package's ``models/registry.py``).

Spec parsing, the float forward, init and training entry points
(``create_model``, ``apply_model``, ``features_and_logits``) cover the
ResNet family (ResNeXt and Wide ResNet included), EfficientNet,
MobileNetV2 and the ViT.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple, Union

import torch

from ..utils.device import DeviceLike, resolve_device
from . import efficientnet, mobilenet, resnet, vit
from .efficientnet import EfficientNetSpec, efficientnet_spec
from .mobilenet import MobileNetV2Spec, mobilenet_v2_spec
from .vit import ViTSpec, vit_spec
from .widths import ResNetSpec, resnet_spec

SpecLike = Union[str, Dict, ResNetSpec, ViTSpec, EfficientNetSpec, MobileNetV2Spec]


def spec_from_dict(d: Dict) -> Union[ResNetSpec, EfficientNetSpec, MobileNetV2Spec, ViTSpec]:
    """Spec JSON -> ResNetSpec, EfficientNetSpec, MobileNetV2Spec or ViTSpec,
    dispatched as the JAX package's ``spec_from_dict`` does (by ``__kind__``,
    else by the keys only one family has)."""
    kind = d.get("__kind__")
    if kind == "vit" or (kind is None and "patch" in d):
        return ViTSpec.from_dict(d)
    if kind == "efficientnet" or (kind is None and "se_widths" in d):
        return EfficientNetSpec.from_dict(d)
    if kind == "mobilenet_v2" or (kind is None and "hidden_widths" in d):
        return MobileNetV2Spec.from_dict(d)
    if kind is not None:
        raise NotImplementedError(f"model family {kind} is not ported yet")
    return ResNetSpec.from_dict(d)


def make_spec(model: SpecLike, num_classes: int = 6, in_chans: int = 3,
              image_size: int = 224):
    """A spec, a spec dict or a name -> the spec (names as the JAX package
    resolves them; registered custom names are not ported). A ViT's token
    count follows ``image_size`` (the JAX package fixes 224, the default:
    the stage CLIs pass their image size, so a ViT trains at any square
    size that its patch divides)."""
    if isinstance(model, (ResNetSpec, ViTSpec, EfficientNetSpec, MobileNetV2Spec)):
        return model
    if isinstance(model, dict):
        return spec_from_dict(model)
    if model.startswith("vit_"):
        return vit_spec(model, num_classes=num_classes, image_size=int(image_size))
    if model.startswith("efficientnet"):
        return efficientnet_spec(model, num_classes=num_classes, in_chans=in_chans)
    if model.startswith("mobilenet_v2"):
        return mobilenet_v2_spec(model, num_classes=num_classes, in_chans=in_chans)
    return resnet_spec(model, num_classes=num_classes, in_chans=in_chans)


def model_module(spec):
    """The functional module (init / apply / params_from_jax / params_to_jax)
    of a spec's float model."""
    if isinstance(spec, ResNetSpec):
        return resnet
    if isinstance(spec, EfficientNetSpec):
        return efficientnet
    if isinstance(spec, MobileNetV2Spec):
        return mobilenet
    if isinstance(spec, ViTSpec):
        return vit
    raise TypeError(f"no float model for {type(spec).__name__}")


def apply_model(spec, params, state, x, *, train=False, compute_dtype=None, **kw):
    """Model-generic forward used by the train and eval steps -> (logits, new_state)."""
    dtype = compute_dtype if compute_dtype is not None else torch.float32
    return model_module(spec).apply(spec, params, state, x, train=train, compute_dtype=dtype,
                                    **kw)


def features_and_logits(spec, params, state, x, *, train=False, compute_dtype=None):
    """One forward returning (pooled fp32 feats, logits, new_state): the head
    (a ViT's ``head``, a CNN's ``fc``) is applied on top of the
    ``return_features=True`` trunk."""
    feats, new_state = apply_model(spec, params, state, x, train=train,
                                   compute_dtype=compute_dtype, return_features=True)
    head = params["head"] if isinstance(spec, ViTSpec) else params["fc"]
    return feats, feats @ head["w"] + head["b"], new_state


def params_from_jax(spec, tree, device: DeviceLike = None):
    return model_module(spec).params_from_jax(tree, device)


def params_to_jax(spec, tree):
    return model_module(spec).params_to_jax(tree)


def create_model(
    model: SpecLike,
    num_classes: int = 6,
    *,
    generator: torch.Generator | None = None,
    pretrained: bool = False,
    logger=None,
    device: DeviceLike = None,
    image_size: int = 224,
) -> Tuple[Union[ResNetSpec, EfficientNetSpec, MobileNetV2Spec, ViTSpec], Dict, Dict]:
    """Returns ``(spec, params, state)`` on ``device`` (the GPU unless
    ``device="cpu"``); ``image_size`` sizes a ViT named by ``model``.

    ``pretrained=True`` initializes from a cached torch state_dict
    (``torch_import.find_cached_weights``: ``$IEVM_WEIGHTS_DIR`` or the torch
    hub cache) and keeps the fresh head; without one, or when it cannot be
    read or converted, it warns and keeps the random init, as the JAX package
    does (nothing is downloaded)."""
    spec = make_spec(model, num_classes=num_classes, image_size=image_size)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params, state = model_module(spec).init(spec, generator, dev)
    if pretrained:
        from .torch_import import load_pretrained

        try:
            params, state = load_pretrained(spec, params, state)
        except Exception as e:  # no cache, or a file that does not convert
            (logger or logging.getLogger("ievm")).warning(
                "pretrained=True requested for %s but no local weight cache "
                "has it (%s: %s) — falling back to RANDOM init (set "
                "IEVM_WEIGHTS_DIR or populate ~/.cache/torch/hub/checkpoints)",
                spec.name, type(e).__name__, e,
            )
    return spec, params, state
