"""Model zoo: spec JSON / names -> spec dataclasses, and the float models'
generic entry points (the port of the JAX package's ``models/registry.py``).

Spec parsing covers the ResNet, EfficientNet and ViT families. The float
forward, init and training entry points (``create_model``, ``apply_model``,
``features_and_logits``) cover the ResNet family (ResNeXt and Wide ResNet
included) and EfficientNet; the float ViT's training and MobileNetV2 are not
ported yet (ROADMAP queue 1 items 13 and 15) and raise.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple, Union

import torch

from ..utils.device import DeviceLike, resolve_device
from . import efficientnet, resnet
from .efficientnet import EfficientNetSpec, efficientnet_spec
from .vit import ViTSpec, vit_spec
from .widths import ResNetSpec, resnet_spec

SpecLike = Union[str, Dict, ResNetSpec, ViTSpec, EfficientNetSpec]


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


def make_spec(model: SpecLike, num_classes: int = 6, in_chans: int = 3):
    """A spec, a spec dict or a name -> the spec (names as the JAX package
    resolves them; MobileNetV2 names and registered custom names are not
    ported)."""
    if isinstance(model, (ResNetSpec, ViTSpec, EfficientNetSpec)):
        return model
    if isinstance(model, dict):
        return spec_from_dict(model)
    if model.startswith("vit_"):
        return vit_spec(model, num_classes=num_classes)
    if model.startswith("efficientnet"):
        return efficientnet_spec(model, num_classes=num_classes, in_chans=in_chans)
    if model.startswith("mobilenet_v2"):
        raise NotImplementedError("MobileNetV2 is not ported yet (ROADMAP queue 1 item 13)")
    return resnet_spec(model, num_classes=num_classes, in_chans=in_chans)


def model_module(spec):
    """The functional module (init / apply / params_from_jax / params_to_jax)
    of a spec's float model."""
    if isinstance(spec, ResNetSpec):
        return resnet
    if isinstance(spec, EfficientNetSpec):
        return efficientnet
    raise NotImplementedError(
        f"the float {type(spec).__name__[:-4]} model is not ported for training yet "
        f"(ROADMAP queue 1 items 13 and 15); the port trains the ResNet family and "
        f"EfficientNet")


def apply_model(spec, params, state, x, *, train=False, compute_dtype=None, **kw):
    """Model-generic forward used by the train and eval steps -> (logits, new_state)."""
    dtype = compute_dtype if compute_dtype is not None else torch.float32
    return model_module(spec).apply(spec, params, state, x, train=train, compute_dtype=dtype,
                                    **kw)


def features_and_logits(spec, params, state, x, *, train=False, compute_dtype=None):
    """One forward returning (pooled fp32 feats, logits, new_state): the head
    is applied on top of the ``return_features=True`` trunk."""
    feats, new_state = apply_model(spec, params, state, x, train=train,
                                   compute_dtype=compute_dtype, return_features=True)
    head = params["fc"]
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
) -> Tuple[Union[ResNetSpec, EfficientNetSpec], Dict, Dict]:
    """Returns ``(spec, params, state)`` on ``device`` (the GPU unless
    ``device="cpu"``).

    ``pretrained=True`` initializes from a cached torch state_dict
    (``torch_import.find_cached_weights``: ``$IEVM_WEIGHTS_DIR`` or the torch
    hub cache) and keeps the fresh head; without one, or when it cannot be
    read or converted, it warns and keeps the random init, as the JAX package
    does (nothing is downloaded). A family whose converter is not ported
    raises NotImplementedError."""
    spec = make_spec(model, num_classes=num_classes)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params, state = model_module(spec).init(spec, generator, dev)
    if pretrained:
        from .torch_import import load_pretrained

        try:
            params, state = load_pretrained(spec, params, state)
        except NotImplementedError:
            raise
        except Exception as e:  # no cache, or a file that does not convert
            (logger or logging.getLogger("ievm")).warning(
                "pretrained=True requested for %s but no local weight cache "
                "has it (%s: %s) — falling back to RANDOM init (set "
                "IEVM_WEIGHTS_DIR or populate ~/.cache/torch/hub/checkpoints)",
                spec.name, type(e).__name__, e,
            )
    return spec, params, state
