"""QuantizationEngine: the stage-4 API, the port of the JAX package's
``compress/quant/engine.py`` for the ResNet family, EfficientNet,
MobileNetV2 and the ViT.

Methods (reference parity):
  static_quantize    per-channel int8 weights + calibrated quint8
                     activations -> the int8 forward (ResNet: kernels A and
                     B; EfficientNet and MobileNetV2: the unfused executor
                     on kernels A and E, or ``executor="mixed"``: kernel A
                     and a bf16 depthwise; ViT: every dense layer on kernel
                     A, ``executor="bf16"``: the bf16 activation carrier)
  dynamic_quantize   int8 dense layers with a per-batch activation scale on
                     kernel A's dynamic route: a CNN's fc, the convs folded
                     fp32 (torch ``quantize_dynamic({nn.Linear})``); every
                     dense layer of a ViT
  weight_only_quantize  W8A16: int8 weight storage, bf16 compute
  cast_half          fp16 (parity) / bf16 cast of the folded model
  evaluate_accuracy / measure_latency / size_mb   the shared harness

Every conversion returns ``(model, apply_fn)``: ``model`` the tree the
artifact stores (JAX layout: numpy, bfloat16 leaves as CPU tensors) and
``apply_fn`` a forward on raw uint8 NHWC images on the engine's device.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from ...data.pipeline import Batches, normalize_images
from ...metrics.profile import latency_ms, model_size_bytes, throughput_ips
from ...models.efficientnet import EfficientNetSpec
from ...models.mobilenet import MobileNetV2Spec
from ...models.registry import params_to_jax
from ...models.vit import ViTSpec
from ...models.widths import ResNetSpec
from ...ops.int8_matmul import dynamic_qparams, int8_matmul_requant_dynamic, pack_weight
from ...ops.space_to_depth import space_to_depth_u8
from ...utils.device import resolve_device
from . import qeffnet, qmobilenet, qresnet, qvit, wo8
from .observers import quantize_weight_per_channel


def quant_module(spec):
    """The quantization family module of a spec (fold / apply_folded /
    calibrate / convert_static_int8 / apply_int8 / serializable)."""
    if isinstance(spec, ResNetSpec):
        return qresnet
    if isinstance(spec, EfficientNetSpec):
        return qeffnet
    if isinstance(spec, MobileNetV2Spec):
        return qmobilenet
    if isinstance(spec, ViTSpec):
        return qvit
    raise TypeError(f"no quantization family module for {type(spec).__name__}")


def place_folded(spec, folded, device=None, dtype=None):
    """A folded JAX-layout tree on ``device`` in the layout the family's
    ``apply_folded`` takes (OIHW convs for the CNNs, the ViT's as it is)."""
    mod = qvit if isinstance(spec, ViTSpec) else qresnet
    return mod.place_folded(folded, device, dtype)


def _dynamic_fc(feats: torch.Tensor, fcq: Dict) -> torch.Tensor:
    """Dynamic int8 dense on kernel A's dynamic route (``fcq["w"]`` packed):
    a per-batch activation scale and zero point found on the device, the
    int8 product and the fp32 epilogue, the JAX ``_dynamic_fc`` bit for bit."""
    return int8_matmul_requant_dynamic(feats.contiguous(), fcq["w"], fcq["w_scale"],
                                       fcq["bias"], fcq["w_sum"], dynamic_qparams(feats))


def s2d_preprocess(imgs: np.ndarray) -> np.ndarray:
    """Host-side space-to-depth (the static-int8 stem's input layout)."""
    return space_to_depth_u8(np.asarray(imgs))


def evaluate_accuracy_fn(cfg, apply_fn, test_d, host_preprocess=None, device=None) -> float:
    """Accuracy of a (uint8 images -> logits) forward over the test split,
    the argmax taken on the host; ``host_preprocess`` maps each host batch
    before it goes to ``device``."""
    dev = resolve_device(device)
    correct = n = 0.0
    for i, (imgs, labels, mask) in enumerate(Batches(test_d[0], test_d[1], cfg.batch_size, "cpu")):
        if cfg.DEBUG_MODE and i == 2:
            break
        x = imgs.numpy() if host_preprocess is None else host_preprocess(imgs.numpy())
        with torch.no_grad():
            pred = apply_fn(torch.from_numpy(np.ascontiguousarray(x)).to(dev)).float()
        pred = pred.cpu().numpy().argmax(axis=-1)
        correct += float(((pred == labels.numpy()) * mask.numpy()).sum())
        n += float(mask.sum())
    return float(correct / max(n, 1.0))


class QuantizationEngine:
    """Quantize a (possibly pruned) ResNet, EfficientNet or MobileNetV2 given
    its spec and the port's params/state, on ``device`` (the GPU unless
    ``device="cpu"``). Folding, conversion and weight quantization run on the host in numpy; the
    calibration forwards and every returned ``apply_fn`` run on ``device``."""

    def __init__(self, cfg, spec, params, state, logger, device=None):
        self.cfg = cfg
        self.spec = spec
        self.logger = logger
        self.device = resolve_device(device)
        self.q = quant_module(spec)
        self.folded = self.q.fold(spec, params_to_jax(spec, params), params_to_jax(spec, state))
        self.folded_dev = place_folded(spec, self.folded, self.device)
        self.timings: Dict[str, float] = {}  # static_quantize's wall seconds

    # -- conversions ---------------------------------------------------------

    def float_forward(self):
        """The fp32 baseline: ``apply_folded`` on normalized images."""
        spec, f, q = self.spec, self.folded_dev, self.q
        return lambda x_u8: q.apply_folded(spec, f, normalize_images(x_u8))

    def static_quantize(self, calib_data: Tuple[np.ndarray, np.ndarray], *,
                        executor: str = "int8"):
        """Calibrate on at most cfg.calibration_images (the estimator from
        cfg.observer), then convert to int8; the forward runs the int8
        executor (``executor="mixed"``: an MBConv network's mixed executor
        over the same conversion; ``executor="bf16"``: a ViT's bf16 activation
        carrier). Wall seconds of the two steps go to
        ``self.timings`` (calibrate_s, convert_s): the observer ranges come
        back to the host as floats, so the first ends with the device's work."""
        mbconv = isinstance(self.spec, (EfficientNetSpec, MobileNetV2Spec))
        vit = isinstance(self.spec, ViTSpec)
        if executor not in ("int8", "mixed" if mbconv else "bf16" if vit else "int8"):
            raise NotImplementedError(
                f"{type(self.spec).__name__[:-4]} has no {executor!r} executor (the mixed one "
                f"serves MBConv networks, the bf16 carrier the ViT)")
        loader = Batches(calib_data[0], calib_data[1], self.cfg.batch_size, self.device)
        t0 = time.perf_counter()
        observers = self.q.calibrate(self.spec, self.folded_dev, loader,
                                     max_images=self.cfg.calibration_images,
                                     observer=self.cfg.observer, percentile=self.cfg.percentile)
        t1 = time.perf_counter()
        qmodel = self.q.convert_static_int8(self.spec, self.folded, observers,
                                            image_size=tuple(self.cfg.image_size))
        timings = {"calibrate_s": t1 - t0, "convert_s": time.perf_counter() - t1}
        if executor == "int8":
            self.timings = timings
        self.logger.info("static_int8 (%s): calibrate %.3f s, convert %.3f s", executor,
                         timings["calibrate_s"], timings["convert_s"])
        if mbconv:
            model = self.q.from_jax_qmodel(self.spec.to_dict(), qmodel, self.device,
                                           executor=executor)
        elif vit:
            model = qvit.from_jax_qmodel(self.spec.to_dict(), qmodel, self.device,
                                         torch.bfloat16 if executor == "bf16" else torch.float32)
        else:
            model = qresnet.from_jax_qmodel(self.spec.to_dict(), qmodel, self.device)
        return qmodel, model

    def dynamic_quantize(self):
        """int8 fc (per-channel weights, per-batch activation qparams), the
        convs folded fp32; a ViT: every dense layer int8 (qkv, proj, mlp1,
        mlp2, head), the patch embed a float conv."""
        if isinstance(self.spec, ViTSpec):
            model = qvit.convert_dynamic_int8(self.spec, self.folded)
            return model, qvit.from_dynamic_qmodel(self.spec, model, self.device)
        w_q, w_scale = quantize_weight_per_channel(np.asarray(self.folded["fc"]["w"]),
                                                   channel_axis=1)
        model = {k: v for k, v in self.folded.items() if k != "fc"}
        model["fc_q"] = {"w_q": w_q, "w_scale": w_scale,
                         "w_sum": w_q.sum(axis=0, dtype=np.int32),
                         "bias": np.asarray(self.folded["fc"]["b"], np.float32)}
        return model, dynamic_forward(self.spec, model, self.device)

    def weight_only_quantize(self, bits: int = 8):
        """W8A16: int8 weight storage dequantized to bf16, the folded bf16
        forward. ``bits=4`` (W4A16, ``wo4.py``) is not ported yet."""
        if bits != 8:
            raise NotImplementedError("weight_only_int4 (compress/quant/wo4.py) is not ported "
                                      "yet (ROADMAP queue 1 item 11)")
        model = wo8.convert_weight_only(self.folded)
        return model, folded_forward(self.spec, wo8.dequantize(model, torch.bfloat16),
                                     torch.bfloat16, self.device)

    def cast_half(self, dtype=torch.float16):
        """The folded model with every fp32 leaf cast to fp16 or bf16, its
        input normalized in that dtype (convs run in it too)."""
        model = _cast_tree(self.folded, dtype)
        return model, folded_forward(self.spec, model, dtype, self.device)

    # -- shared harness --------------------------------------------------------

    def static_preprocess(self, method: str):
        """Host-side layout transform of a method: space-to-depth for the
        ResNet static-int8 stem, else None (the MBConv families' 3x3 stem
        takes raw uint8)."""
        return s2d_preprocess if method == "static_int8" and isinstance(
            self.spec, ResNetSpec) else None

    def evaluate_accuracy(self, apply_fn, test_d, host_preprocess=None) -> float:
        return evaluate_accuracy_fn(self.cfg, apply_fn, test_d, host_preprocess, self.device)

    def measure_latency(self, apply_fn, batch_size: int = 1,
                        host_preprocess=None) -> Dict[str, float]:
        h, w = self.cfg.image_size
        x = np.zeros((batch_size, h, w, 3), np.uint8)
        if host_preprocess is not None:
            x = host_preprocess(x)
        x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        def fn(t):
            with torch.no_grad():
                return apply_fn(t)

        lat = latency_ms(fn, x)
        lat["throughput_ips"] = throughput_ips(fn, x, batch_size=batch_size)
        return lat

    def size_mb(self, model) -> float:
        # the derived stem offset maps are regenerated at load: not payload
        return model_size_bytes(self.q.serializable(model)) / 1e6


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if t.dtype == torch.float32 else t


def folded_forward(spec, folded, dtype, device=None):
    """uint8 images -> fp32 logits through the folded model (JAX layout)
    cast to ``dtype``, normalized in that dtype."""
    f = place_folded(spec, folded, device)
    apply_folded = quant_module(spec).apply_folded

    def fwd(x_u8):
        return apply_folded(spec, f, normalize_images(x_u8, dtype)).float()

    return fwd


def dynamic_forward(spec, model, device=None):
    """uint8 images -> logits of a CNN's dynamic-int8 model: the folded fp32
    trunk (TF32 off), then the dynamic int8 fc on kernel A (packed once)."""
    m = place_folded(spec, model, device)
    fcq = m["fc_q"]
    fcq = {**fcq, "w": pack_weight(fcq["w_q"])}
    apply_folded = quant_module(spec).apply_folded

    def fwd(x_u8):
        feats = apply_folded(spec, m, normalize_images(x_u8), return_features=True)
        return _dynamic_fc(feats, fcq)

    return fwd
