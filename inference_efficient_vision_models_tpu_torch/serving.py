"""Serving runtime: a pipelined predictor over the static-INT8 forward.

``Predictor`` overlaps three stages per batch:

    host preprocess (space-to-depth where the model takes it, pinned staging;
                     producer thread)
      ->  H2D copy + forward (main thread, asynchronous on the current stream)
      ->  result gather (main thread, a couple of batches behind)

The producer thread touches only host memory (it pins the staging buffer);
every CUDA operation comes from the calling thread.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .compress.quant.fusedpath import load_static_int8_fused
from .compress.quant.qresnet import load_static_int8
from .compress.quant.qvit import load_static_int8 as load_static_int8_vit
from .models.efficientnet import EfficientNetSpec
from .models.registry import spec_from_dict
from .models.vit import ViTSpec
from .ops.space_to_depth import space_to_depth_u8
from .utils.device import DeviceLike, resolve_device


def load_quantized(fold_dir: str, method: str = "static_int8", *, device: DeviceLike = None):
    """Restore a stage-4 artifact -> (spec, model, apply_fn, host_preprocess).

    Dispatches on the artifact's spec: a ResNet serves ``"static_int8"``
    through the int8 executor, whose stem takes the space-to-depth layout the
    host preprocess makes; an EfficientNet serves ``"static_int8_fused"``
    (one fused kernel call per MBConv block) from
    ``model_static_int8_fused.msgpack`` or else the shared
    ``model_static_int8.msgpack``; a ViT serves ``"static_int8"`` (fp32
    activation carrier) and ``"static_int8_bf16"`` (bf16 carrier, from
    ``model_static_int8_bf16.msgpack`` or else the shared file). EfficientNet
    and ViT take raw uint8 images, with no host preprocess."""
    with open(os.path.join(fold_dir, "spec.json")) as f:
        spec = spec_from_dict(json.load(f))
    if isinstance(spec, ViTSpec):
        if method not in ("static_int8", "static_int8_bf16"):
            raise NotImplementedError(f"method {method!r} is not ported yet for ViT "
                                      f"(have 'static_int8' and 'static_int8_bf16')")
        act = torch.bfloat16 if method == "static_int8_bf16" else torch.float32
        model = load_static_int8_vit(fold_dir, device, act_dtype=act)
        return model.spec, model, model, None
    if isinstance(spec, EfficientNetSpec):
        if method == "static_int8_fused":
            model = load_static_int8_fused(fold_dir, device)
            return model.spec, model, model, None
        if method == "static_int8":
            raise NotImplementedError(
                "the unfused EfficientNet int8 executor (qeffnet.apply_int8) is not ported yet; "
                "serve 'static_int8_fused'")
        raise NotImplementedError(f"method {method!r} is not ported yet for EfficientNet "
                                  f"(have 'static_int8_fused')")
    if method != "static_int8":
        raise NotImplementedError(f"method {method!r} is not ported yet for ResNet "
                                  f"(have 'static_int8')")
    model = load_static_int8(fold_dir, device)
    return model.spec, model, model, space_to_depth_u8


class Predictor:
    """Batched, host-prefetching inference over a (u8 images -> logits) forward."""

    def __init__(
        self,
        apply_fn: Callable[[torch.Tensor], torch.Tensor],
        *,
        host_preprocess: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        batch_size: int = 256,
        prefetch: int = 2,
        bucket_sizes: Optional[Tuple[int, ...]] = None,
        device: DeviceLike = None,
    ):
        """``bucket_sizes``: ascending shape buckets for short work: a request
        (or tail chunk) of n < batch_size images is padded only to the
        smallest bucket >= n instead of the full batch."""
        self.apply_fn = apply_fn
        self.host_preprocess = host_preprocess
        self.batch_size = batch_size
        self.prefetch = max(prefetch, 1)
        self.device = resolve_device(device)
        self.bucket_sizes = tuple(sorted(set(bucket_sizes or ())))
        if any(b < 1 or b > batch_size for b in self.bucket_sizes):
            raise ValueError(
                f"bucket_sizes {self.bucket_sizes} must lie in [1, batch_size={batch_size}]"
            )

    @classmethod
    def from_artifact(cls, fold_dir: str, method: str = "static_int8", *,
                      device: DeviceLike = None, **kw) -> "Predictor":
        _, _, fn, pre = load_quantized(fold_dir, method, device=device)
        return cls(fn, host_preprocess=pre, device=device, **kw)

    def _target_size(self, n: int) -> int:
        """Smallest shape bucket covering n, else the full batch."""
        for b in self.bucket_sizes:
            if n <= b:
                return b
        return self.batch_size

    def _batches(self, images: np.ndarray):
        for start in range(0, len(images), self.batch_size):
            chunk = images[start : start + self.batch_size]
            pad = self._target_size(len(chunk)) - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
            yield chunk, len(chunk) - pad

    def _stage_host(self, chunk: np.ndarray) -> torch.Tensor:
        """Host batch -> (pinned, for a GPU) CPU tensor; host memory only."""
        if self.host_preprocess is not None:
            chunk = self.host_preprocess(chunk)
        t = torch.from_numpy(np.ascontiguousarray(chunk))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _run(self, host: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.apply_fn(host.to(self.device, non_blocking=True))

    def warmup(self, image_shape: Tuple[int, int, int] = (224, 224, 3)) -> None:
        """Run every shape the predictor can dispatch (each bucket and the
        full batch) once, so no request pays first-call costs (kernel build,
        allocator growth)."""
        for b in (*self.bucket_sizes, self.batch_size):
            self._run(self._stage_host(np.zeros((b, *image_shape), np.uint8))).cpu()

    def predict_logits(self, images: np.ndarray) -> np.ndarray:
        """images (N, H, W, 3) uint8 -> logits (N, num_classes) fp32."""
        q: "queue.Queue" = queue.Queue(self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:  # gives up once the consumer has stopped
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for chunk, valid in self._batches(images):
                    if not put((self._stage_host(chunk), valid)):
                        return
                put(None)
            except Exception as e:  # handed to the caller, which re-raises it
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        out, pending = [], []  # pending: (device logits, valid), a few in flight
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                host, valid = item
                pending.append((self._run(host), valid))
                if len(pending) > self.prefetch:
                    r, v = pending.pop(0)
                    out.append(r[:v].cpu().numpy())
            for r, v in pending:
                out.append(r[:v].cpu().numpy())
        finally:
            stop.set()
            t.join()
        return np.concatenate(out) if out else np.empty((0,), np.float32)

    def predict(self, images: np.ndarray) -> np.ndarray:
        """-> predicted class ids (N,)."""
        return self.predict_logits(images).argmax(axis=-1)
