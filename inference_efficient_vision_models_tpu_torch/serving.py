"""Serving runtime: a pipelined predictor over a quantized forward, and the
request coalescing in front of it.

``Predictor`` overlaps three stages per batch:

    host preprocess (space-to-depth where the model takes it, pinned staging;
                     producer thread)
      ->  H2D copy + forward (calling thread, asynchronous on the current stream)
      ->  result gather (calling thread, a couple of batches behind)

The producer thread touches only host memory (it pins the staging buffer);
every CUDA operation comes from the calling thread.

``MicroBatcher`` coalesces concurrent small requests into one forward per
batch on a dispatcher thread, the only thread that runs the model: clients
hand it numpy arrays and wait on futures.

Each step opens a span (``utils.profiling.annotate``) named
``ievm.<layer>.<step>``: ``ievm.staging.*`` and ``ievm.executor.forward``
in ``Predictor``, ``ievm.batcher.*`` in ``MicroBatcher``.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .compress.quant import wo4, wo8
from .compress.quant.engine import dynamic_forward, folded_forward
from .compress.quant.fusedpath import load_static_int8_fused
from .compress.quant.qeffnet import load_static_int8 as load_static_int8_mbconv
from .compress.quant.qresnet import load_static_int8
from .compress.quant.qvit import from_dynamic_qmodel
from .compress.quant.qvit import load_static_int8 as load_static_int8_vit
from .core.artifacts import load_checkpoint_raw
from .models.efficientnet import EfficientNetSpec
from .models.mobilenet import MobileNetV2Spec
from .models.registry import spec_from_dict
from .models.vit import ViTSpec
from .ops.space_to_depth import space_to_depth_u8
from .parallel.mesh import DATA_AXIS, mesh_device
from .utils.device import DeviceLike, resolve_device
from .utils.profiling import annotate


def load_quantized(fold_dir: str, method: str = "static_int8", *, device: DeviceLike = None,
                   device_preprocess: bool = False, mesh=None):
    """Restore a stage-4 artifact -> (spec, model, apply_fn, host_preprocess).

    Dispatches on the artifact's spec. A ResNet serves ``"static_int8"``
    through the int8 executor, whose stem takes the space-to-depth layout the
    host preprocess makes (``device_preprocess=True``: no host preprocess,
    the executor relayouts raw uint8 on the device, for hosts whose cores
    are the scarce resource). An EfficientNet or a MobileNetV2 serves
    ``"static_int8"`` (the unfused executor), ``"static_int8_mixed"`` (int8
    1x1 convs, bf16 depthwise) and ``"static_int8_fused"`` (one fused kernel
    call per MBConv block), each from its own ``model_<method>.msgpack`` or
    else the shared ``model_static_int8.msgpack``, as the JAX package's
    loader falls back. The CNN families serve ``"dynamic_int8"``, ``"fp16"``,
    ``"bf16"``, ``"weight_only_int8"`` and ``"weight_only_int4"`` (any
    artifact of a float-compute method) through the folded float forward on
    raw uint8. A ViT serves
    ``"static_int8"`` (fp32 activation carrier) and ``"static_int8_bf16"``
    (bf16 carrier, from ``model_static_int8_bf16.msgpack`` or else the
    shared file), and every float-compute method as the CNNs do, a
    ``"dynamic_int8"`` artifact through the dynamic executor (every dense
    layer int8 on kernel A's dynamic route). The MBConv families and ViT take
    raw uint8 images, with no host preprocess. A ResNeXt's ``"static_int8"``
    runs its grouped convs on kernel F.

    With ``mesh`` (``parallel.make_mesh``) the model is loaded on this
    rank's device (a replica on each rank); serve it through
    ``Predictor(mesh=...)``, which splits each batch over the data axis."""
    with open(os.path.join(fold_dir, "spec.json")) as f:
        spec = spec_from_dict(json.load(f))
    if mesh is not None:
        if method == "static_int8_fused":
            raise ValueError("the fused executor is single-device")
        device = mesh_device(mesh)
    if isinstance(spec, ViTSpec) and method in ("static_int8", "static_int8_bf16"):
        act = torch.bfloat16 if method == "static_int8_bf16" else torch.float32
        model = load_static_int8_vit(fold_dir, device, act_dtype=act)
        return model.spec, model, model, None
    if isinstance(spec, (EfficientNetSpec, MobileNetV2Spec)):
        if method == "static_int8_fused":
            model = load_static_int8_fused(fold_dir, device)
            return model.spec, model, model, None
        if method in ("static_int8", "static_int8_mixed"):
            model = load_static_int8_mbconv(
                fold_dir, device, executor="mixed" if method.endswith("_mixed") else "int8")
            return model.spec, model, model, None
    elif method == "static_int8":
        model = load_static_int8(fold_dir, device)
        return model.spec, model, model, None if device_preprocess else space_to_depth_u8
    return _load_float(spec, fold_dir, method, device)


def _load_float(spec, fold_dir: str, method: str, device: DeviceLike):
    """An artifact of the float-compute methods, told apart by its leaves as
    the JAX package's loader tells them: weight-only int4 ({"q4", "s"}
    kernels, with {"q", "s"} fallback leaves) or int8 ({"q", "s"} kernels),
    both bf16 compute, dynamic int8 (a CNN's ``fc_q`` head with the
    fp32 trunk; a ViT's int8 ``head``, every dense layer int8), or a folded
    cast (fp16 / bf16 / fp32, computed in its own dtype). Each forward
    normalizes the raw uint8 images on the device and runs the family's
    ``apply_folded`` (the JAX loader folds the normalization into an s2d
    float stem instead: the same function, rounded elsewhere)."""
    if method.startswith("static_int8_"):
        raise NotImplementedError(f"{type(spec).__name__[:-4]} has no {method!r} executor in "
                                  f"either package")
    model = load_checkpoint_raw(fold_dir, method)
    vit = isinstance(spec, ViTSpec)
    # a W4A16 tree may hold int8 fallback leaves too: told apart first
    wo = wo4 if wo4.is_weight_only_int4(model) else wo8 if wo8.is_weight_only(model) else None
    if wo is not None:
        fn = folded_forward(spec, wo.dequantize(model, torch.bfloat16), torch.bfloat16, device)
    elif vit and "w_q" in model["head"]:
        fn = from_dynamic_qmodel(spec, model, device)
    elif "fc_q" in model:
        fn = dynamic_forward(spec, model, device)
    else:
        leaf = model["head" if vit else "fc"]["w"]
        dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else \
            {np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32}[leaf.dtype]
        fn = folded_forward(spec, model, dtype, device)
    return spec, model, fn, None


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
        mesh=None,
    ):
        """``bucket_sizes``: ascending shape buckets for short work: a request
        (or tail chunk) of n < batch_size images is padded only to the
        smallest bucket >= n instead of the full batch.

        ``mesh``: run data-parallel over a ``parallel.make_mesh`` mesh, every
        rank calling with the same images: each batch is split over the data
        axis (batch and bucket sizes must divide by its size), each rank runs
        its rows on its device, and the logits are gathered, so every rank
        returns the whole batch's. The model must sit on this rank's device
        (``from_artifact(..., mesh=...)``)."""
        self.apply_fn = apply_fn
        self.host_preprocess = host_preprocess
        self.batch_size = batch_size
        self.prefetch = max(prefetch, 1)
        self.mesh = mesh
        self.device = mesh_device(mesh) if mesh is not None else resolve_device(device)
        self.bucket_sizes = tuple(sorted(set(bucket_sizes or ())))
        if any(b < 1 or b > batch_size for b in self.bucket_sizes):
            raise ValueError(
                f"bucket_sizes {self.bucket_sizes} must lie in [1, batch_size={batch_size}]"
            )
        if mesh is not None:
            n_dp = mesh.size(0)
            for b in (batch_size, *self.bucket_sizes):
                if b % n_dp:
                    raise ValueError(
                        f"batch/bucket size {b} not divisible by data-axis size {n_dp}"
                    )

    @classmethod
    def from_artifact(cls, fold_dir: str, method: str = "static_int8", *,
                      device: DeviceLike = None, device_preprocess: bool = False, mesh=None,
                      **kw) -> "Predictor":
        _, _, fn, pre = load_quantized(fold_dir, method, device=device,
                                       device_preprocess=device_preprocess, mesh=mesh)
        return cls(fn, host_preprocess=pre, device=device, mesh=mesh, **kw)

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
        with annotate("ievm.staging.pin"):
            t = torch.from_numpy(np.ascontiguousarray(chunk))
            return t.pin_memory() if self.device.type == "cuda" else t

    def _run(self, host: torch.Tensor) -> torch.Tensor:
        """The forward of a staged batch, enqueued on the current stream."""
        if self.mesh is not None:
            return self._run_mesh(host)
        with torch.inference_mode():
            with annotate("ievm.staging.h2d"):
                x = host.to(self.device, non_blocking=True)
            with annotate("ievm.executor.forward"):
                return self.apply_fn(x)

    def _run_mesh(self, host: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the batch, then every rank's logits gathered."""
        import torch.distributed as dist

        from .parallel import shard_batch

        group = self.mesh.get_group(DATA_AXIS)
        with torch.inference_mode():
            mine = self.apply_fn(shard_batch(self.mesh, host))
            parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, mine.contiguous(), group=group)
            return torch.cat(parts)

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
                with annotate("ievm.staging.wait_host"):
                    item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                host, valid = item
                pending.append((self._run(host), valid))
                if len(pending) > self.prefetch:
                    r, v = pending.pop(0)
                    with annotate("ievm.staging.gather"):
                        out.append(r[:v].cpu().numpy())
            for r, v in pending:
                with annotate("ievm.staging.gather"):
                    out.append(r[:v].cpu().numpy())
        finally:
            stop.set()
            t.join()
        return np.concatenate(out) if out else np.empty((0,), np.float32)

    def predict(self, images: np.ndarray) -> np.ndarray:
        """-> predicted class ids (N,)."""
        return self.predict_logits(images).argmax(axis=-1)

    def predict_stream(self, batches: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Generator over a stream of uint8 image batches -> each batch's
        logits, each batch run as given (no bucket padding)."""
        for chunk in batches:
            yield self._run(self._stage_host(chunk)).cpu().numpy()


_CLOSE = object()  # MicroBatcher shutdown sentinel


class MicroBatcher:
    """Dynamic request batching in front of a :class:`Predictor`.

    A dispatcher thread coalesces everything waiting, up to ``max_batch``
    images or until the oldest request has waited ``max_wait_ms``, into one
    forward routed through the predictor's shape buckets, then scatters the
    logits back to per-request futures. A request that would overflow the
    batch leads the next one; a failed forward delivers its exception to
    every future of the batch.

    The batch is staged in one reused buffer of uint8 images (pinned on a
    CUDA predictor), allocated by :meth:`warmup`: the dispatcher copies
    each request into its rows as it takes it off the queue, fills the
    bucket's pad rows with the last frame, as the copy path pads (an
    executor may take a statistic over the whole batch: the dynamic INT8
    head's activation range), and hands those rows on. A batch holding a
    request of another dtype or image shape, or any batch before the first
    warmup, is joined and padded by copies instead, and staged by the
    predictor.

    The dispatcher is the only thread that touches the device: ``submit``
    takes and returns numpy arrays and never waits on the device. Use as a
    context manager or call :meth:`close` to drain and stop the dispatcher.
    """

    def __init__(self, predictor: Predictor, *, max_wait_ms: float = 2.0,
                 max_batch: Optional[int] = None):
        self.pred = predictor
        self.max_batch = int(max_batch or predictor.batch_size)
        if not 1 <= self.max_batch <= predictor.batch_size:
            raise ValueError(
                f"max_batch {self.max_batch} must lie in [1, predictor.batch_size="
                f"{predictor.batch_size}]"
            )
        self.max_wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._carry = None  # the request that would have overflowed the batch
        self._lock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self.n_images = 0  # valid images dispatched
        self.n_slots = 0  # padded batch rows dispatched
        self.queue_wait_s = 0.0  # submit to dispatch, summed over the requests dispatched
        self.queue_waited = 0
        self.n_staged_in_place = 0  # dispatches staged in the reused buffer
        self.n_staged_copy = 0  # dispatches joined and padded by copies
        self._buf: Optional[torch.Tensor] = None  # the reused staging buffer (rows, H, W, C)
        self._buf_np: Optional[np.ndarray] = None  # its numpy view, written by the dispatcher
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API ----------------------------------------------------------
    def submit(self, images: np.ndarray) -> "Future[np.ndarray]":
        """images (n, H, W, 3) uint8, n <= max_batch -> Future of logits (n, K).
        Larger workloads are batch jobs: send those to
        :meth:`Predictor.predict_logits`."""
        images = np.asarray(images)
        if images.ndim != 4:
            raise ValueError(f"expected (n, H, W, C) images, got {images.shape}")
        if len(images) > self.max_batch:
            raise ValueError(
                f"request of {len(images)} images exceeds max_batch "
                f"{self.max_batch}; use Predictor.predict_logits for batch jobs"
            )
        fut: Future = Future()
        if len(images) == 0:
            fut.set_result(np.empty((0, 0), np.float32))
            return fut
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self.n_requests += 1
            self._q.put((images, fut, len(images), time.perf_counter()))
        return fut

    def infer(self, images: np.ndarray) -> np.ndarray:
        """Blocking convenience wrapper: submit and wait for the logits."""
        return self.submit(images).result()

    def warmup(self, image_shape: Tuple[int, int, int] = (224, 224, 3)) -> None:
        """Allocate and touch the staging buffer for ``image_shape`` and run
        :meth:`Predictor.warmup`, on the dispatcher thread (kernel builds,
        allocator growth and page faults happen there, before any request),
        and wait for it; counted in no statistic."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put((image_shape, fut, 0, 0.0))
        fut.result()

    def stats(self) -> dict:
        """Coalescing counters (mean_batch = valid images per forward;
        queue_wait_ms_mean = a request's mean wait from ``submit`` to the
        start of its dispatch; staged_in_place / staged_copy = dispatches
        staged in the reused buffer / joined and padded by copies)."""
        b = max(self.n_batches, 1)
        return {
            "requests": self.n_requests,
            "batches": self.n_batches,
            "images": self.n_images,
            "mean_batch": self.n_images / b,
            "mean_dispatch_slots": self.n_slots / b,
            "queue_wait_ms_mean": 1e3 * self.queue_wait_s / max(self.queue_waited, 1),
            "staged_in_place": self.n_staged_in_place,
            "staged_copy": self.n_staged_copy,
        }

    def close(self) -> None:
        """Drain queued requests, dispatch them, and stop the dispatcher."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(_CLOSE)
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher ----------------------------------------------------------
    def _loop(self) -> None:
        with torch.inference_mode():  # thread-local: entered by the thread that runs the model
            while True:
                if self._carry is not None:
                    first, self._carry = self._carry, None
                else:
                    first = self._q.get()
                    if first is _CLOSE:
                        return
                if first[2] == 0:  # a warmup() call: (image shape, future, 0, 0.0)
                    try:
                        if self._buf is None or self._buf.shape[1:] != tuple(first[0]):
                            self._allocate(first[0])
                        first[1].set_result(self.pred.warmup(first[0]))
                    except Exception as e:  # handed to the waiting caller
                        first[1].set_exception(e)
                    continue
                # (images, future, n, submit time)
                batch: List[Tuple[np.ndarray, Future, int, float]] = [first]
                total = first[2]
                in_place = self._fits(first[0])
                if in_place:
                    self._stage_rows(first[0], 0)
                deadline = time.monotonic() + self.max_wait_s
                while total < self.max_batch:
                    timeout = deadline - time.monotonic()
                    if timeout <= 0:
                        break
                    try:
                        item = self._q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if item is _CLOSE:
                        self._q.put(_CLOSE)  # re-post: exit after this dispatch
                        break
                    if item[2] == 0 or total + item[2] > self.max_batch:
                        self._carry = item  # leads the next round
                        break
                    batch.append(item)
                    in_place = in_place and self._fits(item[0])
                    if in_place:
                        self._stage_rows(item[0], total)
                    total += item[2]
                self._dispatch(batch, total, in_place)

    def _allocate(self, image_shape: Tuple[int, ...]) -> None:
        """The staging buffer for images of ``image_shape``: rows for the
        largest bucket a batch can reach, pinned on a CUDA predictor, and
        zeroed, so that no request pays for its page faults."""
        self._drain()
        rows = self.pred._target_size(self.max_batch)
        self._buf = torch.zeros((rows, *image_shape), dtype=torch.uint8,
                                pin_memory=self.pred.device.type == "cuda")
        self._buf_np = self._buf.numpy()

    def _drain(self) -> None:
        """Wait for the predictor's device, so that no H2D copy out of the
        buffer is still queued. A dispatch that returns has drained it
        already, by its ``.cpu()`` gather."""
        if self.pred.device.type == "cuda":
            torch.cuda.synchronize(self.pred.device)

    def _fits(self, images: np.ndarray) -> bool:
        """Whether ``images`` can be staged in the buffer: uint8 of its image shape."""
        return (self._buf is not None and images.dtype == np.uint8
                and images.shape[1:] == self._buf.shape[1:])

    def _stage_rows(self, images: np.ndarray, row: int) -> None:
        with annotate("ievm.batcher.concat"):
            np.copyto(self._buf_np[row : row + len(images)], images)

    def _dispatch(self, batch, total: int, in_place: bool) -> None:
        """Run a coalesced batch: staged in the buffer (``in_place``; its
        valid rows are written, its pad rows filled here), else joined,
        padded and staged by copies."""
        with annotate("ievm.batcher.dispatch"):
            now = time.perf_counter()
            self.queue_wait_s += sum(now - t for *_, t in batch)
            self.queue_waited += len(batch)
            live = [fut.set_running_or_notify_cancel() for _, fut, _, _ in batch]
            try:
                if in_place:
                    with annotate("ievm.batcher.pad"):
                        tgt = self.pred._target_size(total)
                        self._buf_np[total:tgt] = self._buf_np[total - 1]
                    host = (self._buf[:tgt] if self.pred.host_preprocess is None
                            else self.pred._stage_host(self._buf_np[:tgt]))
                else:
                    with annotate("ievm.batcher.concat"):
                        imgs = np.concatenate([im for im, _, _, _ in batch], axis=0)
                    with annotate("ievm.batcher.pad"):
                        tgt = self.pred._target_size(total)
                        if tgt > total:
                            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], tgt - total, 0)])
                    host = self.pred._stage_host(imgs)
                logits = self.pred._run(host)
                with annotate("ievm.staging.gather"):
                    logits = logits[:total].cpu().numpy()
            except Exception as e:  # scatter the failure to every caller
                if in_place:
                    try:  # its H2D out of the buffer may still be queued
                        self._drain()
                    except Exception:  # a sticky device error reaches the next batch too
                        pass
                for (_, fut, _, _), ok in zip(batch, live):
                    if ok:
                        fut.set_exception(e)
                return
            off = 0
            for (_, fut, n, _), ok in zip(batch, live):
                if ok:
                    fut.set_result(logits[off : off + n])
                off += n
            self.n_batches += 1
            self.n_images += total
            self.n_slots += tgt
            self.n_staged_in_place += in_place
            self.n_staged_copy += not in_place
