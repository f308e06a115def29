"""HTTP inference server, the port of the JAX package's ``server.py``: the
deployment front end over the serving runtime.

Stack:  ThreadingHTTPServer  ->  MicroBatcher (request coalescing)  ->
        Predictor (shape buckets, host preprocess)  ->  the quantized
        forward on the GPU.

One thread per connection parses its request and blocks on its future
while the MicroBatcher's dispatcher, the only thread that runs the model,
coalesces everything concurrently waiting into one forward.

Endpoints
---------
``GET  /healthz``       ``{"status": "ok"}`` once the model is warmed up.
``GET  /v1/metadata``   model method / class names / batching config.
``GET  /v1/stats``      live MicroBatcher coalescing counters, with
                        ``queue_wait_ms_mean`` (submit to dispatch) and
                        ``staged_in_place`` / ``staged_copy`` (dispatches
                        staged in the reused buffer / by copies).
``POST /v1/predict``    images in, logits + class predictions out.

Request payloads (by ``Content-Type``):
- ``application/x-npy``: an ``np.save``-serialized uint8 array, shape
  ``(n, H, W, 3)`` or ``(H, W, 3)``.
- ``application/json``: ``{"images_b64": "<base64 of the same npy bytes>"}``.
- ``image/bmp``: one BMP, decoded by the native decoder and bilinear-resized
  to the model's input size on the host.
- ``image/png`` / ``image/jpeg``: one image, decoded by PIL where it is
  installed; without PIL the answer is 415, naming the missing decoder.

Responses: JSON ``{"classes": [...], "class_names": [...], "logits": [[...]]}``,
or the raw logits as npy when the client sends ``Accept: application/x-npy``.

Usage (``IEVM_PLATFORM=cpu`` serves from the CPU)::

    python -m inference_efficient_vision_models_tpu_torch.server \
        --fold output/quantization/r2/fold_0 --method static_int8 --port 8000

or in-process::

    srv = InferenceServer.from_artifact(fold_dir, "static_int8", port=0)
    srv.start()            # returns once warmed up; srv.port is the bound port
    ...
    srv.close()
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from .core.config import CLS_NAME_ID_MAP
from .data.native_loader import decode_bytes_native
from .serving import MicroBatcher, Predictor
from .utils.device import DeviceLike

_MAX_BODY = 512 * 1024 * 1024  # reject absurd uploads before reading them
_SUPPORTED = ["application/x-npy", "application/json", "image/bmp", "image/png", "image/jpeg"]


class _NoDecoder(Exception):
    """The payload's image format needs a decoder this host lacks (-> 415)."""


def _decode_image_bytes(data: bytes, ctype: str, size: Tuple[int, int]) -> np.ndarray:
    """Encoded image bytes -> (1, H, W, 3) uint8, resized to the model input."""
    if ctype == "image/bmp":
        return decode_bytes_native(data, size)[None]
    try:
        from PIL import Image
    except ImportError as e:
        raise _NoDecoder(f"no decoder for {ctype}: PIL is not installed on this server "
                         f"(image/bmp is decoded natively)") from e
    with Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGB").resize((size[1], size[0]), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)[None]


def _parse_npy(data: bytes) -> np.ndarray:
    arr = np.load(io.BytesIO(data), allow_pickle=False)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"expected (n, H, W, 3) images, got {arr.shape}")
    if arr.dtype != np.uint8:
        raise ValueError(f"expected uint8 images, got {arr.dtype}")
    return arr


class _Handler(BaseHTTPRequestHandler):
    # set by InferenceServer: .server.ievm is the owning InferenceServer
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access logs through our logger
        self.server.ievm._log(fmt % args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        srv = self.server.ievm
        if self.path == "/healthz":
            if srv.ready.is_set():
                self._send_json(200, {"status": "ok"})
            else:
                self._send_json(503, {"status": "warming_up"})
        elif self.path == "/v1/stats":
            self._send_json(200, srv.batcher.stats())
        elif self.path == "/v1/metadata":
            self._send_json(200, srv.metadata())
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        srv = self.server.ievm
        if self.path != "/v1/predict":
            self._send_json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if not 0 < length <= _MAX_BODY:
                self._send_json(413, {"error": f"bad Content-Length {length}"})
                return
            body = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            if ctype == "application/x-npy":
                images = _parse_npy(body)
            elif ctype == "application/json":
                req = json.loads(body)
                images = _parse_npy(base64.b64decode(req["images_b64"]))
            elif ctype in ("image/bmp", "image/png", "image/jpeg"):
                images = _decode_image_bytes(body, ctype, srv.image_size)
            else:
                self._send_json(415, {"error": f"unsupported Content-Type {ctype!r}",
                                      "supported": _SUPPORTED})
                return
        except _NoDecoder as e:
            self._send_json(415, {"error": str(e), "supported": _SUPPORTED})
            return
        except Exception as e:  # malformed payload: a client error
            self._send_json(400, {"error": str(e)})
            return
        try:
            logits = srv.infer(images)
        except Exception as e:
            self._send_json(500, {"error": str(e)})
            return
        if "application/x-npy" in (self.headers.get("Accept") or ""):
            buf = io.BytesIO()
            np.save(buf, logits)
            self._send(200, buf.getvalue(), "application/x-npy")
            return
        classes = logits.argmax(-1)
        self._send_json(
            200,
            {
                "classes": classes.tolist(),
                "class_names": [srv.class_names[c] for c in classes],
                "logits": [[round(float(v), 5) for v in row] for row in logits],
            },
        )


class InferenceServer:
    """Owns the HTTP listener + MicroBatcher + Predictor for one model."""

    def __init__(
        self,
        predictor: Predictor,
        *,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_wait_ms: float = 2.0,
        image_size: Tuple[int, int] = (224, 224),
        metadata: Optional[dict] = None,
        logger=None,
    ):
        self.pred = predictor
        self.batcher = MicroBatcher(predictor, max_wait_ms=max_wait_ms)
        self.image_size = image_size
        self.class_names = [n for n, _ in sorted(CLS_NAME_ID_MAP.items(), key=lambda kv: kv[1])]
        self._meta = dict(metadata or {})
        self._logger = logger
        self.ready = threading.Event()
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.ievm = self
        self.port = self.httpd.server_address[1]  # resolved when port=0
        self._serve_thread: Optional[threading.Thread] = None

    @classmethod
    def from_artifact(
        cls,
        fold_dir: str,
        method: str = "static_int8",
        *,
        batch_size: int = 64,
        bucket_sizes: Tuple[int, ...] = (1, 8),
        device: DeviceLike = None,
        **kw,
    ):
        pred = Predictor.from_artifact(fold_dir, method, device=device, batch_size=batch_size,
                                       bucket_sizes=bucket_sizes)
        return cls(pred, metadata={"artifact": fold_dir, "method": method}, **kw)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "InferenceServer":
        """Serve on a daemon thread; run every bucket and the full batch once
        on the dispatcher thread first (kernel builds included): healthz
        says 503 until then, so load balancers wait."""
        self._serve_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._serve_thread.start()
        self.batcher.warmup((*self.image_size, 3))
        self.ready.set()
        self._log(
            f"serving on :{self.port} "
            f"(buckets {self.pred.bucket_sizes} + batch {self.pred.batch_size})"
        )
        return self

    def serve_forever(self) -> None:
        """Blocking variant for ``python -m …server``; Ctrl-C to stop."""
        self.start()
        try:
            self._serve_thread.join()
        except KeyboardInterrupt:
            pass
        finally:
            self.close()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- request path ---------------------------------------------------------
    def infer(self, images: np.ndarray) -> np.ndarray:
        """(n, H, W, 3) u8 -> (n, K) fp32 logits, via the coalescing batcher.
        Oversized requests are chunked so clients never see max_batch."""
        mb = self.batcher.max_batch
        if len(images) <= mb:
            return self.batcher.infer(images)
        futs = [self.batcher.submit(images[i : i + mb]) for i in range(0, len(images), mb)]
        return np.concatenate([f.result() for f in futs])

    def metadata(self) -> dict:
        return {
            **self._meta,
            "image_size": list(self.image_size),
            "class_names": self.class_names,
            "batch_size": self.pred.batch_size,
            "bucket_sizes": list(self.pred.bucket_sizes),
            "max_batch": self.batcher.max_batch,
        }

    def _log(self, msg: str) -> None:
        if self._logger is not None:
            self._logger.info(msg)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fold", required=True, help="stage-4 artifact fold dir")
    p.add_argument("--method", default="static_int8")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--buckets", default="1,8", help="comma-separated shape buckets")
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    args = p.parse_args(argv)

    import logging

    from .cli.common import stage_device

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    srv = InferenceServer.from_artifact(
        args.fold,
        args.method,
        batch_size=args.batch_size,
        bucket_sizes=tuple(int(b) for b in args.buckets.split(",") if b),
        device=stage_device(),
        host=args.host,
        port=args.port,
        max_wait_ms=args.max_wait_ms,
        logger=logging.getLogger("ievm.server"),
    )
    srv.serve_forever()


if __name__ == "__main__":
    main()
