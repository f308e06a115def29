"""Ahead-of-time deployment export: a stage-4 artifact -> one ``torch.export``
program in the JAX package's ``IEVM`` container.

The deployed unit is a self-contained program: ``torch.export`` traces the
``load_quantized`` forward (weights embedded as constants) into an
``ExportedProgram``, whose ``torch.export.save`` bytes any later PyTorch can
load and run without the artifact format or the model code. The hand-written
kernels appear in it as the ``ievm::*`` ``torch.library`` ops (``ops/_lib``),
which dispatch on the device: the CUDA kernels on a GPU, their plain
versions on the CPU. So one container serves both platforms, as the JAX
package's ``("tpu", "cpu")`` export does; ``load_exported`` moves its
constants to the device asked for. Loading needs this package imported only
for the ops' registration.

Container (the JAX package's ``export.py``): ``b"IEVM"``, a little-endian
``<I`` header length, a JSON header (method, input layout/shape/dtype,
platforms, spec kind, and ``payload``: the program's format, which the JAX
package's header lacks), then the program bytes. Either package's
``read_header`` reads the other's container; ``load_exported`` refuses a
JAX (StableHLO) one. The one host-side transform an export may need is the
static-INT8 ResNet stem's space-to-depth layout (``input_layout: s2d``,
``s2d_layout``).
"""

from __future__ import annotations

import io
import json
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from . import ops  # noqa: F401  (registers the ievm ops the programs call)
from .utils.device import DeviceLike, resolve_device

_MAGIC = b"IEVM"
_VERSION = 1
PAYLOAD = "torch.export"


def _input_spec(spec, method: str, batch_size: int, image_size, device_preprocess: bool
                ) -> Tuple:
    """(shape, dtype, layout) the exported program consumes."""
    from .models.widths import ResNetSpec

    h, w = int(image_size[0]), int(image_size[1])
    if method.startswith("static_int8") and isinstance(spec, ResNetSpec) and not device_preprocess:
        # the s2d stem consumes (N, H/2, W/2, 12) uint8 (stemfold)
        return (batch_size, h // 2, w // 2, 12), "uint8", "s2d"
    return (batch_size, h, w, 3), "uint8", "nhwc"


class _Forward(torch.nn.Module):
    """The served forward as a module: uint8 images -> fp32 logits."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x).float()


def export_quantized(
    fold_dir: str,
    method: str = "static_int8",
    *,
    batch_size: int = 256,
    image_size=(224, 224),
    platforms: Optional[Tuple[str, ...]] = ("cuda", "cpu"),
    device_preprocess: bool = False,
    device: DeviceLike = None,
) -> bytes:
    """Load a stage-4 artifact on ``device`` (the GPU unless ``"cpu"``),
    trace its forward at a fixed batch and return the container bytes.

    The program maps uint8 images (layout per the header) to fp32 logits.
    ``device_preprocess=True`` traces the space-to-depth relayout into the
    program, so the static-INT8 ResNet export consumes plain NHWC uint8."""
    from .serving import load_quantized

    dev = resolve_device(device)
    plats = list(platforms) if platforms else [dev.type]
    if not set(plats) <= {"cuda", "cpu"}:
        raise ValueError(f"platforms must be among ('cuda', 'cpu'), got {plats}")
    spec, _model, apply_fn, _pre = load_quantized(fold_dir, method, device=dev,
                                                  device_preprocess=device_preprocess)
    shape, dtype, layout = _input_spec(spec, method, batch_size, image_size, device_preprocess)
    example = torch.zeros(shape, dtype=torch.uint8, device=dev)
    with torch.no_grad():
        program = torch.export.export(_Forward(apply_fn), (example,), strict=False)
    program.example_inputs = None  # a batch of zeros: the header gives its shape
    buf = io.BytesIO()
    torch.export.save(program, buf)
    header = {
        "magic": "ievm-export",
        "version": _VERSION,
        "method": method,
        "input_shape": list(shape),
        "input_dtype": dtype,
        "input_layout": layout,
        "platforms": plats,
        "spec_kind": type(spec).__name__,
        "payload": PAYLOAD,
    }
    hdr = json.dumps(header).encode()
    return _MAGIC + struct.pack("<I", len(hdr)) + hdr + buf.getvalue()


def save_exported(fold_dir: str, method: str, out_path: str, **kw) -> dict:
    """Export + write ``out_path``; returns the header dict."""
    blob = export_quantized(fold_dir, method, **kw)
    with open(out_path, "wb") as f:
        f.write(blob)
    return read_header(out_path)


def read_header(path: str) -> dict:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an ievm export (magic {magic!r})")
        (n,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(n).decode())


def _split(path_or_bytes) -> Tuple[dict, bytes]:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            blob = f.read()
    if blob[:4] != _MAGIC:
        raise ValueError("not an ievm export container")
    (n,) = struct.unpack("<I", blob[4:8])
    return json.loads(blob[8 : 8 + n].decode()), blob[8 + n :]


def load_program(path_or_bytes, *, device: DeviceLike = None):
    """-> (module, header): the container's program as a callable module on
    ``device`` (the GPU unless ``"cpu"``), mapping a uint8 device tensor of
    the header's shape to fp32 logits on that device."""
    from torch.export.passes import move_to_device_pass

    header, payload = _split(path_or_bytes)
    if header.get("payload") != PAYLOAD:
        raise ValueError(f"the container holds a {header.get('payload', 'JAX (StableHLO)')} "
                         f"program, not a {PAYLOAD} one: load it with the JAX package")
    dev = resolve_device(device)
    if dev.type not in header["platforms"]:
        raise ValueError(f"the program was exported for {header['platforms']}, not {dev.type}")
    program = move_to_device_pass(torch.export.load(io.BytesIO(payload)), dev)
    return program.module(), header


def load_exported(path_or_bytes, *, device: DeviceLike = None):
    """-> (call, header). ``call`` maps a uint8 numpy batch of the header's
    shape to fp32 numpy logits, run on ``device`` (the GPU unless ``"cpu"``)."""
    module, header = load_program(path_or_bytes, device=device)
    dev = resolve_device(device)
    shape = tuple(header["input_shape"])

    def call(x_u8: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x_u8)
        if x.shape != shape or x.dtype != np.uint8:
            raise ValueError(f"expected a uint8 batch of shape {shape}, got {x.dtype} {x.shape}")
        with torch.no_grad():
            return module(torch.from_numpy(x).to(dev)).cpu().numpy()

    return call, header


def s2d_layout(imgs_u8: np.ndarray) -> np.ndarray:
    """The one host-side transform an s2d export needs at the serving site."""
    from .ops.space_to_depth import space_to_depth_u8

    return space_to_depth_u8(np.asarray(imgs_u8))
