"""ctypes binding for the port's host decoder (``csrc/host/dataloader.cpp``):
BMP decode + bilinear resize over a thread pool, from files or from memory,
and the batch space-to-depth of the serving host preprocess.

The library is built with ``g++`` at first use into ``_build/`` beside the
package (gitignored), under a name that hashes the source, the flags and
the host CPU (``-march=native`` code runs only on the CPU it was built
for). A failed build raises: the port has no slower stand-in on this path.
Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import List, Tuple

import numpy as np

from ..ops._lib import BUILD_DIR, CSRC

SOURCE = os.path.join(CSRC, "host", "dataloader.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ievm_decode_batch": [ctypes.POINTER(ctypes.c_char_p), _I, _I, _I, _I, _P, _P, _I],
    "ievm_decode_mem": [_P, ctypes.c_long, _I, _I, _P],
    "ievm_s2d_batch": [_P, _I, _I, _I, _P, _I],
}

_lock = threading.Lock()
_lib = None


def _host_cpu() -> str:
    """The CPU model and its feature flags (what ``-march=native`` reads)."""
    first = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags"):
                    first.setdefault(key, line.strip())
    except OSError:
        pass
    return "\n".join(first.values()) or f"{platform.machine()} {platform.processor()}"


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _host_cpu().encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libievmloader-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, SOURCE, "-lpthread"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the host decoder failed: {' '.join(cmd)}: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"building the host decoder failed ({' '.join(cmd)}):\n{r.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent process never loads half a file


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def decode_batch_native(
    paths: List[str], size: Tuple[int, int], num_threads: int = 8, s2d: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (images uint8, ok mask bool [N]). ``ok[i]`` is False where file i
    is not a BMP the decoder reads; its row is then undefined.

    ``s2d=True`` emits the space-to-depth serving layout (H/2, W/2, 12)."""
    lib = get_lib()
    h, w = size
    n = len(paths)
    out = np.empty((n, h // 2, w // 2, 12) if s2d else (n, h, w, 3), dtype=np.uint8)
    status = np.zeros(n, dtype=np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.ievm_decode_batch(c_paths, n, w, h, int(s2d), _ptr(out), _ptr(status), num_threads)
    return out, status.astype(bool)


def decode_bytes_native(data: bytes, size: Tuple[int, int]) -> np.ndarray:
    """One encoded BMP in memory -> (H, W, 3) uint8 resized to ``size``;
    raises ValueError when the bytes are not a BMP the decoder reads."""
    lib = get_lib()
    h, w = size
    out = np.empty((h, w, 3), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    if not lib.ievm_decode_mem(_ptr(buf) if len(buf) else None, len(buf), w, h, _ptr(out)):
        raise ValueError("not a BMP the native decoder reads (uncompressed 8, 24 or 32 bpp)")
    return out


def s2d_batch_native(imgs: np.ndarray, num_threads: int = 0) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, H/2, W/2, 12) by the C++ row interleave.
    ``num_threads=0``: one thread per core, at most 16."""
    n, h, w, c = imgs.shape
    if c != 3 or h % 2 or w % 2 or imgs.dtype != np.uint8:
        raise ValueError(f"s2d_batch_native takes (N, even H, even W, 3) uint8, got "
                         f"{imgs.shape} {imgs.dtype}")
    lib = get_lib()
    imgs = np.ascontiguousarray(imgs)
    out = np.empty((n, h // 2, w // 2, 12), dtype=np.uint8)
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, 16)
    lib.ievm_s2d_batch(_ptr(imgs), n, h, w, _ptr(out), num_threads)
    return out
