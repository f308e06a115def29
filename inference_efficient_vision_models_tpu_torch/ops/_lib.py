"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into ``_build/``
beside this package (gitignored). The file name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded. All sources are compiled in parallel, one ``nvcc`` each.
Libraries are bound with ``ctypes``; every pointer and the stream travel as
``c_void_p``. Nothing here runs at import time: the CPU-only test machine
imports this module and never builds.

``launches`` counts, per kernel, the launches the wrappers made; a wrapper
adds one right after its kernel launched and at no other place.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# Tile sizes the packed weight layout must pad to (csrc/int8_gemm.cuh BN, BK).
TILE_N = 64
TILE_K = 64

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# kernel name -> (source stem, C symbol, argtypes)
KERNELS = {
    "int8_matmul_requant": (
        "int8_matmul",
        "ievm_int8_matmul_requant",
        [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    ),
    "conv3x3_s1_int8": (
        "conv3x3",
        "ievm_conv3x3_s1_int8",
        [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    ),
}

launches: "collections.Counter[str]" = collections.Counter()

_lock = threading.Lock()
_fns: Dict[str, ctypes._CFuncPtr] = {}
build_logs: Dict[str, str] = {}


def reset_launch_counts() -> None:
    launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


def _lib_path(stem: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name == f"{stem}.cu" or name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every kernel library that is missing, all ``nvcc`` runs at
    once; returns kernel name -> library path. Raises if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {k: _lib_path(stem) for k, (stem, _, _) in KERNELS.items()}
    procs = {}
    nvcc = None
    for k, (stem, _, _) in KERNELS.items():
        if os.path.exists(paths[k]):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{paths[k]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{stem}.cu")]
        procs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp)
    failed = []
    for k, (p, tmp) in procs.items():
        out, _ = p.communicate()
        build_logs[k] = out
        if p.returncode != 0:
            failed.append(f"{k}: nvcc exited {p.returncode}\n{out}")
        else:
            # atomic: a process building at the same time never loads half a file
            os.replace(tmp, paths[k])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def kernel_fn(name: str):
    """The bound C entry point of kernel ``name``, built and loaded on first use."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _fns:
            paths = build_all()
            for k, (_, sym, argtypes) in KERNELS.items():
                f = getattr(ctypes.CDLL(paths[k]), sym)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _fns[k] = f
    return _fns[name]


def check(name: str, rc: int) -> None:
    """Raise on a refused launch (the C entry returns cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
    launches[name] += 1
