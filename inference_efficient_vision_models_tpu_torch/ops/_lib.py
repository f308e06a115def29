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

Every kernel entry point is also a ``torch.library`` op in the ``ievm``
namespace (``custom_op``), whose CPU implementation is the plain PyTorch
version and whose CUDA implementation is the launch, so ``torch.export``
can capture a forward that runs them: a ``ctypes`` call cannot be traced.
``call`` is the one place that chooses between the op and a direct call of
the same implementations: the op while a forward is traced, the direct call
otherwise (an eager launch does not pay the op's dispatch).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# Tile sizes the packed weight layout pads to (ops/int8_matmul.py:pack_weight).
# The kernels need only Kp % 16 == 0 (kernel A's and B's TMA loads, kernel C's
# 16-byte copies) and, in kernel C's launches, Kp >= K rounded up to 32.
TILE_N = 64
TILE_K = 64

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double

# kernel name -> (source stem, {C symbol: argtypes}); a kernel whose work is
# split into several launches has one entry point per launch
KERNELS = {
    "int8_matmul_requant": ("int8_matmul", {
        "ievm_int8_matmul_requant":
            [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _D] + [_I] * 6
            + [_P, _P],
        "ievm_int8_weight_tensor_map": [_P, _I, _I, _P],
    }),
    "conv3x3_s1_int8": ("conv3x3", {
        "ievm_conv3x3_s1_int8":
            [_P] * 6 + [_I] * 9 + [_F, _F, _P, _I, _I, _F, _D] + [_I] * 6 + [_P],
    }),
    "fused_mbconv_block": ("fused_mbconv", {
        "ievm_fused_mbconv_expand_dw":
            [_P, _P, _I, _P, _P, _P, _P, _P] + [_I] * 13 + [_F] * 4 + [_P],
        "ievm_fused_mbconv_se_gate": [_P] * 6 + [_I, _I, _I, _D, _I, _P],
        "ievm_fused_mbconv_project":
            [_P, _P, _P, _I, _I, _P, _P, _P] + [_I] * 4 + [_F] * 8 + [_I] * 6 + [_P],
    }),
    "dwconv_int8": ("dwconv_int8", {
        "ievm_dwconv_int8": [_P] * 5 + [_I] * 8 + [_F, _D, _F] + [_I] * 6 + [_P],
    }),
    "gconv_int8": ("gconv_int8", {
        "ievm_gconv_int8": [_P] * 6 + [_I] * 7 + [_F, _F, _F] + [_I] * 7 + [_P],
        "ievm_gconv_quotient_check": [_F, _P, _P],
    }),
    "dense_gelu": ("fused_dense", {
        "ievm_dense_gelu": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    }),
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
    paths = {k: _lib_path(stem) for k, (stem, _) in KERNELS.items()}
    procs = {}
    nvcc = None
    for k, (stem, _) in KERNELS.items():
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


def kernel_fn(name: str, symbol: Optional[str] = None):
    """The bound C entry point ``symbol`` of kernel ``name`` (its only one
    when ``symbol`` is None), built and loaded on first use."""
    if symbol is None:
        (symbol,) = KERNELS[name][1]
    fn = _fns.get(symbol)
    if fn is not None:
        return fn
    with _lock:
        if symbol not in _fns:
            paths = build_all()
            for k, (_, entries) in KERNELS.items():
                lib = ctypes.CDLL(paths[k])
                for sym, argtypes in entries.items():
                    f = getattr(lib, sym)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                    _fns[sym] = f
    return _fns[symbol]


def check_call(name: str, rc: int) -> None:
    """Raise if a C entry returned an error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA call failed with error {rc}")


def check(name: str, rc: int) -> None:
    """Raise on a refused launch (the C entry returns cudaGetLastError()),
    else count the launch."""
    check_call(name, rc)
    launches[name] += 1


# op name -> {device type: implementation}, the same functions the ops dispatch to
_impls: Dict[str, Dict[str, Callable]] = {}


def custom_op(name: str, schema: str, *, cpu: Callable, cuda: Callable, fake: Callable):
    """Register ``ievm::<name>``: ``cpu`` (the plain version) for CPU tensors,
    ``cuda`` (the launch) for CUDA tensors, ``fake`` for tracing (shapes and
    dtypes only). No op writes to its inputs. Returns the op."""
    op = torch.library.custom_op(f"ievm::{name}", cpu, mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    _impls[name] = {"cpu": cpu, "cuda": cuda}
    return op


def via_op() -> bool:
    """True while ``torch.export`` or ``torch.compile`` traces the caller."""
    return torch.compiler.is_compiling()


def call(name: str, *args):
    """Run ``ievm::<name>`` on ``args``: through the op while tracing, else
    the implementation for the first argument's device, called directly."""
    if via_op():
        return getattr(torch.ops.ievm, name)(*args)
    impl = _impls[name].get(args[0].device.type)
    if impl is None:
        raise ValueError(f"{name} runs on cpu or cuda, not {args[0].device}")
    return impl(*args)
