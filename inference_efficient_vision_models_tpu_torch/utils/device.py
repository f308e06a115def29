"""Device choice: the port's entry points run on the GPU unless the caller
passes ``device="cpu"``, and never fall back to the CPU on their own."""

from __future__ import annotations

import contextlib
import subprocess
from typing import Dict, Iterator, Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; asking for ``cuda`` with no GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """Run fp32 convs and matmuls in full fp32: turn TF32 off for cuDNN and
    cuBLAS (PyTorch leaves it on for cuDNN convs, which rounds their inputs
    to 10 mantissa bits), and restore both settings after."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def describe_device() -> Dict[str, Optional[str]]:
    """The GPU's name and power limit as nvidia-smi reports them, and the count."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    smi = None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return {
        "name": torch.cuda.get_device_name(0),
        "nvidia_smi": smi,
        "power_limit": smi.partition(",")[2].strip() if smi else None,
        "count": torch.cuda.device_count(),
    }
