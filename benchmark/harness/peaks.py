"""The card's published peaks (NVIDIA H100 SXM data sheet, dense rates, at
its 700 W limit), by the name ``torch.cuda.get_device_name`` gives."""

from __future__ import annotations

from typing import Optional

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "int8_ops_per_s": 1979e12,
    "fp32_fma_per_s": 33.5e12,   # 67 TFLOP/s outside the tensor cores, 2 per FMA
    "fp64_fma_per_s": 33.5e12,   # 67 TFLOP/s on the tensor cores, 2 per FMA
}


def peaks_for(device_kind: str) -> Optional[dict]:
    """The peak table of a card, or None where the benchmark has none (then
    no share of a peak or of a roofline is reported)."""
    return H100 if "H100" in device_kind else None


def bound_s(work: dict, peaks: dict) -> float:
    """The least time the card could take for ``work``: the largest of its
    bytes over HBM bandwidth and each kind of operation over its own rate."""
    return max(work.get("bytes", 0) / peaks["hbm_bytes_per_s"],
               work.get("int8_ops", 0) / peaks["int8_ops_per_s"],
               work.get("fp32_fma", 0) / peaks["fp32_fma_per_s"],
               work.get("fp64_fma", 0) / peaks["fp64_fma_per_s"])
