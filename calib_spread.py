"""The spread of the card's MobileNetV2 calibration against the JAX CPU
conversion record, the evidence for ``chip_smoke.MBV2_CONVERT_LIMITS``
(``scale_rtol``).

For each record (the committed seed-0 one, ``testdata/mbv2_convert_jax.json``,
and any written by ``JAX_PLATFORMS=cpu python tests/test_torch_port_mbv2_quant.py
--seed N --out DIR``), the same seeded full-width MobileNetV2 is folded from
the record's BN statistics, calibrated on the card and converted, as
``chip_smoke.py``'s ``convert_mbv2`` does: first in fp64 (the reference:
its deviation from the record is the record's own fp32 error), then
``--runs`` times in fp32 (the sound runs), then once per control, the
calibration forward in bf16 and in fp16 (the folded model and the
normalized images cast; a calibration the limit has to refuse). Each run
prints one JSON line: the largest relative deviation of an activation scale
from the record and from the card's fp64 run, which scale, whether the
non-activation leaves are equal, and whether ``scale_rtol`` passes it.

    python3 calib_spread.py [--records DIR ...] [--runs 2]

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs

CONTROLS = {"bf16": torch.bfloat16, "fp16": torch.float16}


@contextlib.contextmanager
def calibration_in(dtype):
    """Calibrate in ``dtype``: ``calib`` normalizes the images in it, and the
    folded tree is placed in it."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import calib, qresnet

    norm, place = calib.normalize_images, qresnet.place_folded
    calib.normalize_images = lambda x: norm(x).to(dtype)
    qresnet.place_folded = lambda tree, device=None, _=None: place(tree, device, dtype)
    try:
        yield
    finally:
        calib.normalize_images, qresnet.place_folded = norm, place


def spread(record_path: str, state_path: str, runs: int):
    from inference_efficient_vision_models_tpu_torch.compress.quant import qmobilenet as tqm

    with open(record_path) as f:
        rec = json.load(f)
    cfg = rec["provenance"]["config"]
    spec, p, _, imgs, labels = cs.effnet_convert_inputs("mobilenet_v2", cfg)
    if cs.leaf_sums(p).tolist() != rec["provenance"]["param_sums"]:
        raise cs.SmokeFailure(f"{record_path} was made from other weights")
    state = cs.nested_from_npz(np.load(state_path))
    rec64 = None
    trials = [("fp64", torch.float64)] + [("fp32", None)] * runs + list(CONTROLS.items())
    for i, (name, dtype) in enumerate(trials):
        with calibration_in(dtype) if dtype is not None else contextlib.nullcontext():
            q, obs, t = cs.port_convert_effnet(spec, p, state, imgs, labels, "cuda", cfg)
        ser = tqm.serializable(q)
        report = cs.compare_conversion(ser, rec, cs.MBV2_CONVERT_LIMITS, cs._eff_tap_of)
        if rec64 is None:
            rec64 = cs.conversion_record(ser, obs)
        own = cs.compare_conversion(ser, rec64, {"scale_rtol": 0.0}, cs._eff_tap_of)
        cs.emit({"phase": "calib_spread", "record": os.path.relpath(record_path),
                 "seed": cfg["seed"], "run": i, "calibration": name,
                 "max_scale_rel": report["max_scale_rel"], "worst_scale": report["worst_scale"],
                 "scale_rtol": cs.MBV2_CONVERT_LIMITS["scale_rtol"],
                 "passes": report["ok"], "leaves_unequal": len(report["leaves_unequal"]),
                 "zp_bad": len(report["zp_bad"]),
                 "vs_card_fp64_max_scale_rel": own["max_scale_rel"],
                 "vs_card_fp64_worst_scale": own["worst_scale"], "calibrate_s": t["calibrate_s"]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", nargs="*", default=[],
                    help="directories holding another record and its statistics")
    ap.add_argument("--runs", type=int, default=2, help="fp32 runs per record")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("calib_spread: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    cs.emit({"phase": "device", "nvidia_smi": smi.strip()})
    pairs = [(cs.MBV2_CONVERT_GOLDEN, cs.MBV2_CONVERT_STATE)] + [
        (os.path.join(d, os.path.basename(cs.MBV2_CONVERT_GOLDEN)),
         os.path.join(d, os.path.basename(cs.MBV2_CONVERT_STATE))) for d in a.records]
    for rec, state in pairs:
        spread(rec, state, a.runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
