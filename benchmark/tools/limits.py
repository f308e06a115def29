"""The readings a cell's correctness limit is set from, for many seeds in one
process: for each seed a short window of the cell's own traffic at its own
sizes, the sample a run compares, and on that sample

* ``program``: the gap between what the window returned and the reference
  (``run.logit_gap``), the lower reading;
* ``control``: the gap between the reference computed on the int4 grid and
  the reference, the upper reading (the control of the cell's int8
  configuration: the next precision down).

    python3 benchmark/tools/limits.py --workload r18_int8.offline \
        --seeds 11,12,13 --seconds 3

One JSON line per seed, then the largest program reading and the smallest
control reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.harness.cell import find_cell  # noqa: E402
from benchmark.traffic import generator  # noqa: E402


def control_logits(cell, device, images: np.ndarray, bits: int) -> np.ndarray:
    ref = cell.reference().Reference(cell.config_dir, device, bits=bits)
    out = [ref(torch.from_numpy(np.ascontiguousarray(images[i : i + run.REF_CHUNK])).to(device))
           .cpu().numpy() for i in range(0, len(images), run.REF_CHUNK)]
    return np.concatenate(out).astype(np.float64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    cell = find_cell(args.workload)
    prog = run.Program(cell, "cuda")
    progs, ctls = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        pool = generator.frames(cell.traffic["pool_images"], cell.config["image_hw"], seed)
        res = cell.driver().run(cell, prog, pool, args.seconds, None, seed)
        prog.release()
        images = res["sample"]["images"]
        ref = run.reference_logits(cell, "cuda", images)
        got = np.stack(res["sample"]["program"])
        ctl = control_logits(cell, "cuda", images, 4)
        row = {"seed": seed, "compared": len(got), "program": run.logit_gap(got, ref),
               "control": run.logit_gap(ctl, ref),
               "argmax_flips_control": int((ctl.argmax(1) != ref.argmax(1)).sum()),
               "checks": {k: v[0] for k, v in res["checks"].items()}}
        progs.append(row["program"])
        ctls.append(row["control"])
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": cell.name, "lower": max(progs), "upper": min(ctls),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    prog.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
