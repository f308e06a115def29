"""Find the highest rate an open-loop configuration sustains, once, on the
card: the run's set-up, then one open-loop window per offered rate on the
same batcher, each reported as a JSON line.

    python3 benchmark/tools/sweep.py --workload r18_int8.online \
        --rates 4000,6000,8000 --seconds 8 --seed 5

A rate is sustained where the images of the requests due up to half a
second before the window's end are answered within the window, to 1%, and
the queue does not grow: the median latency of the window's last quarter
stays within 1.5 times that of its second. The
cell's rate is then its mix's ``load`` times the highest sustained rate,
which the configuration's file keeps as ``online_capacity_images_per_s``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.drivers import open_loop  # noqa: E402
from benchmark.harness.cell import find_cell  # noqa: E402
from benchmark.harness.stats import percentile  # noqa: E402
from benchmark.run import Program  # noqa: E402
from benchmark.traffic import generator  # noqa: E402

SETTLE_S = 0.5  # requests due this close to the window's end may still be in flight


def window(cell, batcher, pool, rate, seconds, seed):
    sched = generator.open_loop(cell.traffic, seed, rate, seconds, len(pool))
    before = batcher.stats()
    res = open_loop.window(batcher, pool, sched, seconds, cell.traffic["drain_limit_s"])
    after = batcher.stats()
    lat = res["latency_s"] * 1e3
    due = sched.due_s
    quarter = len(due) // 4
    second, last = lat[quarter : 2 * quarter], lat[-quarter:]
    early = due <= seconds - SETTLE_S
    in_window = early & ((res["latency_s"] + due) <= seconds)
    return {
        "offered_images_per_s": sched.images / seconds,
        "offered_early": float(sched.size[early].sum()),
        "answered_early_in_window": float(sched.size[in_window].sum()),
        "requests": len(due),
        "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
        "p99_ms": percentile(lat, 99),
        "second_quarter_p50_ms": percentile(second, 50), "last_quarter_p50_ms": percentile(last, 50),
        "gen_lag_p95_ms": percentile(np.nan_to_num(res["gen_lag_s"] * 1e3, nan=np.inf), 95),
        "unanswered": res["unanswered"], "raised": res["raised"],
        "mean_batch": (after["images"] - before["images"])
        / max(after["batches"] - before["batches"], 1),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="offered images/s, comma-separated")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    cell = find_cell(args.workload)
    t0 = time.perf_counter()
    prog = Program(cell, "cuda")
    pool = generator.frames(cell.traffic["pool_images"], cell.config["image_hw"], args.seed)
    batcher = open_loop.setup(cell, prog, pool)
    print(json.dumps({"setup_s": time.perf_counter() - t0,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        row = window(cell, batcher, pool, rate, args.seconds, args.seed)
        row["sustained"] = bool(row["answered_early_in_window"] >= 0.99 * row["offered_early"]
                                and row["last_quarter_p50_ms"] <= 1.5 * row["second_quarter_p50_ms"]
                                and row["unanswered"] == 0)
        print(json.dumps({"rate": rate, **row}), flush=True)
    prog.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
