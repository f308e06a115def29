"""95th percentile of the window's request latency (ms, the benchmark's
clock): from each request's due time to its logits, over every request due
in the window, one that failed or was never answered counting as infinite.
The tail of what ``latency_p50_ms`` takes the median of; a host that stands
still for a second or more moves it far more than the median."""

import numpy as np

from benchmark.harness.stats import percentile


def read(ctx):
    lat = ctx.counters.get("latency_s")
    if lat is None or not len(lat):
        return None
    return percentile((np.asarray(lat) * 1e3).tolist(), 95)
