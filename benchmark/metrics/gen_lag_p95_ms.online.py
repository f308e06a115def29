"""95th percentile of how late the load generator submitted each request of
the window after its due time (ms, the benchmark's clock): where it is
large, the latency the window reports includes the generator's own delay."""

import numpy as np

from benchmark.harness.stats import percentile


def read(ctx):
    lag = ctx.counters.get("gen_lag_s")
    if lag is None or not len(lag):
        return None
    return percentile(np.nan_to_num(np.asarray(lag) * 1e3, nan=np.inf).tolist(), 95)
