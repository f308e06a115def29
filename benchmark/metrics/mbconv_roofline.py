"""Kernel C's share of its roofline (%): the least time the card could take
for the MBConv blocks it computes (``roofline/<family>.py``, group
``mbconv``) over the forwards of the profiled stretch, divided by the device
time of its three launches there."""

from benchmark.harness.peaks import bound_s


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.stretch.get("forwards"):
        return None
    layers = [x for x in ctx.layers if x["group"] == "mbconv"]
    t = ctx.trace.seconds(kind="kernel", match=ctx.groups["mbconv"])
    if not layers or t <= 0:
        return None
    return 100.0 * ctx.stretch["forwards"] * sum(bound_s(x, ctx.peaks) for x in layers) / t
