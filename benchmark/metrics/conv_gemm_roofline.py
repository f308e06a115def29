"""Kernels A and B's share of their roofline (%): the least time the card
could take for the layers they compute (``roofline/<family>.py``, group
``conv_gemm``) over the forwards of the profiled stretch, divided by the
device time of their kernels there."""

from benchmark.harness.peaks import bound_s


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.stretch.get("forwards"):
        return None
    layers = [x for x in ctx.layers if x["group"] == "conv_gemm"]
    t = ctx.trace.seconds(kind="kernel", match=ctx.groups["conv_gemm"])
    if not layers or t <= 0:
        return None
    return 100.0 * ctx.stretch["forwards"] * sum(bound_s(x, ctx.peaks) for x in layers) / t
