"""Device time per forward of the kernels that are none of the port's
hand-written ones (``benchmark/kernels/*.json``), copies and sets left
out (ms): the plain PyTorch glue inside the executors (im2col, pads,
offsets, activations, requant, pools)."""


def read(ctx):
    if ctx.trace is None or not ctx.stretch.get("forwards"):
        return None
    own = [k for names in ctx.groups.values() for k in names]
    s = ctx.trace.seconds(kind="kernel", exclude=own)
    return 1e3 * s / ctx.stretch["forwards"] if s > 0 else None
