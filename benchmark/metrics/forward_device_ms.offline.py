"""Device time of every kernel per forward in the profiled stretch (ms):
the executor's whole device work, copies and sets left out."""


def read(ctx):
    if ctx.trace is None or not ctx.stretch.get("forwards"):
        return None
    s = ctx.trace.seconds(kind="kernel")
    return 1e3 * s / ctx.stretch["forwards"] if s > 0 else None
