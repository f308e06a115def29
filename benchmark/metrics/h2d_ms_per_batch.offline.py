"""Device time of the host-to-device copies per batch staged in the
profiled stretch (ms): ``Memcpy HtoD`` events over the batches."""


def read(ctx):
    if ctx.trace is None or not ctx.stretch.get("batches"):
        return None
    s = ctx.trace.seconds(prefix="Memcpy HtoD")
    return 1e3 * s / ctx.stretch["batches"] if s > 0 else None
