"""Share of the profiled stretch in which nothing ran on the card (%): 1 -
the union of its kernel, copy and set intervals / the stretch's length."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    busy = ctx.trace.busy_s()
    return 100.0 * (1.0 - busy / ctx.trace.window_s) if busy > 0 else None
