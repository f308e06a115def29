"""Share of the dispatched batch rows that were padding (%): 1 - valid
images / rows dispatched, from the MicroBatcher's counters over the window.
The padding is device work that answers no request."""


def read(ctx):
    stats = ctx.counters.get("batcher")
    if not stats or not stats["batches"]:
        return None
    return 100.0 * (1.0 - stats["mean_batch"] / stats["mean_dispatch_slots"])
