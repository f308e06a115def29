"""A request's mean wait in the MicroBatcher (ms), from ``submit`` to the
start of its dispatch, over every request dispatched in the window: the
program's counter, the batcher's ``stats()["queue_wait_ms_mean"]``. The
coalescing window and every dispatch ahead of the request count in it. A
program whose batcher keeps no such counter reads as nothing."""


def read(ctx):
    stats = ctx.counters.get("batcher")
    if not stats or not stats["batches"] or "queue_wait_ms_mean" not in stats:
        return None
    return stats["queue_wait_ms_mean"]
