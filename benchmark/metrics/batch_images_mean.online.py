"""Valid images per forward that the MicroBatcher dispatched over the window
(its ``stats()["mean_batch"]``). At a fixed offered rate a batcher whose
cycles are shorter gathers fewer images a cycle."""


def read(ctx):
    stats = ctx.counters.get("batcher")
    if not stats or not stats["batches"]:
        return None
    return stats["mean_batch"]
