"""The dispatcher's wait for its logits per dispatch in the profiled
stretch (ms): the program's span ``ievm.staging.gather`` (the forward
draining on the card, then the copy back), over the dispatches
(``ievm.batcher.dispatch``)."""

from benchmark.harness.spans import ms_per, probe  # noqa: F401  (probe: read around the stretch)


def read(ctx):
    return ms_per(ctx, ["ievm.staging.gather"], "ievm.batcher.dispatch")
