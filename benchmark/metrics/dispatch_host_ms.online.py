"""Host copies per MicroBatcher dispatch in the profiled stretch (ms): the
program's spans ``ievm.batcher.concat`` (the requests joined), ``.pad`` (to
the bucket) and ``ievm.staging.pin`` (into pinned memory), over the
dispatches (``ievm.batcher.dispatch``). The dispatcher runs them before the
forward is enqueued, with the card idle."""

from benchmark.harness.spans import ms_per, probe  # noqa: F401  (probe: read around the stretch)


def read(ctx):
    return ms_per(ctx, ["ievm.batcher.concat", "ievm.batcher.pad", "ievm.staging.pin"],
                  "ievm.batcher.dispatch")
