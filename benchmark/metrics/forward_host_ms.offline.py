"""Host time to enqueue one forward in the profiled stretch (ms): the
program's span ``ievm.executor.forward`` (the executor's Python and its
launches, not the card's work) over its count."""

from benchmark.harness.spans import ms_per, probe  # noqa: F401  (probe: read around the stretch)


def read(ctx):
    return ms_per(ctx, ["ievm.executor.forward"], "ievm.executor.forward")
