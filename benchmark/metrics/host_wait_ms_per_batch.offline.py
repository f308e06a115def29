"""The calling thread's wait for the producer thread in
``Predictor.predict_logits`` per batch in the profiled stretch (ms): the
program's span ``ievm.staging.wait_host`` (opened once a batch and once for
the end of each call's stream), over the batches (``ievm.executor.forward``).
Time the card may idle for want of a staged batch."""

from benchmark.harness.spans import ms_per, probe  # noqa: F401  (probe: read around the stretch)


def read(ctx):
    return ms_per(ctx, ["ievm.staging.wait_host"], "ievm.executor.forward")
