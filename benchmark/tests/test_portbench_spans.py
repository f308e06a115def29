"""The readers of the program's own spans and counters: a span reader gives
its value from the totals read as the stretch starts and as it stops,
nothing where its count did not advance or where the program keeps no
totals, and a probe read around a real stretch sees the spans opened inside
it; the queue wait reads the batcher's counters over the window."""

from types import SimpleNamespace

import pytest

from benchmark.harness.cell import metric_module

BEFORE = {"ievm.batcher.dispatch": (10, 0.5),
          "ievm.batcher.concat": (10, 0.1), "ievm.batcher.pad": (10, 0.2),
          "ievm.staging.pin": (10, 0.05), "ievm.staging.gather": (10, 0.15),
          "ievm.staging.wait_host": (17, 0.01), "ievm.executor.forward": (16, 0.04)}
AFTER = {"ievm.batcher.dispatch": (14, 0.7),
         "ievm.batcher.concat": (14, 0.13), "ievm.batcher.pad": (14, 0.28),
         "ievm.staging.pin": (14, 0.07), "ievm.staging.gather": (14, 0.21),
         "ievm.staging.wait_host": (51, 0.044), "ievm.executor.forward": (48, 0.104)}

EXPECTED = {
    "dispatch_host_ms.online": 1e3 * (0.03 + 0.08 + 0.02) / 4,
    "dispatch_gather_ms.online": 1e3 * 0.06 / 4,
    "host_wait_ms_per_batch.offline": 1e3 * 0.034 / 32,  # per batch, not per wait
    "forward_host_ms.offline": 1e3 * 0.064 / 32,
}
DENOMINATOR = {"dispatch_host_ms.online": "ievm.batcher.dispatch",
               "dispatch_gather_ms.online": "ievm.batcher.dispatch",
               "host_wait_ms_per_batch.offline": "ievm.executor.forward",
               "forward_host_ms.offline": "ievm.executor.forward"}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_reader_takes_the_delta_across_the_stretch(metric):
    got = metric_module(metric).read(SimpleNamespace(probe=(BEFORE, AFTER)))
    assert got == pytest.approx(EXPECTED[metric], rel=1e-9)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_reader_gives_nothing_where_its_count_did_not_advance(metric):
    name = DENOMINATOR[metric]
    stalled = dict(AFTER, **{name: BEFORE[name]})
    mod = metric_module(metric)
    assert mod.read(SimpleNamespace(probe=(BEFORE, stalled))) is None
    assert mod.read(SimpleNamespace(probe=({}, {}))) is None
    # a program without totals (its probe reads None) and a run without a probe
    assert mod.read(SimpleNamespace(probe=(None, None))) is None
    assert mod.read(SimpleNamespace(probe=None)) is None


def test_a_real_zero_wait_reads_zero():
    before = {"ievm.staging.wait_host": (5, 0.25), "ievm.executor.forward": (4, 0.1)}
    after = {"ievm.staging.wait_host": (9, 0.25), "ievm.executor.forward": (8, 0.2)}
    assert metric_module("host_wait_ms_per_batch.offline").read(
        SimpleNamespace(probe=(before, after))) == 0.0


STATS = {"requests": 40, "batches": 4, "images": 180, "mean_batch": 45.0,
         "mean_dispatch_slots": 64.0}
QUEUE_WAIT = {
    "read": ({"batcher": dict(STATS, queue_wait_ms_mean=26.5)}, 26.5),
    "zero": ({"batcher": dict(STATS, queue_wait_ms_mean=0.0)}, 0.0),
    "no_dispatch": ({"batcher": dict(STATS, batches=0, queue_wait_ms_mean=0.0)}, None),
    "a_batcher_without_it": ({"batcher": STATS}, None),
    "no_batcher": ({}, None),
}


@pytest.mark.parametrize("case", sorted(QUEUE_WAIT))
def test_the_queue_wait_reads_the_batchers_counter(case):
    counters, want = QUEUE_WAIT[case]
    assert metric_module("queue_wait_ms.online").read(SimpleNamespace(counters=counters)) == want


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_probe_reads_the_programs_spans_around_the_stretch(metric):
    from benchmark.harness.trace import Stretch
    from inference_efficient_vision_models_tpu_torch.utils.profiling import annotate

    stretch = Stretch(False, {metric: metric_module(metric).probe})
    stretch.start()
    for name in BEFORE:
        with annotate(name):
            pass
    stretch.stop()
    got = metric_module(metric).read(SimpleNamespace(probe=stretch.probed[metric]))
    assert got is not None and got >= 0
