"""The port's profiling and plotting helpers (``utils/profiling.py``,
``metrics/device_profile.py``, ``metrics/plots.py``) on the CPU: ``trace``
writes a trace file, an ``annotate`` region appears among the profiler's
events, the device tables are empty without a GPU, and the training-curve
PNG has the JAX package's pixel size; the training loop writes it where
matplotlib is installed and says so where it is not.

``annotate`` is also the port's span: it counts into ``totals()`` on every
thread, opens a profiler range only while a profiler runs, and the serving
path (``Predictor``, ``MicroBatcher``) opens its spans once per batch."""

import logging
import os
import struct
import sys
import threading

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from inference_efficient_vision_models_tpu.metrics.plots import (  # noqa: E402
    plot_training_curves as j_plot,
)
from inference_efficient_vision_models_tpu_torch.metrics.device_profile import (  # noqa: E402
    profile_device_ops,
    profile_hlo_ops,
)
from inference_efficient_vision_models_tpu_torch.metrics.plots import (  # noqa: E402
    plot_training_curves,
)
from inference_efficient_vision_models_tpu_torch.serving import (  # noqa: E402
    MicroBatcher,
    Predictor,
)
from inference_efficient_vision_models_tpu_torch.train import loop  # noqa: E402
from inference_efficient_vision_models_tpu_torch.utils.profiling import (  # noqa: E402
    annotate,
    totals,
    trace,
)

HISTORY = {"train_loss": [1.2, 0.9, 0.7], "val_loss": [1.3, 1.0, 0.9],
           "train_acc": [0.3, 0.5, 0.7], "val_acc": [0.25, 0.45, 0.6]}


def _work():
    a = torch.randn(64, 64)
    return (a @ a).relu().sum()


def test_trace_writes_a_trace_file(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        with annotate("ievm_block"):
            _work()
    files = [f for f in os.listdir(d) if f.endswith(".json")]
    assert files, os.listdir(d)
    with open(os.path.join(d, files[0])) as f:
        assert "ievm_block" in f.read()


def test_trace_is_a_noop_without_a_directory():
    with trace(None) as p:
        _work()
    assert p is None


def test_annotate_region_among_profiler_events():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("ievm_region"):
            _work()
    assert "ievm_region" in {e.key for e in prof.key_averages()}


def test_device_tables_are_empty_on_the_cpu():
    assert profile_device_ops(_work, iters=2) == []
    assert profile_hlo_ops(_work, iters=2) == []


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", head[16:24])


def test_training_curves_png_matches_jax_size(tmp_path):
    got = plot_training_curves(str(tmp_path / "port"), HISTORY, "resnet18")
    ref = j_plot(str(tmp_path / "jax"), HISTORY, "resnet18")
    assert os.path.basename(got) == os.path.basename(ref) == "training_curves.png"
    assert _png_size(got) == _png_size(ref) == (1210, 440)  # figsize (11, 4) at dpi 110
    assert plot_training_curves(str(tmp_path / "none"), {"train_loss": []}) is None


def test_loop_plots_or_says_it_cannot(tmp_path, monkeypatch, caplog):
    log = logging.getLogger("plot")
    loop._plot(str(tmp_path / "a"), HISTORY, "resnet18", log)
    assert os.path.exists(tmp_path / "a" / "training_curves.png")
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on the GPU machine
    with caplog.at_level(logging.INFO, logger="plot"):
        loop._plot(str(tmp_path / "b"), HISTORY, "resnet18", log)
    assert not os.path.exists(tmp_path / "b")
    assert "no training_curves.png written" in caplog.text


# -- annotate as the port's span ---------------------------------------------

def _delta(before, after, name):
    c0, s0 = before.get(name, (0, 0.0))
    c1, s1 = after.get(name, (0, 0.0))
    return c1 - c0, s1 - s0


def test_a_span_counts_once_without_a_profiler():
    before = totals()
    with annotate("ievm.test.counted"):
        _work()
    count, seconds = _delta(before, totals(), "ievm.test.counted")
    assert count == 1 and seconds > 0


def test_no_range_is_opened_without_a_profiler(monkeypatch):
    def no_range(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    before = totals()
    with annotate("ievm.test.no_range"):
        _work()
    assert _delta(before, totals(), "ievm.test.no_range")[0] == 1


def test_a_range_on_the_calling_thread_while_profiling():
    from torch.profiler import ProfilerActivity, profile

    before = totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("ievm.test.range"):
            _work()
    assert _delta(before, totals(), "ievm.test.range")[0] == 1
    events = prof.events()
    rng = [e for e in events if e.name == "ievm.test.range"]
    mm = [e for e in events if e.name == "aten::mm"]
    assert len(rng) == 1 and mm and rng[0].thread == mm[0].thread
    assert rng[0].time_range.start <= mm[0].time_range.start <= rng[0].time_range.end


def test_threads_counting_one_name_lose_no_count():
    per_thread, n_threads = 2000, 8
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = totals()

        def spans():
            for _ in range(per_thread):
                with annotate("ievm.test.threads"):
                    pass

        threads = [threading.Thread(target=spans) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert _delta(before, totals(), "ievm.test.threads")[0] == per_thread * n_threads


def _logits(x):
    return x.reshape(len(x), -1)[:, :3].float()


IMAGES = np.arange(10 * 4 * 4 * 3, dtype=np.uint8).reshape(10, 4, 4, 3)


def test_predictor_spans_once_per_batch():
    pred = Predictor(_logits, batch_size=4, device="cpu")
    before = totals()
    out = pred.predict_logits(IMAGES)
    after = totals()
    np.testing.assert_array_equal(out, _logits(torch.from_numpy(IMAGES)).numpy())
    batches = 3  # 4 + 4 + 2 images
    for name in ("ievm.staging.pin", "ievm.staging.h2d", "ievm.executor.forward",
                 "ievm.staging.gather"):
        assert _delta(before, after, name)[0] == batches, name
    # the caller waits once a batch, and once for the end of the stream
    assert _delta(before, after, "ievm.staging.wait_host")[0] == batches + 1


def test_microbatcher_spans_once_per_dispatch_and_its_queue_wait():
    pred = Predictor(_logits, batch_size=8, bucket_sizes=(2,), device="cpu")
    before = totals()
    with MicroBatcher(pred, max_wait_ms=1) as mb:
        mb.warmup((4, 4, 3))
        assert mb.queue_waited == 0 and mb.queue_wait_s == 0.0  # warmup counts in neither
        warm = totals()
        for i in range(3):
            np.testing.assert_array_equal(mb.infer(IMAGES[i : i + 1]),
                                          _logits(torch.from_numpy(IMAGES[i : i + 1])).numpy())
        futs = [mb.submit(IMAGES[i : i + 2]) for i in range(0, 10, 2)]
        assert all(f.result(timeout=30).shape == (2, 3) for f in futs)
    # read once the dispatcher has stopped: a future is set before its
    # dispatch's last counters
    stats, after = mb.stats(), totals()
    dispatches = stats["batches"]
    assert dispatches >= 4 and mb.queue_waited == stats["requests"] == 8
    assert mb.queue_wait_s >= 0
    assert stats["queue_wait_ms_mean"] == 1e3 * mb.queue_wait_s / 8
    for name in ("ievm.batcher.dispatch", "ievm.batcher.pad", "ievm.staging.gather"):
        assert _delta(before, warm, name)[0] == 0, name
        assert _delta(warm, after, name)[0] == dispatches, name
    # each request is copied into the staging buffer as it is coalesced
    assert _delta(before, warm, "ievm.batcher.concat")[0] == 0
    assert _delta(warm, after, "ievm.batcher.concat")[0] == stats["requests"]
    # the warmup runs each shape once: the bucket and the full batch; the
    # dispatches hand the buffer on with no pinned copy
    for name, per_dispatch in (("ievm.staging.pin", 0), ("ievm.staging.h2d", 1),
                               ("ievm.executor.forward", 1)):
        assert _delta(before, warm, name)[0] == 2, name
        assert _delta(warm, after, name)[0] == per_dispatch * dispatches, name
