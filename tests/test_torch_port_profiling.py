"""The port's profiling and plotting helpers (``utils/profiling.py``,
``metrics/device_profile.py``, ``metrics/plots.py``) on the CPU: ``trace``
writes a trace file, an ``annotate`` region appears among the profiler's
events, the device tables are empty without a GPU, and the training-curve
PNG has the JAX package's pixel size; the training loop writes it where
matplotlib is installed and says so where it is not."""

import logging
import os
import struct
import sys

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
from inference_efficient_vision_models_tpu_torch.train import loop  # noqa: E402
from inference_efficient_vision_models_tpu_torch.utils.profiling import annotate, trace  # noqa: E402

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
