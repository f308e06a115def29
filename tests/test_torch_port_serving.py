"""The port's serving entry points on the CPU: Predictor over the committed
static-INT8 artifact, device choice, and what the GPU script does without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from inference_efficient_vision_models_tpu_torch.compress.quant.qresnet import load_static_int8
from inference_efficient_vision_models_tpu_torch.serving import Predictor, load_quantized
from inference_efficient_vision_models_tpu_torch.utils import device as tdev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "bench", "quantization", "r2", "fold_0")


def test_predictor_matches_apply_int8():
    pred = Predictor.from_artifact(ARTIFACT, device="cpu", batch_size=32, bucket_sizes=(1, 8))
    model = load_static_int8(ARTIFACT, device="cpu")
    imgs = np.random.default_rng(3).integers(0, 256, (40, 224, 224, 3), dtype=np.uint8)
    with torch.inference_mode():
        ref = model(torch.from_numpy(imgs)).numpy()
    for n in (1, 5, 40):  # one bucket-1 batch, one bucket-8 batch, a full batch + a tail
        got = pred.predict_logits(imgs[:n])
        assert got.shape == (n, 6) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref[:n], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pred.predict(imgs[:5]), ref[:5].argmax(1))
    assert pred._target_size(1) == 1 and pred._target_size(5) == 8
    assert pred._target_size(9) == 32


def test_predictor_warmup_and_bad_buckets():
    _, model, fn, pre = load_quantized(ARTIFACT, device="cpu")
    pred = Predictor(fn, host_preprocess=pre, batch_size=4, bucket_sizes=(2,), device="cpu")
    pred.warmup()
    assert pred.predict_logits(np.zeros((0, 224, 224, 3), np.uint8)).size == 0
    with pytest.raises(ValueError):
        Predictor(fn, batch_size=4, bucket_sizes=(8,), device="cpu")
    with pytest.raises(NotImplementedError):  # W4A16 is not ported yet
        load_quantized(ARTIFACT, "weight_only_int4", device="cpu")
    with pytest.raises(FileNotFoundError):  # served since PR 8; r2 has no such artifact
        load_quantized(ARTIFACT, "dynamic_int8", device="cpu")


def test_predictor_surfaces_producer_errors():
    def bad_pre(x):
        raise RuntimeError("preprocess failed")

    pred = Predictor(lambda x: x, host_preprocess=bad_pre, batch_size=2, device="cpu")
    with pytest.raises(RuntimeError, match="preprocess failed"):
        pred.predict_logits(np.zeros((5, 4, 4, 3), np.uint8))


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tdev.resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdev.resolve_device(dev)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_static_int8(ARTIFACT, device=dev)
    with pytest.raises(RuntimeError):
        tdev.describe_device()


def _run_smoke(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu_and_alone(tmp_path):
    """No GPU, or no repository beside it: non-zero exit and no result line."""
    for cwd in (ROOT, None):
        if cwd is None:
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
            cwd = str(tmp_path)
        r = _run_smoke(cwd)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
