"""The port's deployment CLIs on the CPU against the JAX package's:
``cli/predict.py`` on the 64x64 static-INT8 ResNet18 of
``test_torch_port_server.make_artifact``, and ``cli/import_torch.py`` on
``tests/torch_ref.resnet18`` (the written checkpoint and spec byte-EQUAL to
the JAX CLI's).

Predict: the same image names, ranks and classes as the JAX CLI. The JAX
CLI serves through JAX's ``lax`` int8 executor, which on these images
differs from JAX's own Pallas-kernel executor by up to 0.0207 in a logit
(0.0074 in a probability: a requant tie rounded the other way); the port
computes the Pallas executor's function bit for bit. So the port's
probabilities are held within 1e-4 (the CSV rounds to 4 decimals) of the
JAX Pallas executor's on the same decoded images, and within
``LAX_PROB_ATOL`` of the JAX CLI's.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import bmp_bytes, png_bytes
from inference_efficient_vision_models_tpu import serving as j_serving
from inference_efficient_vision_models_tpu.cli import import_torch as j_import
from inference_efficient_vision_models_tpu.cli import predict as j_predict
from inference_efficient_vision_models_tpu.compress.quant import qresnet as jq
from inference_efficient_vision_models_tpu.models import registry as jreg
from inference_efficient_vision_models_tpu_torch.cli import import_torch as t_import
from inference_efficient_vision_models_tpu_torch.cli import predict as t_predict
from inference_efficient_vision_models_tpu_torch.cli.teacher import load_stage_model
from inference_efficient_vision_models_tpu_torch.models.registry import apply_model

try:
    from tests import torch_ref
    from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from tests.test_torch_port_server import SIZE, images, make_artifact
except ImportError:
    import torch_ref
    from test_torch_port_prune import one_thread  # noqa: F401  (autouse)
    from test_torch_port_server import SIZE, images, make_artifact


# the JAX CLI's lax executor against the port (= JAX's Pallas executor): a
# logit moved 0.0207 by a requant tie moves a probability 0.0074 here; the
# ResNet18 limit (|dz| <= 0.02 + 0.02 |z|) admits up to ~0.01 at these scales
LAX_PROB_ATOL = 0.01


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    return make_artifact(tmp_path_factory.mktemp("r18"))


@pytest.fixture
def cpu_platform(monkeypatch):
    monkeypatch.setenv("IEVM_PLATFORM", "cpu")


def _inputs(root):
    """A 5-image npy, a directory of three BMPs (24-bit, 8-bit, and one
    80x80 to be resized) and a lone PNG."""
    rng = np.random.default_rng(1)
    npy = root / "batch.npy"
    np.save(npy, images(5, seed=2))
    d = root / "imgs" / "sub"
    d.mkdir(parents=True)
    (d / "a.bmp").write_bytes(bmp_bytes(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)))
    (d / "b.bmp").write_bytes(bmp_bytes(rng.integers(0, 256, (SIZE, SIZE), dtype=np.uint8)))
    (d / "c.bmp").write_bytes(bmp_bytes(rng.integers(0, 256, (80, 80, 3), dtype=np.uint8)))
    png = root / "lone.png"
    png.write_bytes(png_bytes(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)))
    return f"{npy},{root / 'imgs'},{png}"


def _rows(path):
    lines = path.read_text().strip().splitlines()
    assert lines[0] == "image,rank,class_id,class_name,prob"
    return [ln.split(",") for ln in lines[1:]]


def test_predict_csv_matches_jax(tmp_path, fold, cpu_platform):
    inputs = _inputs(tmp_path)
    args = [f"artifact={fold}", f"inputs={inputs}", "image_size=(64,64)", "batch_size=16",
            "topk=2"]
    assert t_predict.main(args + [f"output={tmp_path / 'port.csv'}"]) == 0
    assert j_predict.main(args + [f"output={tmp_path / 'jax.csv'}"]) == 0
    got, ref = _rows(tmp_path / "port.csv"), _rows(tmp_path / "jax.csv")
    assert len(got) == len(ref) == (5 + 3 + 1) * 2
    assert [r[:4] for r in got] == [r[:4] for r in ref]  # names, ranks, class ids and names
    probs = np.array([float(r[4]) for r in got])
    np.testing.assert_allclose(probs, [float(r[4]) for r in ref], atol=LAX_PROB_ATOL)

    # JAX's Pallas executor on the images the JAX CLI decoded
    spec, qmodel, _, pre = j_serving.load_quantized(fold, "static_int8")
    imgs, _ = j_predict._scan_inputs(inputs, (SIZE, SIZE))
    logits = np.asarray(jq.apply_int8(spec, qmodel, jnp.asarray(pre(imgs)), impl="pallas",
                                      interpret=True))
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    order = np.argsort(-p, axis=1)[:, :2]
    assert [int(r[2]) for r in got] == order.ravel().tolist()
    np.testing.assert_allclose(probs, np.take_along_axis(p, order, 1).ravel(), atol=1e-4)


def test_predict_experiment_resolution_and_errors(tmp_path, fold, cpu_platform, monkeypatch,
                                                  capsys):
    shutil.copytree(fold, tmp_path / "output" / "quantization" / "expX" / "fold_0")
    monkeypatch.chdir(tmp_path)
    np.save(tmp_path / "b.npy", images(2, seed=3))
    assert t_predict.main(["artifact=expX", f"inputs={tmp_path / 'b.npy'}",
                           "image_size=(64,64)", "batch_size=4"]) == 0
    out = capsys.readouterr()
    assert out.out.count("\n") == 3 and "img/s" in out.err  # header + 2 rows to stdout
    for bad in (["artifact=nope", f"inputs={tmp_path / 'b.npy'}"],
                ["artifact=expX", "inputs=missing.bmp"],
                ["artifact=expX", f"inputs={tmp_path / 'b.npy'}", "colour=blue"],
                ["artifact=expX", f"inputs={tmp_path / 'b.npy'}"],  # 64x64 npy, 224 expected
                ["inputs=x"]):
        with pytest.raises(SystemExit):
            t_predict.main(bad)


def test_predict_needs_a_gpu_unless_told_cpu(tmp_path, fold, monkeypatch):
    monkeypatch.delenv("IEVM_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.save(tmp_path / "b.npy", images(1, seed=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_predict.main([f"artifact={fold}", f"inputs={tmp_path / 'b.npy'}",
                        "image_size=(64,64)"])


def test_import_torch_bytes_equal_jax(tmp_path, monkeypatch):
    tm = torch_ref.resnet18(num_classes=6)
    ckpt = str(tmp_path / "model_best.pth")
    # the wrapped + DataParallel-prefixed form the reference writes
    torch.save({"model_state_dict": {"module." + k: v for k, v in tm.state_dict().items()}},
               ckpt)
    # the JAX CLI reads only the spec of the model it creates: skip its weight init
    monkeypatch.setattr(j_import, "create_model",
                        lambda m, num_classes: (jreg.make_spec(m, num_classes), None, None))
    for name, cli in (("port", t_import), ("jax", j_import)):
        cli.main([ckpt, "model=resnet18", f"out={tmp_path / name}", "num_classes=6"])
    for f in ("model_best.msgpack", "model_best.spec.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    # the port reads its own output back into the torch model's function
    spec, params, state = load_stage_model(str(tmp_path / "port"), "best", "cpu")
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = tm.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        got = apply_model(spec, params, state, torch.from_numpy(x), train=False)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(SystemExit):
        t_import.main([ckpt])
    with pytest.raises(NotImplementedError):
        t_import.main([ckpt, "model=vit_tiny_patch16_224", f"out={tmp_path / 'v'}"])
