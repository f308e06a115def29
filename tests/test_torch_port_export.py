"""The port's deployment export (``export.py``) against the JAX package's
(``tests/test_export.py``), on the CPU: the same 64x64 artifacts, made by the
JAX package (``tests/test_export._make_artifact``), exported by the port as
one ``torch.export`` program in the ``IEVM`` container; the program's CPU
logits equal the port's eager plain logits (tolerance 0) and lie within the
port's ResNet serving limit of the JAX package's ``load_quantized``
(rtol/atol 0.02, argmax identical; ``tests/test_torch_port_qresnet.py``);
the port's header has the JAX header's values for every shared key but
``platforms``; each package's ``read_header`` reads the other's container and
the port's ``load_exported`` refuses the JAX one. One small case each of
EfficientNet-B0's and MobileNetV2's fused executors, the dynamic INT8 ViT, a
ResNeXt and a dynamic INT8 ResNet, made by the port's own stage 4 at 32x32,
exported and held equal to eager.
"""

import logging
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from inference_efficient_vision_models_tpu import export as jexp  # noqa: E402
from inference_efficient_vision_models_tpu.serving import load_quantized as j_load  # noqa: E402
from inference_efficient_vision_models_tpu_torch import export as texp  # noqa: E402
from inference_efficient_vision_models_tpu_torch.serving import load_quantized as t_load  # noqa: E402
from tests.test_export import _make_artifact  # noqa: E402

SERVE_TOL = 0.02  # the port's ResNet18 serving limit against the JAX executor
MBV2_WO8_TOL = 0.37  # tests/test_torch_port_mbv2_quant.py: W8A16 against JAX, of max |logit|


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def resnet_fold(tmp_path_factory):
    fold = str(tmp_path_factory.mktemp("r18"))
    return fold, _make_artifact(fold, "resnet18", "static_int8")


def eager(fold, method, x, **kw):
    _, _, fn, _ = t_load(fold, method, device="cpu", **kw)
    with torch.no_grad():
        return fn(torch.from_numpy(x)).float().numpy()


def test_export_static_int8_s2d_layout(resnet_fold):
    fold, imgs = resnet_fold
    out = os.path.join(fold, "resnet18_static.ievm")
    header = texp.save_exported(fold, "static_int8", out, batch_size=8, image_size=(64, 64),
                                platforms=("cpu",), device="cpu")
    assert header["input_layout"] == "s2d"
    assert header["input_shape"] == [8, 32, 32, 12]
    assert texp.read_header(out) == header

    call, hdr2 = texp.load_exported(out, device="cpu")
    assert hdr2 == header
    x = texp.s2d_layout(imgs[:8])
    got = call(x)
    assert got.dtype == np.float32 and got.shape == (8, 6)
    np.testing.assert_array_equal(got, eager(fold, "static_int8", x))
    _, _, fn, pre = j_load(fold, "static_int8")
    assert pre is not None
    ref = np.asarray(fn(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=SERVE_TOL, atol=SERVE_TOL)
    assert (got.argmax(1) == ref.argmax(1)).all()


def test_export_static_int8_device_preprocess_nhwc(resnet_fold):
    """The relayout traced into the program: plain NHWC uint8 in, the same
    logits as the s2d-fed eager path."""
    fold, imgs = resnet_fold
    out = os.path.join(fold, "resnet18_static_nhwc.ievm")
    header = texp.save_exported(fold, "static_int8", out, batch_size=8, image_size=(64, 64),
                                platforms=("cpu",), device_preprocess=True, device="cpu")
    assert header["input_layout"] == "nhwc"
    assert header["input_shape"] == [8, 64, 64, 3]
    call, _ = texp.load_exported(out, device="cpu")
    got = call(imgs[:8])
    np.testing.assert_array_equal(got, eager(fold, "static_int8", texp.s2d_layout(imgs[:8])))


def test_export_weight_only_nhwc_layout(tmp_path):
    fold = str(tmp_path)
    imgs = _make_artifact(fold, "mobilenet_v2", "weight_only_int8")
    out = os.path.join(fold, "mbv2_wo8.ievm")
    header = texp.save_exported(fold, "weight_only_int8", out, batch_size=4,
                                image_size=(64, 64), platforms=("cpu",), device="cpu")
    assert header["input_layout"] == "nhwc" and header["spec_kind"] == "MobileNetV2Spec"
    call, _ = texp.load_exported(out, device="cpu")
    got = call(imgs[:4])
    np.testing.assert_array_equal(got, eager(fold, "weight_only_int8", imgs[:4]))
    _, _, fn, pre = j_load(fold, "weight_only_int8")
    assert pre is None
    ref = np.asarray(fn(jnp.asarray(imgs[:4])), np.float32)
    assert np.abs(got - ref).max() <= MBV2_WO8_TOL * np.abs(ref).max()


def test_export_rejects_garbage(tmp_path):
    p = os.path.join(str(tmp_path), "x.ievm")
    with open(p, "wb") as f:
        f.write(b"NOPEnope")
    with pytest.raises(ValueError):
        texp.read_header(p)
    with pytest.raises(ValueError):
        texp.load_exported(p, device="cpu")


@pytest.fixture(scope="module")
def both_containers(resnet_fold):
    """The same artifact exported by each package (CPU platform)."""
    fold, _ = resnet_fold
    jpath, tpath = os.path.join(fold, "jax.ievm"), os.path.join(fold, "port.ievm")
    kw = dict(batch_size=8, image_size=(64, 64), platforms=("cpu",))
    return (jexp.save_exported(fold, "static_int8", jpath, **kw), jpath,
            texp.save_exported(fold, "static_int8", tpath, device="cpu", **kw), tpath)


def test_header_matches_jax(both_containers):
    jh, _, th, _ = both_containers
    assert set(jh) - {"platforms"} <= set(th)
    for k in set(jh) - {"platforms"}:
        assert th[k] == jh[k], k
    assert th["payload"] == "torch.export" and "payload" not in jh


def test_each_package_reads_the_others_header(both_containers):
    jh, jpath, th, tpath = both_containers
    assert jexp.read_header(tpath) == th
    assert texp.read_header(jpath) == jh


def test_port_refuses_a_jax_container(both_containers):
    _, jpath, _, _ = both_containers
    with pytest.raises(ValueError, match="JAX"):
        texp.load_exported(jpath, device="cpu")


# --------------------------------------------------------------------------
# one small case per family: made by the port's stage 4, exported, equal to eager
# --------------------------------------------------------------------------


class _Cfg:
    batch_size = 8
    calibration_images = 8
    DEBUG_MODE = False
    image_size = (32, 32)
    observer = "minmax"


def port_artifact(fold: str, model: str, method: str):
    from inference_efficient_vision_models_tpu_torch.cli.quantize import _save_qmodel
    from inference_efficient_vision_models_tpu_torch.compress.quant.engine import (
        QuantizationEngine,
    )
    from inference_efficient_vision_models_tpu_torch.models.registry import create_model

    spec, p, s = create_model(model, 6, generator=torch.Generator().manual_seed(0),
                              device="cpu", image_size=32)
    eng = QuantizationEngine(_Cfg(), spec, p, s, logging.getLogger("q"), device="cpu")
    imgs = np.random.default_rng(1).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    if method == "dynamic_int8":
        q, _ = eng.dynamic_quantize()
    else:
        q, _ = eng.static_quantize((imgs, np.zeros(8, np.int32)))
    _save_qmodel(fold, method, q, spec)
    return imgs


@pytest.mark.parametrize("model,method,served,kind", [
    ("efficientnet_b0", "static_int8", "static_int8_fused", "EfficientNetSpec"),
    ("vit_tiny_patch16_224", "dynamic_int8", "dynamic_int8", "ViTSpec"),
    ("resnext26_32x4d", "static_int8", "static_int8", "ResNetSpec"),
    ("mobilenet_v2", "static_int8", "static_int8_fused", "MobileNetV2Spec"),
    ("resnet18", "dynamic_int8", "dynamic_int8", "ResNetSpec"),
])
def test_family_export_equals_eager(tmp_path, model, method, served, kind):
    fold = str(tmp_path)
    imgs = port_artifact(fold, model, method)
    blob = texp.export_quantized(fold, served, batch_size=2, image_size=(32, 32),
                                 device_preprocess=True, device="cpu")
    call, header = texp.load_exported(blob, device="cpu")
    assert header["spec_kind"] == kind and header["input_layout"] == "nhwc"
    kw = {"device_preprocess": True} if served == "static_int8" and kind == "ResNetSpec" else {}
    np.testing.assert_array_equal(call(imgs[:2]), eager(fold, served, imgs[:2], **kw))
