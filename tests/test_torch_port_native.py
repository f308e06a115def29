"""The port's host decoder and space-to-depth (``data/native_loader.py`` over
``csrc/host/dataloader.cpp``) and the real-image branch of
``data/neudet.py``, against the JAX package's native loader and loader on
the same seeded BMP files: decode, resize and s2d byte-EQUAL (the same C++
code, built separately); the JAX tolerance of native against PIL resize
(mean |delta| < 2) where PIL is the reference. The BMPs come from
``chip_smoke.bmp_bytes`` (written without PIL, which the port must not
need); PIL reading them
back equal checks that writer.
"""

import os
import sys

import numpy as np
import pytest

from chip_smoke import bmp_bytes, png_bytes
from inference_efficient_vision_models_tpu.core import config as jconfig
from inference_efficient_vision_models_tpu.data import native_loader as jnl
from inference_efficient_vision_models_tpu.data import neudet as jneudet
from inference_efficient_vision_models_tpu_torch.core import config as tconfig
from inference_efficient_vision_models_tpu_torch.data import native_loader as tnl
from inference_efficient_vision_models_tpu_torch.data import neudet as tneudet
from inference_efficient_vision_models_tpu_torch.ops.space_to_depth import (
    space_to_depth_u8,
    space_to_depth_u8_plain,
)


def write_bmps(root, n: int, size, kind: str, seed: int = 0):
    """n seeded BMPs of ``size`` (h, w): kind "8bit" (grey palette) or "24bit"."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        shape = size if kind == "8bit" else (*size, 3)
        paths.append(os.path.join(root, f"img_{i}.bmp"))
        with open(paths[-1], "wb") as f:
            f.write(bmp_bytes(rng.integers(0, 256, shape, dtype=np.uint8)))
    return paths


KINDS = ("8bit", "24bit")
# (file size, decoded size): no resize, NEU-DET's 200 -> 224 upscale, a downscale
SIZES = (((64, 64), (64, 64)), ((200, 200), (224, 224)), ((50, 70), (32, 48)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sizes", SIZES, ids=lambda s: f"{s[0][0]}x{s[0][1]}-{s[1][0]}x{s[1][1]}")
@pytest.mark.parametrize("s2d", [False, True])
def test_decode_batch_equals_jax(tmp_path, kind, sizes, s2d):
    src, dst = sizes
    paths = write_bmps(tmp_path, 3, src, kind)
    got, ok = tnl.decode_batch_native(paths, dst, s2d=s2d)
    ref, ref_ok = jnl.decode_batch_native(paths, dst, s2d=s2d)
    assert ok.all() and ref_ok.all()
    np.testing.assert_array_equal(got, ref)
    if not s2d:  # the from-memory entry decodes the same bytes the same way
        for path, img in zip(paths, got):
            with open(path, "rb") as f:
                np.testing.assert_array_equal(tnl.decode_bytes_native(f.read(), dst), img)


@pytest.mark.parametrize("kind", KINDS)
def test_bmp_writer_and_resize_against_pil(tmp_path, kind):
    from PIL import Image

    paths = write_bmps(tmp_path, 2, (200, 200), kind, seed=1)
    same, _ = tnl.decode_batch_native(paths, (200, 200))
    up, _ = tnl.decode_batch_native(paths, (224, 224))
    for i, p in enumerate(paths):
        with Image.open(p) as im:
            rgb = im.convert("RGB")
            np.testing.assert_array_equal(same[i], np.asarray(rgb))
            ref = np.asarray(rgb.resize((224, 224), Image.BILINEAR))
        assert np.mean(np.abs(up[i].astype(int) - ref.astype(int))) < 2.0


def test_decode_marks_and_refuses_what_it_cannot_read(tmp_path):
    good = write_bmps(tmp_path, 1, (16, 16), "24bit")[0]
    bad = str(tmp_path / "x.png")
    with open(bad, "wb") as f:
        f.write(png_bytes(np.zeros((16, 16, 3), np.uint8)))
    _, ok = tnl.decode_batch_native([good, bad, str(tmp_path / "missing.bmp")], (16, 16))
    assert ok.tolist() == [True, False, False]
    for data in (b"", b"BM", png_bytes(np.zeros((4, 4, 3), np.uint8))):
        with pytest.raises(ValueError, match="not a BMP"):
            tnl.decode_bytes_native(data, (8, 8))


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 224, 224), (3, 10, 6), (5, 2, 2)])
def test_s2d_native_equals_numpy_and_jax(shape):
    x = np.random.default_rng(3).integers(0, 256, (*shape, 3), dtype=np.uint8)
    plain = space_to_depth_u8_plain(x)
    np.testing.assert_array_equal(tnl.s2d_batch_native(x), plain)
    np.testing.assert_array_equal(space_to_depth_u8(x), plain)
    np.testing.assert_array_equal(jnl.s2d_batch_native(x), plain)
    # a strided view goes through a contiguous copy
    np.testing.assert_array_equal(space_to_depth_u8(x[:, ::-1]), space_to_depth_u8_plain(x[:, ::-1]))


def test_s2d_native_refuses_odd_layouts():
    x = np.zeros((1, 7, 8, 3), np.uint8)
    with pytest.raises(ValueError):
        tnl.s2d_batch_native(x)
    with pytest.raises(ValueError):
        space_to_depth_u8(x)
    with pytest.raises(ValueError):
        tnl.s2d_batch_native(np.zeros((1, 8, 8, 4), np.uint8))
    # other layouts than (f=2, C=3, uint8) take the plain version
    y = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 4), dtype=np.uint8)
    np.testing.assert_array_equal(space_to_depth_u8(y), space_to_depth_u8_plain(y))


def test_library_is_keyed_on_source_flags_and_cpu(monkeypatch):
    path = tnl.lib_path()
    assert os.path.basename(path).startswith("libievmloader-")
    assert os.path.dirname(path) == tnl.BUILD_DIR  # never native/libievmloader.so
    with monkeypatch.context() as m:
        m.setattr(tnl, "_host_cpu", lambda: "another cpu")
        assert tnl.lib_path() != path
    with monkeypatch.context() as m:
        m.setattr(tnl, "CXX_FLAGS", tnl.CXX_FLAGS + ("-g",))
        assert tnl.lib_path() != path


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tnl, "_lib", None)
    monkeypatch.setattr(tnl, "BUILD_DIR", str(tmp_path))
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnl, "SOURCE", str(broken))
    with pytest.raises(RuntimeError, match="building the host decoder failed"):
        tnl.get_lib()


def neudet_tree(root):
    """A small NEU-DET layout: two classes per split, 8-bit and 24-bit BMPs
    of 200x200 and one PNG."""
    for sub, n in (("train", 3), ("validation", 2)):
        for ci, cls in enumerate(("crazing", "scratches")):
            d = os.path.join(root, sub, "images", cls)
            write_bmps(d, n, (200, 200), KINDS[ci], seed=ci + 10 * n)
    with open(os.path.join(root, "train", "images", "crazing", "z.png"), "wb") as f:
        f.write(png_bytes(np.random.default_rng(9).integers(0, 256, (200, 200, 3), np.uint8)))


def test_load_images_and_real_dataset_equal_jax(tmp_path):
    root = str(tmp_path / "NEU-DET")
    neudet_tree(root)
    kw = dict(artifacts_root=str(tmp_path / "out"), data_dir=root, synthetic_data=False,
              image_size=(64, 64))
    tcfg, jcfg = tconfig.TeacherConfig(**kw), jconfig.TeacherConfig(**kw)
    assert tneudet.build_img_paths(tcfg) == jneudet.build_img_paths(jcfg)
    got, ref = tneudet.load_dataset(tcfg), jneudet.load_dataset(jcfg)
    for split, n in (("train", 7), ("test", 4)):
        assert len(got[split][1]) == n
        for g, r in zip(got[split], ref[split]):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    paths = tneudet.build_img_paths(tcfg)["train"]["img_paths"]
    np.testing.assert_array_equal(tneudet.load_images(paths, (224, 224)),
                                  jneudet.load_images(paths, (224, 224)))


def test_non_bmp_without_pil_names_file_and_decoder(tmp_path, monkeypatch):
    png = str(tmp_path / "a.png")
    with open(png, "wb") as f:
        f.write(png_bytes(np.zeros((8, 8, 3), np.uint8)))
    monkeypatch.setitem(sys.modules, "PIL", None)  # a host without PIL
    with pytest.raises(RuntimeError, match=r"a\.png.*PIL"):
        tneudet.load_images([png], (8, 8))
