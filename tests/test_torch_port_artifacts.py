"""The port's pure-Python flax-msgpack reader and spec loading against flax
and the JAX package's own loaders."""

import json
import os

import msgpack
import numpy as np
import pytest
from flax import serialization

from inference_efficient_vision_models_tpu.core import artifacts as jart
from inference_efficient_vision_models_tpu.models import widths as jwidths
from inference_efficient_vision_models_tpu.models.registry import spec_from_dict as j_spec
from inference_efficient_vision_models_tpu_torch.core import artifacts as tart
from inference_efficient_vision_models_tpu_torch.models import widths as twidths
from inference_efficient_vision_models_tpu_torch.models.registry import spec_from_dict as t_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "artifacts", "bench")


def _assert_same_tree(got, ref, path="root"):
    assert type(got) is type(ref), (path, type(got), type(ref))
    if isinstance(ref, dict):
        assert list(got) == list(ref), path
        for k in ref:
            _assert_same_tree(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same_tree(g, r, f"{path}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert got.tobytes() == ref.tobytes(), path
    else:
        assert got == ref, path


@pytest.mark.parametrize("stage,which", [("quantization", "static_int8"), ("pruning", "best")])
def test_reader_matches_flax_on_committed_msgpacks(stage, which):
    fold_dir = os.path.join(BENCH, stage, "r2", "fold_0")
    got = tart.load_checkpoint_raw(fold_dir, which)
    ref = jart.load_checkpoint_raw(fold_dir, which)
    _assert_same_tree(got, ref)


def test_reader_covers_the_msgpack_subset():
    """Every type flax writes: maps, arrays, str, bin, ints of each width,
    floats, nil, bool, ndarray and numpy-scalar exts, and the chunked form."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    tree = {
        "ints": [0, 127, 128, 255, 65535, 2**32 - 1, 2**40, -1, -32, -33, -200, -40000,
                 -2**33],
        "floats": [1.5, 0.1], "nil": None, "yes": True, "no": False,
        "text": "é" * 40, "blob": b"\x00\x01" * 200,
        "long_list": list(range(20)), "big_map": {str(i): i for i in range(20)},
        "arrays": {"f32": arr, "i8": np.arange(-5, 5, dtype=np.int8),
                   "empty": np.zeros((0, 3), np.int32), "big": np.zeros(70000, np.uint8)},
        "scalars": {"f32": np.float32(0.25), "i32": np.int32(-7), "b": np.bool_(True)},
        "chunked": {"__msgpack_chunked_array__": True, "shape": {"0": 3, "1": 4},
                    "chunks": {"0": arr.reshape(-1)[:5], "1": arr.reshape(-1)[5:]}},
    }
    data = msgpack.packb(tree, default=serialization._msgpack_ext_pack, strict_types=True)
    got = tart.msgpack_restore(data)
    _assert_same_tree(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["chunked"], arr)


def test_reader_rejects_truncated_and_trailing_bytes():
    data = serialization.msgpack_serialize({"a": np.arange(4, dtype=np.int32)})
    with pytest.raises(ValueError):
        tart.msgpack_restore(data[:-3])
    with pytest.raises(ValueError):
        tart.msgpack_restore(data + b"\xc0")


def test_specs_match_jax():
    for name in ["resnet18", "resnet34", "resnet50", "resnext50_32x4d", "wide_resnet50_2",
                 "resnext38_16x8d", "wide_resnet26_3"]:
        got = twidths.resnet_spec(name, num_classes=6)
        ref = jwidths.resnet_spec(name, num_classes=6)
        assert got.to_dict() == ref.to_dict(), name
        for s, d in enumerate(ref.depths):
            for b in range(d):
                assert got.block_stride(s, b) == ref.block_stride(s, b)
                assert got.has_downsample(s, b) == ref.has_downsample(s, b)
    with pytest.raises(ValueError):
        twidths.resnet_spec("resnet19")
    fold = os.path.join(BENCH, "quantization", "r2", "fold_0")
    with open(os.path.join(fold, "spec.json")) as f:
        d = json.load(f)
    assert t_spec(d).to_dict() == j_spec(d).to_dict()
    pruned = os.path.join(BENCH, "pruning", "r2", "fold_0")
    assert tart.load_spec_dict(pruned, "best") == jart.load_spec_dict(pruned, "best")
    assert tart.load_spec_dict(pruned, "last") is None
    with pytest.raises(NotImplementedError):
        t_spec({"__kind__": "vit", "patch": 16})
