"""The port's data and core modules against the JAX package's, on the CPU:
the synthetic surrogate and the stratified folds bit for bit, the batch
order, padding and mask, the synthetic ``load_dataset``, the stage configs,
provenance records, the checkpoint writer (byte for byte against flax) and
the split, log and result files."""

import csv
import json
import logging
import os

import numpy as np
import pytest
import torch

from inference_efficient_vision_models_tpu.core import artifacts as jart
from inference_efficient_vision_models_tpu.core import config as jconfig
from inference_efficient_vision_models_tpu.core import provenance as jprov
from inference_efficient_vision_models_tpu.data import neudet as jneudet
from inference_efficient_vision_models_tpu.data import pipeline as jpipe
from inference_efficient_vision_models_tpu.data import splits as jsplits
from inference_efficient_vision_models_tpu.data import synthetic as jsyn
from inference_efficient_vision_models_tpu.metrics.report import summarize_folds as j_summarize
from inference_efficient_vision_models_tpu.train.optim import AdamWState
from inference_efficient_vision_models_tpu_torch.core import artifacts as tart
from inference_efficient_vision_models_tpu_torch.core import config as tconfig
from inference_efficient_vision_models_tpu_torch.core import provenance as tprov
from inference_efficient_vision_models_tpu_torch.core.prng import generator_for, key_for
from inference_efficient_vision_models_tpu_torch.data import neudet as tneudet
from inference_efficient_vision_models_tpu_torch.data import pipeline as tpipe
from inference_efficient_vision_models_tpu_torch.data import splits as tsplits
from inference_efficient_vision_models_tpu_torch.data import synthetic as tsyn
from inference_efficient_vision_models_tpu_torch.metrics.report import summarize_folds

LOG = logging.getLogger("test_torch_port_data")


@pytest.mark.parametrize("n,size,classes,seed", [(3, 32, 6, 0), (2, 41, 6, 7), (1, 24, 3, 42)])
def test_synthetic_easy_bit_for_bit(n, size, classes, seed):
    got = tsyn.make_synthetic_neudet(n, size, classes, seed=seed)
    ref = jsyn.make_synthetic_neudet(n, size, classes, seed=seed)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("n,size,classes,seed,shift,noise",
                         [(3, 32, 12, 1, False, 0.1), (2, 24, 4, 3, True, 0.0),
                          (2, 30, 6, 5, False, 0.05)])
def test_synthetic_hard_bit_for_bit(n, size, classes, seed, shift, noise):
    got = tsyn.make_synthetic_neudet_hard(n, size, classes, seed=seed, shift=shift,
                                          label_noise=noise)
    ref = jsyn.make_synthetic_neudet_hard(n, size, classes, seed=seed, shift=shift,
                                          label_noise=noise)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def _label_sets():
    rng = np.random.default_rng(3)
    return {
        "balanced_60": np.repeat(np.arange(6), 10)[rng.permutation(60)],
        "imbalanced_97": rng.choice(6, 97, p=[0.4, 0.25, 0.15, 0.1, 0.06, 0.04]),
        "odd_37_sparse_ids": rng.choice(np.array([9, 2, 5]), 37),
        "sorted_23": np.sort(rng.integers(0, 4, 23)),
        "two_classes_11": rng.integers(0, 2, 11),
    }


@pytest.mark.parametrize("num_folds", [1, 2, 3, 5])
@pytest.mark.parametrize("labels", sorted(_label_sets()))
def test_fold_split_equals_sklearn(labels, num_folds):
    y = _label_sets()[labels]
    assert tsplits.create_fold_split_idx(num_folds, y, 0) == \
        jsplits.create_fold_split_idx(num_folds, y, 0)


def test_fold_split_rejects_what_sklearn_rejects():
    y = np.array([0, 0, 1, 1, 2])
    with pytest.raises(ValueError):
        jsplits.create_fold_split_idx(3, y)
    with pytest.raises(ValueError):
        tsplits.create_fold_split_idx(3, y)
    with pytest.raises(ValueError):
        tsplits.create_fold_split_idx(0, y)


@pytest.mark.parametrize("n,bs,shuffle", [(23, 8, True), (23, 8, False), (16, 8, True),
                                          (5, 8, True), (1, 4, True), (9, 4, False)])
def test_batches_order_padding_and_mask(n, bs, shuffle):
    rng = np.random.default_rng(n)
    imgs = rng.integers(0, 256, (n, 4, 4, 3), dtype=np.uint8)
    labels = rng.integers(0, 6, n)
    got = tpipe.Batches(imgs, labels, bs, "cpu", shuffle=shuffle, seed=11)
    ref = jpipe.Batches(imgs, labels, bs, shuffle=shuffle, seed=11)
    assert len(got) == len(ref)
    for _ in range(2):  # two epochs: the order is reseeded per epoch
        for g, r in zip(got, ref, strict=True):
            assert [t.dtype for t in g] == [torch.uint8, torch.int64, torch.float32]
            for a, c in zip(g, r):
                np.testing.assert_array_equal(a.numpy(), c)


def test_normalize_images_matches_jax():
    u8 = np.random.default_rng(0).integers(0, 256, (2, 5, 5, 3), dtype=np.uint8)
    got = tpipe.normalize_images(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpipe.normalize_images(u8)))


@pytest.mark.parametrize("variant", ["easy", "hard"])
def test_load_dataset_synthetic_equal(tmp_path, variant):
    kw = dict(artifacts_root=str(tmp_path), synthetic_size=36, image_size=(24, 24),
              synthetic_variant=variant, num_classes=6 if variant == "easy" else 4,
              num_folds=3, seed=5)
    got = tneudet.load_dataset(tconfig.TeacherConfig(**kw), LOG)
    ref = jneudet.load_dataset(jconfig.TeacherConfig(**kw), LOG)
    assert sorted(got) == sorted(ref) == ["test", "train"]
    for split in ("train", "test"):
        for g, r in zip(got[split], ref[split]):
            np.testing.assert_array_equal(g, r)


def test_load_dataset_real_images_not_ported(tmp_path):
    """Real images are read since the native decoder was ported: a NEU-DET
    tree is loaded as the JAX package loads it; with no tree and synthetic
    data off, both raise FileNotFoundError."""
    from chip_smoke import bmp_bytes

    for sub in ("train", "validation"):
        d = tmp_path / "nd" / sub / "images" / "patches"
        os.makedirs(d)
        (d / "a.bmp").write_bytes(bmp_bytes(np.full((20, 20), 7, np.uint8)))
    kw = dict(artifacts_root=str(tmp_path), data_dir=str(tmp_path / "nd"), image_size=(16, 16))
    got = tneudet.load_dataset(tconfig.TeacherConfig(**kw))
    ref = jneudet.load_dataset(jconfig.TeacherConfig(**kw))
    for split in ("train", "test"):
        for g, r in zip(got[split], ref[split]):
            np.testing.assert_array_equal(g, r)
    assert got["train"][1].tolist() == [2]
    kw.update(data_dir=str(tmp_path / "none"), synthetic_data=False)
    with pytest.raises(FileNotFoundError):
        tneudet.load_dataset(tconfig.TeacherConfig(**kw))


@pytest.mark.parametrize("cls", ["TeacherConfig", "KDConfig"])
@pytest.mark.parametrize("kw", [{}, {"DEBUG_MODE": True}, {"batch_size": 7, "epochs": 3,
                                                           "unknown_knob": 1, "folds": (1,)}])
def test_configs_match_jax(tmp_path, cls, kw):
    got = getattr(tconfig, cls)(artifacts_root=str(tmp_path), **kw)
    ref = getattr(jconfig, cls)(artifacts_root=str(tmp_path), **kw)
    assert vars(got) == vars(ref)
    assert got.fold_dir(2) == ref.fold_dir(2)
    assert got.stage_name == ref.stage_name
    assert repr(got) == repr(ref)


def test_provenance_records_match_jax(tmp_path):
    cfg_t = tconfig.KDConfig(artifacts_root=str(tmp_path), synthetic_size=48)
    cfg_j = jconfig.KDConfig(artifacts_root=str(tmp_path), synthetic_size=48)
    up = tmp_path / "up"
    jprov.write_provenance(str(up), {"stage": "teacher_training", "fold": 0})
    got = tprov.stage_record(cfg_t, "knowledge_distillation", 0, source_dir=str(up),
                             alpha=0.5, model_type="student")
    ref = jprov.stage_record(cfg_j, "knowledge_distillation", 0, source_dir=str(up),
                             alpha=0.5, model_type="student")
    assert got == ref
    tprov.write_provenance(str(tmp_path / "a"), got)
    jprov.write_provenance(str(tmp_path / "b"), ref)
    assert (tmp_path / "a" / "provenance.json").read_bytes() == \
        (tmp_path / "b" / "provenance.json").read_bytes()
    assert tprov.read_provenance(str(tmp_path / "a")) == ref


def test_key_for_is_deterministic_and_distinct():
    assert key_for(42, "fold", 3, "init") == key_for(42, "fold", 3, "init")
    keys = {key_for(42, "fold", f, "init") for f in range(5)}
    keys |= {key_for(42, "kd_fold", f, "init") for f in range(5)} | {key_for(43, "fold", 0)}
    assert len(keys) == 11
    a = torch.randn(4, generator=generator_for(7, "x"))
    assert torch.equal(a, torch.randn(4, generator=generator_for(7, "x")))


def _bundle(rng):
    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    # keys deliberately out of order: both writers sort them
    params = {"layer1": {"1": {"w": leaf(3, 3, 2, 4)}, "0": {"w": leaf(1, 1, 2, 4)}},
              "fc": {"w": leaf(4, 3), "b": leaf(3)}, "bn1": {"scale": leaf(4), "bias": leaf(4)}}
    state = {"bn1": {"var": leaf(4), "mean": leaf(4)}}
    return params, state


def test_checkpoint_bytes_equal_flax(tmp_path):
    """The port's writer gives the bytes the JAX package's save_checkpoint
    (flax ``to_bytes``) gives: params/state only, and with the optimizer
    state and meta a resume reads."""
    rng = np.random.default_rng(0)
    params, state = _bundle(rng)
    mu = {k: v for k, v in _bundle(rng)[0].items()}
    nu = {k: v for k, v in _bundle(rng)[0].items()}
    spec = {"name": "x", "depths": [1]}
    for which, kw_t, kw_j in [
        ("best", {}, {}),
        ("last", dict(opt={"step": np.asarray(3, np.int32), "mu": mu, "nu": nu},
                      meta={"epoch": 2, "best_acc": 0.75}),
         dict(opt=AdamWState(step=np.asarray(3, np.int32), mu=mu, nu=nu),
              meta={"epoch": 2, "best_acc": 0.75})),
    ]:
        tart.save_checkpoint(str(tmp_path / "t"), which, params, state, spec,
                             extra={"k": 1}, **kw_t)
        jart.save_checkpoint(str(tmp_path / "j"), which, params, state, spec,
                             extra={"k": 1}, **kw_j)
        for f in (f"model_{which}.msgpack", f"model_{which}.spec.json"):
            assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
        raw = tart.load_checkpoint_raw(str(tmp_path / "t"), which)
        ref = jart.load_checkpoint_raw(str(tmp_path / "t"), which)
        assert json.dumps(jax_tree_repr(raw)) == json.dumps(jax_tree_repr(ref))
    assert tart.checkpoint_exists(str(tmp_path / "t"), "last")
    assert not tart.checkpoint_exists(str(tmp_path / "t"), "other")


def jax_tree_repr(tree):
    if isinstance(tree, dict):
        return {k: jax_tree_repr(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return [str(a.dtype), list(a.shape), a.tobytes().hex()]


def test_split_log_and_results_files_match_jax(tmp_path):
    split = tsplits.create_fold_split_idx(3, np.arange(30) % 3)
    hist = {"train_loss": [1.5, np.float32(0.25)], "val_acc": [np.float64(0.5), 1.0]}
    for mod, d in ((tart, "t"), (jart, "j")):
        os.makedirs(tmp_path / d)
        mod.save_fold_split(str(tmp_path / d), split)
        mod.save_training_log(str(tmp_path / d / "fold_0"), hist)
    for f in ("fold_idx_dict.json", "fold_0/training_log.json"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    assert tart.load_fold_split(str(tmp_path / "t")) == jart.load_fold_split(str(tmp_path / "j"))
    assert tart.load_training_log(str(tmp_path / "t" / "fold_0")) == \
        jart.load_training_log(str(tmp_path / "j" / "fold_0"))
    assert tart.load_fold_split(str(tmp_path / "none")) is None

    rows = [{"fold": 0, "test_loss": 0.1234567891234, "test_acc": 0.5},
            {"fold": 1, "test_loss": 2.0, "test_acc": 1.0}]
    summarize_folds(rows, str(tmp_path / "t"), LOG, name="r")
    j_summarize(rows, str(tmp_path / "j"), LOG, name="r")
    with open(tmp_path / "t" / "r.csv") as f1, open(tmp_path / "j" / "r.csv") as f2:
        assert list(csv.reader(f1)) == list(csv.reader(f2))
