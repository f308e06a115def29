"""NEU-DET dataset loading, the port of the JAX package's ``data/neudet.py``.

Directory contract (the reference's scan, ``teacher_training/utils.py:79-109``):

    <data_dir>/train/images/<class_name>/*.{jpg,bmp,png}
    <data_dir>/validation/images/<class_name>/*

All images are decoded and resized once on the host into a resident uint8
NHWC array: BMPs by the native decoder (``data/native_loader.py``), other
formats by PIL, imported only when such a file is met (on a host without
PIL a non-BMP file raises an error naming it and the missing decoder).

When the real dataset is absent and ``cfg.synthetic_data`` allows it, the
deterministic surrogate of ``data/synthetic.py`` is fabricated with the same
sizes and seeds as the JAX package uses, so both packages train and test on
the same arrays.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from .native_loader import decode_batch_native
from .synthetic import make_synthetic_neudet, make_synthetic_neudet_hard

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def build_img_paths(cfg) -> Dict[str, Dict[str, list]]:
    """Scan the NEU-DET tree -> {'train'|'test': {'img_paths': [...], 'cls_ids': [...]}}."""
    data_paths = {
        "train": {"img_paths": [], "cls_ids": []},
        "test": {"img_paths": [], "cls_ids": []},
    }
    for split, sub in (("train", "train"), ("test", "validation")):
        root = os.path.join(cfg.data_dir, sub, "images")
        for dir_name in sorted(os.listdir(root)):
            cls_id = cfg.cls_name_id_map[dir_name]
            cls_dir = os.path.join(root, dir_name)
            fnames = sorted(
                f for f in os.listdir(cls_dir) if f.lower().endswith(_IMG_EXTS)
            )
            data_paths[split]["img_paths"] += [os.path.join(cls_dir, f) for f in fnames]
            data_paths[split]["cls_ids"] += [cls_id] * len(fnames)
    return data_paths


def _decode_resize(path: str, size: Tuple[int, int]) -> np.ndarray:
    """A file the native decoder does not read, by PIL (bilinear resize)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: not a BMP the native decoder reads, and PIL, the decoder for other "
            f"image formats, is not installed") from e
    with Image.open(path) as im:
        im = im.convert("RGB").resize((size[1], size[0]), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def load_images(paths: List[str], size: Tuple[int, int], num_workers: int = 8) -> np.ndarray:
    """Decode + resize all images: the native batch decoder first, PIL for
    the files it does not read."""
    out, ok = decode_batch_native(paths, size, num_threads=max(num_workers, 1) * 4)
    misses = np.flatnonzero(~ok)
    if len(misses):
        with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as ex:
            for i, arr in zip(
                misses, ex.map(lambda p: _decode_resize(p, size), [paths[i] for i in misses])
            ):
                out[i] = arr
    return out


def dataset_available(cfg) -> bool:
    return os.path.isdir(os.path.join(cfg.data_dir, "train", "images"))


def load_dataset(cfg, logger=None) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Returns {'train': (imgs_u8 NHWC, labels int32), 'test': (...)}.

    ``cfg.synthetic_data``: True | False | "auto" (synthesize when the real
    dataset is missing)."""
    size = tuple(cfg.image_size)
    use_synth = cfg.synthetic_data is True or (
        cfg.synthetic_data == "auto" and not dataset_available(cfg)
    )
    if not use_synth:
        return _load_real(cfg, size, logger)
    if logger:
        logger.info(
            "NEU-DET not found at %s — using synthetic surrogate "
            "(%d imgs/class/split)", cfg.data_dir, cfg.synthetic_size
        )
    n = max(cfg.synthetic_size // cfg.num_classes, cfg.num_folds)
    if getattr(cfg, "synthetic_variant", "easy") == "hard":
        train = make_synthetic_neudet_hard(
            n, size[0], cfg.num_classes, seed=cfg.seed,
            label_noise=getattr(cfg, "synthetic_label_noise", 0.05),
        )
        test = make_synthetic_neudet_hard(
            max(n // 2, cfg.num_folds), size[0], cfg.num_classes,
            seed=cfg.seed + 1, shift=True,
        )
        return {"train": train, "test": test}
    train = make_synthetic_neudet(n, size[0], cfg.num_classes, seed=cfg.seed)
    test = make_synthetic_neudet(
        max(n // 2, cfg.num_folds), size[0], cfg.num_classes, seed=cfg.seed + 1
    )
    return {"train": train, "test": test}


def _load_real(cfg, size, logger):
    if not dataset_available(cfg):
        raise FileNotFoundError(
            f"NEU-DET not found at {cfg.data_dir} and synthetic_data is disabled"
        )
    paths = build_img_paths(cfg)
    out = {}
    for split in ("train", "test"):
        imgs = load_images(paths[split]["img_paths"], size, cfg.num_workers)
        labels = np.asarray(paths[split]["cls_ids"], dtype=np.int32)
        out[split] = (imgs, labels)
        if logger:
            logger.info("loaded %s: %d images", split, len(labels))
    return out
