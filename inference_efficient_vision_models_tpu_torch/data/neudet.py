"""NEU-DET dataset loading, the synthetic branch of the JAX package's
``data/neudet.py:load_dataset``.

When the real dataset is absent (``<data_dir>/train/images``) and
``cfg.synthetic_data`` allows it, the deterministic surrogate of
``data/synthetic.py`` is fabricated with the same sizes and seeds as the JAX
package uses, so both packages train and test on the same arrays. Decoding
the real images (PIL or the native loader) is not ported yet (ROADMAP queue
1: real-image decode and the native loader): asking for them raises.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from .synthetic import make_synthetic_neudet, make_synthetic_neudet_hard


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
        raise NotImplementedError(
            f"reading the real NEU-DET images ({cfg.data_dir}) is not ported yet "
            f"(ROADMAP queue 1: real-image decode and the native loader); "
            f"use synthetic_data=True")
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
