"""Shared CLI orchestration for the pipeline stages, the port of the JAX
package's ``cli/common.py``.

No-flag entry points whose behavior is set by the config's ``choice`` (1 =
train, 2 = test), per-fold loops over a persisted CV split, per-fold
artifact dirs, and ``key=value`` overrides. The stages run on ``cuda``;
``IEVM_PLATFORM=cpu`` runs them on the CPU (the JAX package's switch of the
same name), and without a GPU they raise rather than fall back.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Dict, Tuple, Type

import numpy as np
import torch

from ..core import artifacts
from ..core.log import get_logger
from ..core.prng import set_seed
from ..data.neudet import load_dataset
from ..data.splits import create_fold_split_idx
from ..utils.device import resolve_device


def stage_device() -> torch.device:
    """``IEVM_PLATFORM`` (``cpu`` | ``cuda``), else ``cuda``."""
    platform = os.environ.get("IEVM_PLATFORM") or None
    if platform is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set IEVM_PLATFORM=cpu to run the "
                           "stage on the CPU")
    return resolve_device(platform)


def parse_cli_kwargs(argv=None) -> Dict:
    """['choice=1', 'DEBUG_MODE=True'] -> {'choice': 1, 'DEBUG_MODE': True}."""
    argv = argv if argv is not None else sys.argv[1:]
    out = {}
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"arguments must be key=value, got {arg!r}")
        k, v = arg.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def make_config(cfg_cls: Type, argv=None):
    return cfg_cls(**parse_cli_kwargs(argv))


def iter_folds(cfg):
    """Folds a stage run covers: ``cfg.folds`` if set (validated against the
    split arity), else all ``num_folds``; a bare int is accepted."""
    if cfg.folds is None:
        return range(cfg.num_folds)
    folds = (cfg.folds,) if isinstance(cfg.folds, int) else tuple(cfg.folds)
    bad = [f for f in folds if not 0 <= int(f) < cfg.num_folds]
    if bad:
        raise ValueError(f"folds {bad} outside the {cfg.num_folds}-fold split")
    return [int(f) for f in folds]


def setup_stage(cfg) -> Tuple:
    """Common preamble: logger, seed, dataset, persisted fold split.
    Returns (logger, root_seed, data, fold_idx_dict)."""
    from ..parallel import initialize_distributed

    # a no-op unless a launcher set multi-process coordinates (torchrun)
    initialize_distributed(device=os.environ.get("IEVM_PLATFORM") or None)
    logger = get_logger(cfg)
    logger.info("config: %r", cfg)
    root_seed = set_seed(cfg.seed)
    data = load_dataset(cfg, logger)
    split = artifacts.load_fold_split(cfg.output_dir)
    if split is None or len(split) != cfg.num_folds:
        split = create_fold_split_idx(cfg.num_folds, data["train"][1], cfg.seed)
        artifacts.save_fold_split(cfg.output_dir, split)
        logger.info("created %d-fold split", cfg.num_folds)
    else:
        logger.info("reusing persisted %d-fold split", len(split))
    return logger, root_seed, data, split


def fold_arrays(data, split, fold: int):
    """-> ((train_imgs, train_labels), (val_imgs, val_labels), (test_imgs, test_labels))."""
    imgs, labels = data["train"]
    tr = np.asarray(split[fold]["train"])
    va = np.asarray(split[fold]["val"])
    return (imgs[tr], labels[tr]), (imgs[va], labels[va]), data["test"]
