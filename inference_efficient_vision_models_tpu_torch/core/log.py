"""Experiment logging: console + per-experiment file handler (the port's
copy of the JAX package's ``core/log.py``).

Same contract as the reference's `get_logger` (`teacher_training/utils.py:140-167`):
log file lives at ``output/<exp>/<exp>.log``.
"""

from __future__ import annotations

import logging
import os
import sys


def get_logger(cfg=None, name: str = "ievm", log_dir: str | None = None) -> logging.Logger:
    if cfg is not None:
        log_dir = cfg.output_dir
        name = f"{name}.{cfg.stage_name}.{cfg.experiment_name}"

    logger = logging.getLogger(name)
    if logger.handlers:  # idempotent per (stage, experiment)
        return logger
    logger.setLevel(logging.INFO)
    logger.propagate = False

    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s", "%H:%M:%S")

    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)

    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        exp = os.path.basename(log_dir.rstrip(os.sep)) or "run"
        fh = logging.FileHandler(os.path.join(log_dir, f"{exp}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)

    return logger
