"""Artifact provenance sidecars: the port's copy of the JAX package's
``core/provenance.py``, writing the same JSON.

Every stage that writes a fold artifact also writes a ``provenance.json``
describing how it was produced: which stage/experiment, the knobs that
shaped it, the upstream artifact it was derived from (chained recursively),
and the data protocol (seed, synthetic sizes) that regenerates the exact
train/test splits it was fitted and evaluated on.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

FILENAME = "provenance.json"


def data_protocol(cfg) -> Dict[str, Any]:
    """The config fields that determine the dataset + split identity.

    A later consumer (bench.py) reconstructs the SAME held-out test split by
    feeding these back into a stage config — evaluating an artifact on a
    differently-sized synthetic split is a silent protocol mismatch (the
    r04 record evaluated the r2 artifact on a 126-image split instead of its
    actual 300-image one)."""
    return {
        "num_classes": int(cfg.num_classes),
        "num_folds": int(cfg.num_folds),
        "seed": int(cfg.seed),
        "image_size": list(cfg.image_size),
        "synthetic_data": cfg.synthetic_data,
        "synthetic_size": int(cfg.synthetic_size),
        "synthetic_variant": getattr(cfg, "synthetic_variant", "easy"),
        "synthetic_label_noise": float(getattr(cfg, "synthetic_label_noise", 0.0)),
        "data_dir": cfg.data_dir,
    }


def write_provenance(fold_dir: str, record: Dict[str, Any]) -> str:
    os.makedirs(fold_dir, exist_ok=True)
    path = os.path.join(fold_dir, FILENAME)
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=str)
    return path


def read_provenance(fold_dir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(fold_dir, FILENAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def stage_record(cfg, stage: str, fold: int, *, source_dir: str = None,
                 **knobs) -> Dict[str, Any]:
    """Build one stage's provenance record; chains the upstream artifact's
    record (if ``source_dir`` holds one) under ``"upstream"``."""
    rec: Dict[str, Any] = {
        "stage": stage,
        "experiment": cfg.experiment_name,
        "fold": int(fold),
        "data": data_protocol(cfg),
    }
    rec.update(knobs)
    if source_dir is not None:
        rec["source_dir"] = source_dir
        up = read_provenance(source_dir)
        if up is not None:
            rec["upstream"] = up
    return rec
