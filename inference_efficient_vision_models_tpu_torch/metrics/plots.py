"""Training-curve plots, the port of the JAX package's ``metrics/plots.py``:
per-fold loss/accuracy PNGs written next to the checkpoints. matplotlib is
imported only when a plot is drawn (the GPU machine has none)."""

from __future__ import annotations

import os
from typing import Dict


def plot_training_curves(fold_dir: str, history: Dict[str, list], title: str = ""):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = range(1, len(history.get("train_loss", [])) + 1)
    if not epochs:
        return None
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    axes[0].plot(epochs, history["train_loss"], label="train")
    if history.get("val_loss"):
        axes[0].plot(epochs, history["val_loss"], label="val")
    axes[0].set_xlabel("epoch")
    axes[0].set_ylabel("loss")
    axes[0].legend()
    axes[0].set_title(f"{title} loss")

    axes[1].plot(epochs, [a * 100 for a in history["train_acc"]], label="train")
    if history.get("val_acc"):
        axes[1].plot(epochs, [a * 100 for a in history["val_acc"]], label="val")
    axes[1].set_xlabel("epoch")
    axes[1].set_ylabel("accuracy (%)")
    axes[1].legend()
    axes[1].set_title(f"{title} accuracy")

    fig.tight_layout()
    os.makedirs(fold_dir, exist_ok=True)
    path = os.path.join(fold_dir, "training_curves.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
