"""Batch order and input normalization, as the JAX package's
``data/pipeline.py``.

``Batches`` gives the same static-shape batches: the order is reshuffled
per epoch from ``default_rng(seed + epoch)``, the last batch is padded to
the full size and carries a validity mask. The split lives on the device:
it is uploaded once, each epoch's index matrix in one copy, and every batch
is gathered there, so iterating never waits for the device.
"""

from __future__ import annotations

import functools
from typing import Iterator, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

# ImageNet normalization constants (reference `teacher_training/dataset.py:20`)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _norm_consts(device: torch.device):
    """255 mean and 255 std in fp32 on ``device``, made once per device, so a
    forward copies nothing from the host (a blocking copy would sync)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32) * 255.0
    return mean.to(device), std.to(device)


def normalize_images(batch_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 NHWC -> normalized float NHWC, (u - 255 mean) / (255 std) in fp32
    (a true division, as the JAX package's ``normalize_images``), then cast."""
    # a trace makes its own constants: it must not fill the cache with them
    consts = _norm_consts.__wrapped__ if torch.compiler.is_compiling() else _norm_consts
    mean, std = consts(batch_u8.device)
    return ((batch_u8.float() - mean) / std).to(dtype)


class Batches:
    """Iterate (images_u8, labels, mask) in static-shape batches on ``device``
    (the GPU unless ``device="cpu"``).

    ``mask`` is 1.0 for real samples, 0.0 for padding in the final batch.
    During training (``shuffle=True``) the padding is made of distinct real
    samples (the epoch's order from its start), so train-mode BatchNorm
    statistics see real images; the mask still zeroes their loss and
    accuracy. Otherwise the padding repeats sample 0. ``images`` (uint8
    NHWC) and ``labels`` are numpy arrays; the labels become int64."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int,
                 device: DeviceLike = None, *, shuffle: bool = False, seed: int = 0):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        dev = resolve_device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
        self.labels = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return -(-len(self.labels) // self.batch_size)

    def _plan(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> (idx int64 (batches, batch_size), mask float32 (batches,
        batch_size)) for the next epoch, and advance the epoch."""
        n, bs = len(self.labels), self.batch_size
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        idx = np.empty((len(self), bs), dtype=np.int64)
        mask = np.ones((len(self), bs), dtype=np.float32)
        for i, start in enumerate(range(0, n, bs)):
            part = order[start : start + bs]
            idx[i, : len(part)] = part
            pad = bs - len(part)
            if pad:
                mask[i, len(part):] = 0.0
                if self.shuffle and n > 1:
                    idx[i, len(part):] = np.resize(order[: max(n - len(part), 1)], pad)
                else:
                    idx[i, len(part):] = 0
        return idx, mask

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        idx, mask = self._plan()
        dev = self.images.device
        idx, mask = torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev)
        for i in range(len(idx)):
            yield self.images[idx[i]], self.labels[idx[i]], mask[i]
