"""Synthetic NEU-DET-shaped dataset: the port's copy of the JAX package's
``data/synthetic.py`` (pure numpy, so images and labels are the same bit for
bit).

NEU-DET (6 steel-surface defect classes, 200x200 grayscale) is not in the
repository, so the pipeline fabricates a deterministic, learnable surrogate
with the same shape contract: 6 visually distinct texture classes rendered
as grayscale RGB (``make_synthetic_neudet``), or the harder fine-grained
variant with a train/test shift and label noise
(``make_synthetic_neudet_hard``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _texture(cls: int, size: int, rng: np.random.Generator) -> np.ndarray:
    """One 2-D grayscale texture in [0,1] for class ``cls``."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi)
    freq = rng.uniform(0.15, 0.25)
    base = rng.uniform(0.35, 0.65)
    img = np.full((size, size), base)

    if cls == 0:  # "crazing": fine diagonal cracks
        img += 0.25 * np.sin(freq * (xx + yy) + phase)
        img += 0.15 * np.sin(3.1 * freq * (xx - yy) + phase)
    elif cls == 1:  # "inclusion": dark elongated blobs
        for _ in range(rng.integers(2, 5)):
            cy, cx = rng.integers(0, size, 2)
            h = rng.integers(size // 10 + 1, size // 3 + 2)
            w = rng.integers(1, max(size // 12, 2))
            img[max(cy - h, 0) : cy + h, max(cx - w, 0) : cx + w] -= 0.35
    elif cls == 2:  # "patches": large irregular light patches
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.integers(0, size, 2)
            r = rng.integers(size // 6 + 1, size // 3 + 2)
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r**2
            img[mask] += 0.3
    elif cls == 3:  # "pitted_surface": dense small dark pits
        n_pits = rng.integers(40, 80)
        cys, cxs = rng.integers(0, size, (2, n_pits))
        rs = rng.integers(1, 4, n_pits)
        for cy, cx, r in zip(cys, cxs, rs):
            img[max(cy - r, 0) : cy + r, max(cx - r, 0) : cx + r] -= 0.4
    elif cls == 4:  # "rolled-in_scale": horizontal banding
        img += 0.3 * np.sin(2 * np.pi * freq * yy / 3 + phase)
    else:  # "scratches": thin bright straight lines
        for _ in range(rng.integers(1, 4)):
            x0 = rng.integers(0, size)
            slope = rng.uniform(-0.3, 0.3)
            xs = (x0 + slope * np.arange(size)).astype(int) % size
            img[np.arange(size), xs] += 0.5
            img[np.arange(size), (xs + 1) % size] += 0.4

    img += rng.normal(0, 0.06, (size, size))
    return np.clip(img, 0.0, 1.0)


def make_synthetic_neudet(
    num_per_class: int,
    image_size: int = 224,
    num_classes: int = 6,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns ``(images_u8 [N,H,W,3], labels [N])``, shuffled."""
    rng = np.random.default_rng(seed)
    n = num_per_class * num_classes
    imgs = np.empty((n, image_size, image_size, 3), dtype=np.uint8)
    labels = np.empty((n,), dtype=np.int32)
    i = 0
    for cls in range(num_classes):
        for _ in range(num_per_class):
            g = (_texture(cls, image_size, rng) * 255).astype(np.uint8)
            imgs[i] = g[..., None]  # grayscale replicated to 3 channels
            labels[i] = cls
            i += 1
    perm = rng.permutation(n)
    return imgs[perm], labels[perm]


# ---------------------------------------------------------------------------
# hard (discriminative) surrogate
# ---------------------------------------------------------------------------
#
# The easy surrogate saturates: at prune ratio 0.30 even RANDOM channel
# selection recovers to ~98% after one fine-tune epoch, so compression A/Bs
# (criteria ranking, observer choice, QAT-vs-AdaRound) cannot separate.
# This task is built to sit near the capacity frontier instead:
#
# * fine-grained classes: class k = (orientation o = k mod NO, frequency
#   band b = k // NO) of a dominant grating; orientations are spaced
#   π/NO apart with ±π/(3·NO) jitter — classes OVERLAP in appearance and
#   discrimination requires precise orientation/frequency estimation,
# * shared nuisance structure: every image carries a random-orientation
#   distractor grating, an illumination gradient, contrast jitter, and
#   occluding blobs — memorizable shortcuts that do not transfer,
# * train→test distribution shift: the test split uses higher pixel noise
#   and a shifted illumination range, penalizing memorization,
# * deterministic label noise on the train split (default 5%) to create an
#   overfitting penalty that fine-tuning can amplify.
#
# Everything is deterministic from (seed, split): the held-out split a
# committed artifact was evaluated on regenerates bit-identically.


def _hard_texture(
    cls: int, size: int, num_classes: int, rng: np.random.Generator, *, shift: bool
) -> np.ndarray:
    n_orient = max(num_classes // 2, 1)
    orient, band = cls % n_orient, cls // n_orient
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")

    theta = np.pi * orient / n_orient + rng.uniform(-np.pi / (3 * n_orient),
                                                    np.pi / (3 * n_orient))
    freq = rng.uniform(0.11, 0.15) if band == 0 else rng.uniform(0.21, 0.27)
    phase = rng.uniform(0, 2 * np.pi)
    u = xx * np.cos(theta) + yy * np.sin(theta)
    img = np.full((size, size), rng.uniform(0.40, 0.60))
    img += 0.18 * np.sin(freq * u + phase)

    # distractor grating at a random orientation/frequency (class-agnostic)
    theta_d = rng.uniform(0, np.pi)
    freq_d = rng.uniform(0.08, 0.30)
    ud = xx * np.cos(theta_d) + yy * np.sin(theta_d)
    img += 0.12 * np.sin(freq_d * ud + rng.uniform(0, 2 * np.pi))

    # illumination gradient (range shifted on the test split)
    lo, hi = (0.25, 0.45) if shift else (0.10, 0.30)
    ga = rng.uniform(lo, hi) * rng.choice([-1.0, 1.0])
    gb = rng.uniform(lo, hi) * rng.choice([-1.0, 1.0])
    img += ga * (xx / size - 0.5) + gb * (yy / size - 0.5)

    # occluding blobs, class-agnostic
    for _ in range(rng.integers(1, 4)):
        cy, cx = rng.integers(0, size, 2)
        r = rng.integers(size // 12 + 1, size // 6 + 2)
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r**2
        img[mask] += rng.uniform(-0.25, 0.25)

    img = 0.5 + rng.uniform(0.6, 1.3) * (img - 0.5)  # contrast jitter
    img += rng.normal(0, 0.13 if shift else 0.09, (size, size))
    return np.clip(img, 0.0, 1.0)


def make_synthetic_neudet_hard(
    num_per_class: int,
    image_size: int = 224,
    num_classes: int = 12,
    seed: int = 0,
    *,
    shift: bool = False,
    label_noise: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Discriminative surrogate; ``shift=True`` for the held-out split,
    ``label_noise`` fraction of deterministically flipped labels (train)."""
    rng = np.random.default_rng(seed)
    n = num_per_class * num_classes
    imgs = np.empty((n, image_size, image_size, 3), dtype=np.uint8)
    labels = np.empty((n,), dtype=np.int32)
    i = 0
    for cls in range(num_classes):
        for _ in range(num_per_class):
            g = (_hard_texture(cls, image_size, num_classes, rng, shift=shift) * 255)
            imgs[i] = g.astype(np.uint8)[..., None]
            labels[i] = cls
            i += 1
    if label_noise > 0:
        n_flip = int(round(label_noise * n))
        flip = rng.choice(n, size=n_flip, replace=False)
        labels[flip] = (labels[flip] + rng.integers(1, num_classes, n_flip)) % num_classes
    perm = rng.permutation(n)
    return imgs[perm], labels[perm]
