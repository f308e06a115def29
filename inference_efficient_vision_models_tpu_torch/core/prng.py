"""Seed discipline: one root seed per experiment, and a named, deterministic
derivation for every consumer.

The JAX package folds a crc32 of each name into a ``jax.random`` key; the
port keeps that idea with integer seeds and ``torch.Generator``s. The
numbers drawn differ from ``jax.random``'s: tests that compare the two
packages carry weights across instead.
"""

from __future__ import annotations

import random
import zlib

import numpy as np
import torch


def set_seed(seed: int = 42) -> int:
    """Seed the host RNGs (numpy drives data shuffling) and torch's default
    generators; return the root seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return int(seed)


def key_for(root: int, *names) -> int:
    """A 32-bit seed derived from ``root`` and a path of names/ints:
    ``key_for(root, "fold", 3, "init")`` is always the same number."""
    key = int(root) & 0xFFFFFFFF
    for name in names:
        if isinstance(name, str):
            name = zlib.crc32(name.encode())
        key = zlib.crc32((int(name) & 0x7FFFFFFF).to_bytes(4, "little"), key)
    return key


def generator_for(root: int, *names, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``key_for(root, *names)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key_for(root, *names))
    return gen
