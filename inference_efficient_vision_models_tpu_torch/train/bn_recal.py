"""BatchNorm running-statistics recalibration after structural surgery, the
port of the JAX package's ``train/bn_recal.py``.

Pruning changes every layer's input distribution, so the running statistics
carried over from the unpruned model are stale. The train-mode update is
linear in the batch statistics::

    new = (1 - m) * old + m * batch   =>   batch = old + (new - old) / m

so one train-mode forward per calibration batch recovers that batch's
statistics for every BN layer at once, by the same inversion the JAX
package uses (not a direct batch-statistics computation: the two differ at
fp32 rounding). The fresh running statistics are their arithmetic mean over
at most ``num_batches`` full batches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.pipeline import normalize_images
from ..models.registry import apply_model
from ..models.resnet import BN_MOMENTUM
from ..train.steps import compute_dtype_of


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def recalibrate_bn(spec, params, state, imgs_u8: np.ndarray, *, batch_size: int = 64,
                   num_batches: int = 16, momentum: float = BN_MOMENTUM,
                   compute_dtype="float32"):
    """``state`` with the BN running statistics re-estimated on ``imgs_u8``
    (uint8 NHWC train images, numpy), on the params' device; uses up to
    ``num_batches`` full batches (all images if fewer than one batch)."""
    leaves = [v for v in state.values()]
    if not leaves:
        return state
    dev = params["fc"]["w"].device
    dtype = compute_dtype_of(compute_dtype)
    n_avail = imgs_u8.shape[0] // batch_size
    k = max(min(num_batches, n_avail), 1)
    bs = batch_size if n_avail >= 1 else imgs_u8.shape[0]
    xs = torch.from_numpy(np.ascontiguousarray(imgs_u8[: k * bs])).to(dev)
    # 0-d divisors: CUDA divides by a Python scalar as a multiply by its reciprocal
    m = torch.full((), momentum, dtype=torch.float32, device=dev)
    acc = _tree_map(torch.zeros_like, state)
    with torch.no_grad():
        for i in range(k):
            _, new_state = apply_model(spec, params, state,
                                       normalize_images(xs[i * bs : (i + 1) * bs], dtype),
                                       train=True, compute_dtype=dtype)
            acc = _tree_map(lambda a, o, nw: a + (o + (nw - o) / m), acc, state, new_state)
    n = torch.full((), float(k), dtype=torch.float32, device=dev)
    return _tree_map(lambda a: a / n, acc)
