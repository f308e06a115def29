"""AdamW and learning-rate schedules, the port of the JAX package's
``train/optim.py``.

torch-default hyperparameters: β = (0.9, 0.999), eps 1e-8, decoupled weight
decay 0.01 applied to every leaf (BN scale and bias and the fc bias too),
before the Adam step. The state is ``AdamWState(step, mu, nu)``: ``step``
a Python int (the bias corrections are computed on the host, so an update
needs no device sync), the moments fp32 trees shaped like the params. The
update runs in place on lists of tensors (``torch._foreach_*``: a few
launches for the whole model instead of a dozen per leaf).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple

import numpy as np
import torch


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_like(tree, leaves: List[torch.Tensor]):
    """``leaves`` (in ``tree_leaves(tree)`` order) arranged as ``tree``."""
    it = iter(leaves)

    def fill(t):
        return {k: fill(v) for k, v in t.items()} if isinstance(t, dict) else next(it)

    out = fill(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_zeros_like(tree):
    if isinstance(tree, dict):
        return {k: tree_zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree, dtype=torch.float32)


def adamw_init(params) -> AdamWState:
    return AdamWState(step=0, mu=tree_zeros_like(params), nu=tree_zeros_like(params))


def adamw_update(params, grads: List[torch.Tensor], opt: AdamWState, *, lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01):
    """One AdamW step, in place on ``params`` and the moments: ``grads`` are
    in ``tree_leaves(params)`` order. Returns (params, new AdamWState)."""
    step = opt.step + 1
    t = np.float32(step)  # the JAX package computes the corrections in fp32
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
    p, m, v = tree_leaves(params), tree_leaves(opt.mu), tree_leaves(opt.nu)
    g = [x.float() for x in grads]
    with torch.no_grad():
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(p, p, alpha=-lr * weight_decay)  # decoupled decay
        torch._foreach_add_(p, upd, alpha=-lr)
    return params, AdamWState(step=step, mu=opt.mu, nu=opt.nu)


def make_lr_schedule(kind: str, base_lr: float, total_steps: int, *, warmup_steps: int = 0,
                     min_fraction: float = 0.0) -> Callable[[int], float]:
    """-> ``fn(step) -> lr``.

    'constant'       — the reference's behavior (no scheduler).
    'cosine'         — cosine decay base_lr -> min_fraction·base_lr.
    'warmup_cosine'  — linear warmup over ``warmup_steps`` then cosine."""
    if kind == "constant":
        return lambda step: float(base_lr)
    if kind not in ("cosine", "warmup_cosine"):
        raise ValueError(f"unknown lr_schedule {kind!r}")
    warmup = warmup_steps if kind == "warmup_cosine" else 0
    decay_steps = max(total_steps - warmup, 1)

    def fn(step: int) -> float:
        if step < warmup:
            return step / max(warmup, 1) * base_lr
        prog = min(max((step - warmup) / decay_steps, 0.0), 1.0)
        return (min_fraction + (1.0 - min_fraction) * 0.5 * (1.0 + math.cos(math.pi * prog))) \
            * base_lr

    return fn


def opt_to_jax(opt: AdamWState, to_jax: Callable) -> Dict[str, Any]:
    """The checkpoint form of the state: ``{step, mu, nu}`` with an int32
    step and the moments in the JAX layout."""
    return {"step": np.asarray(opt.step, np.int32), "mu": to_jax(opt.mu), "nu": to_jax(opt.nu)}
