"""Structured pruning of a Vision Transformer: MLP hidden units and whole
attention heads, the port of the JAX package's
``compress/prune/vit_engine.py``.

* **MLP hidden units**, one group per block: mlp1's output columns and
  bias, mlp2's input rows.
* **Attention heads**, whole heads per block: a head owns an ``hd``-wide
  column slice in each of the q, k and v segments of the fused qkv weight
  (its ``(d, 3, H, hd)`` view, the 3-axis outermost) and the matching rows
  of proj (its ``(H, hd, d)`` view). A head's importance is the L1 or L2
  norm over those parameters.
* The embedding dim is not pruned: the residual stream couples every block,
  the patch embed, the position embeddings and the LayerNorms.

Selection and surgery are numpy on the JAX-layout trees, as the JAX package
runs them on the host, so the kept indices and the sliced leaves equal the
JAX package's. ``round_to`` aligns the MLP groups only (a head is already
``hd`` wide).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np

from ...models.vit import ViTSpec

GroupKey = Tuple


def _keep_count(width: int, ratio: float, round_to: int) -> int:
    n_prune = int(ratio * width)
    keep = width - n_prune
    if round_to > 1:
        keep = int(round(keep / round_to)) * round_to
    return int(min(max(keep, min(round_to, width), 1), width))


def _head_importance(blk, heads: int, hd: int, p: int) -> np.ndarray:
    """p-norm of each head's qkv columns and proj rows."""
    qkv_w = np.asarray(blk["qkv"]["w"], np.float64)  # (d, 3 H hd)
    per_head = qkv_w.reshape(qkv_w.shape[0], 3, heads, hd)
    proj_w = np.asarray(blk["proj"]["w"], np.float64).reshape(heads, hd, -1)
    score = np.zeros(heads)
    for h in range(heads):
        chunk = np.concatenate([per_head[:, :, h, :].ravel(), proj_w[h].ravel()])
        score[h] = np.abs(chunk).sum() if p == 1 else np.sqrt((chunk**2).sum())
    return score


def _mlp_importance(blk, p: int) -> np.ndarray:
    """Each hidden unit's mean-normalized norm over mlp1's column and mlp2's
    row, averaged."""
    w1 = np.asarray(blk["mlp1"]["w"], np.float64)  # (d, hidden)
    w2 = np.asarray(blk["mlp2"]["w"], np.float64)  # (hidden, d)
    v1 = np.abs(w1).sum(0) if p == 1 else np.sqrt((w1**2).sum(0))
    v2 = np.abs(w2).sum(1) if p == 1 else np.sqrt((w2**2).sum(1))
    v1 = v1 / (v1.mean() + 1e-12)
    v2 = v2 / (v2.mean() + 1e-12)
    return (v1 + v2) / 2


def select_vit_channels(spec: ViTSpec, params, *, ratio: float, method: str = "l2",
                        round_to: int = 1, prune_heads: bool = True,
                        rng: Optional[np.random.Generator] = None
                        ) -> Dict[GroupKey, np.ndarray]:
    """-> {("mlp", i): kept hidden units, ("heads", i): kept heads}, sorted;
    ``random`` draws from ``rng`` block by block, MLP before heads."""
    if method not in ("l1", "l2", "random"):
        raise ValueError(f"vit pruning supports l1/l2/random, got {method!r}")
    if method == "random" and rng is None:
        raise ValueError("random pruning needs an rng")
    p = 1 if method == "l1" else 2
    hd = spec.head_dim
    keep: Dict[GroupKey, np.ndarray] = {}
    for i in range(spec.depth):
        blk = params["blocks"][str(i)]
        hidden = np.asarray(blk["mlp1"]["w"]).shape[1]
        s_mlp = rng.random(hidden) if method == "random" else _mlp_importance(blk, p)
        keep[("mlp", i)] = np.sort(np.argsort(-s_mlp)[:_keep_count(hidden, ratio, round_to)])
        if prune_heads:
            heads = np.asarray(blk["qkv"]["w"]).shape[1] // (3 * hd)
            s_h = rng.random(heads) if method == "random" else _head_importance(blk, heads, hd, p)
            nh = max(heads - int(ratio * heads), 1)
            keep[("heads", i)] = np.sort(np.argsort(-s_h)[:nh])
    return keep


def apply_vit_pruning(spec: ViTSpec, params, keep: Dict[GroupKey, np.ndarray]
                      ) -> Tuple[ViTSpec, dict]:
    """Slice the MLP units and whole heads out of a copy of the JAX-layout
    numpy tree -> (the smaller spec, its params)."""
    params = copy.deepcopy(params)
    hd = spec.head_dim
    mlp_hidden = [spec.block_mlp_hidden(i) for i in range(spec.depth)]
    head_counts = [spec.block_heads(i) for i in range(spec.depth)]
    for i in range(spec.depth):
        blk = params["blocks"][str(i)]
        if ("mlp", i) in keep:
            idx = np.asarray(keep[("mlp", i)])
            blk["mlp1"]["w"] = np.take(np.asarray(blk["mlp1"]["w"]), idx, axis=1)
            blk["mlp1"]["b"] = np.take(np.asarray(blk["mlp1"]["b"]), idx, axis=0)
            blk["mlp2"]["w"] = np.take(np.asarray(blk["mlp2"]["w"]), idx, axis=0)
            mlp_hidden[i] = len(idx)
        if ("heads", i) in keep:
            hidx = np.asarray(keep[("heads", i)])
            w = np.asarray(blk["qkv"]["w"])
            d_in, heads = w.shape[0], w.shape[1] // (3 * hd)
            # qkv columns (d, 3, H, hd): the heads on axis 2; proj rows (H, hd, d): axis 0
            blk["qkv"]["w"] = np.take(w.reshape(d_in, 3, heads, hd), hidx, axis=2).reshape(d_in, -1)
            b = np.asarray(blk["qkv"]["b"]).reshape(3, heads, hd)
            blk["qkv"]["b"] = np.take(b, hidx, axis=1).reshape(-1)
            pw = np.asarray(blk["proj"]["w"]).reshape(heads, hd, -1)
            blk["proj"]["w"] = np.take(pw, hidx, axis=0).reshape(len(hidx) * hd, -1)
            head_counts[i] = len(hidx)
    return spec.with_widths(head_counts=head_counts, mlp_hidden=mlp_hidden), params


def prune_vit(spec: ViTSpec, params, state, *, ratio: float, method: str = "l2",
              round_to: int = 1, prune_heads: bool = True, seed: int = 42,
              keep: Optional[Dict[GroupKey, np.ndarray]] = None
              ) -> Tuple[ViTSpec, dict, dict]:
    """One-shot structured ViT pruning of JAX-layout numpy trees (the surface
    of ``engine.prune_model``); ``random`` draws from ``default_rng(seed)``."""
    if keep is None:
        keep = select_vit_channels(spec, params, ratio=ratio, method=method, round_to=round_to,
                                   prune_heads=prune_heads, rng=np.random.default_rng(seed))
    new_spec, new_params = apply_vit_pruning(spec, params, keep)
    return new_spec, new_params, state
