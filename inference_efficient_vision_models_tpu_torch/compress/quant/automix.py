"""Automatic mixed-precision policy search over the quantization taps, the
port of the JAX package's ``compress/quant/automix.py``.

Picks the smallest set of activation taps to keep in float such that the
simulated static-int8 forward meets a flip budget, by a greedy prefix over
the isolated-sensitivity ranking:

1. rank every tap by its isolated logit RMSE (only that tap quantized, the
   weights float: the ``tap_sensitivity`` sweep),
2. for k = 0, 1, 2, ...: exempt the top-k taps from quantization (the
   weights stay on the int8 grid), run the switch forward over the eval
   split, record the top-1-vs-float flip rate, the logit RMSE and the
   labelled accuracy,
3. stop at the first k whose flip rate is within ``flip_budget`` (or at
   ``max_float_taps``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ...utils.device import DeviceLike, resolve_device
from .observers import ObserverState
from .sensitivity import eval_images, make_switch_forward, run_batches

__all__ = ["auto_mixed_policy"]


def auto_mixed_policy(spec, qmod, folded: Dict, observers: Dict[str, ObserverState], eval_data,
                      *, flip_budget: float = 0.01, max_float_taps: int = 8,
                      batch_size: int = 32, max_images: int = 256,
                      skip_taps: tuple = ("input",), logger=None,
                      device: DeviceLike = None) -> Tuple[List[str], List[dict]]:
    """The smallest float-tap set meeting ``flip_budget``, on ``device`` (the
    GPU unless ``device="cpu"``). ``eval_data`` is ``(images_u8, labels)``;
    the labels serve the accuracy column only (the stopping metric is the
    label-free flip rate). -> ``(float_taps, ladder)``: ``ladder[k]`` is
    ``{"k", "float_taps", "top1_flips", "logit_rmse", "acc"}`` for the
    top-k-exempt configuration, and ``float_taps`` the first rung within
    the budget (the deepest rung if none is)."""
    dev = resolve_device(device)
    imgs = eval_images(eval_data, batch_size, max_images, dev)
    labels = np.asarray(eval_data[1][: len(imgs)])
    fwd, names = make_switch_forward(spec, qmod, folded, observers, skip_taps=skip_taps,
                                     device=dev)

    def run(float_set, fq_w: bool):
        return run_batches(fwd, {name: name not in float_set for name in names}, fq_w, imgs,
                           batch_size)

    clean = run(frozenset(names), False)  # every tap float, the weights float
    ref_rms = float(np.sqrt(np.mean(clean**2))) + 1e-12
    ref_top1 = clean.argmax(1)

    # the isolated ranking: only this tap quantized, the weights float
    others = {name: frozenset(m for m in names if m != name) for name in names}
    ranking = sorted(names, key=lambda name: -float(
        np.sqrt(np.mean((run(others[name], False) - clean) ** 2))))

    ladder: List[dict] = []
    for k in range(0, min(max_float_taps, len(ranking)) + 1):
        float_set = frozenset(ranking[:k])
        logits = run(float_set, True)
        flips = float((logits.argmax(1) != ref_top1).mean())
        rmse = float(np.sqrt(np.mean((logits - clean) ** 2))) / ref_rms
        acc = float((logits.argmax(1) == labels).mean())
        ladder.append({"k": k, "float_taps": sorted(float_set), "top1_flips": flips,
                       "logit_rmse": rmse, "acc": acc})
        if logger is not None:
            logger.info("automix k=%d flips %.3f rmse %.4f acc %.4f (+%s)", k, flips, rmse, acc,
                        ranking[k - 1] if k else "-")
        if flips <= flip_budget:
            chosen = ranking[:k]
            break
    else:
        if logger is not None:
            logger.info("automix: budget %.3f not met within %d taps; returning the deepest "
                        "rung (consider qat_epochs or W8A16 instead)", flip_budget,
                        max_float_taps)
        chosen = ladder[-1]["float_taps"]
    return list(chosen), ladder
