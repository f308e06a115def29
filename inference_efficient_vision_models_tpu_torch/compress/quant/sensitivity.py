"""Per-tap quantization sensitivity (the mixed-precision advisor), the port
of the JAX package's ``compress/quant/sensitivity.py``.

For every quantization point (the tap set of the static-int8 conversion),
the float forward runs with only that activation fake-quantized to its
calibrated range (``qat.fake_quant_act``), and its logit distortion against
the clean float forward is recorded:

* ``logit_rmse``: the RMS logit error over the clean logits' RMS,
* ``top1_flips``: the fraction of images whose argmax changed.

Two aggregate rows close the table: ``__weights__`` (every weight on its
per-channel int8 grid, the activations clean) and ``__all__`` (weights and
every tap: the whole static-int8 simulation).

The JAX package compiles one program with traced on/off switches
(``on * fq + (1 - on) * t``); in eager PyTorch a switch is a Python branch
per tap, which gives the same values at on = 0 and 1.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...data.pipeline import normalize_images
from ...utils.device import DeviceLike, resolve_device
from .observers import ObserverState
from .qat import _fq_act, _place, fq_weights, tap_grids, tensor_tree

__all__ = ["tap_sensitivity", "make_switch_forward"]


def make_switch_forward(spec, qmod, folded: Dict, observers: Dict[str, ObserverState], *,
                        skip_taps=("input",), device: DeviceLike = None):
    """The fake-quant forward with per-tap switches, on ``device`` (the GPU
    unless ``device="cpu"``) -> ``(fwd, names)``: ``fwd(switches, fq_w,
    x_u8)`` runs the folded float forward on uint8 images with tap ``n``
    fake-quantized to its calibrated range iff ``switches[n]``, and every
    weight on its per-channel int8 grid iff ``fq_w`` -> logits. The folded
    tree is placed once, float and fake-quantized. The engine under both the
    sensitivity sweep and the mixed-precision search (``automix``)."""
    dev = resolve_device(device)
    names = [n for n in observers if n not in skip_taps]
    grids = tap_grids({n: observers[n] for n in names}, dev)
    params = tensor_tree(folded, dev)
    with torch.no_grad():
        placed = {False: _place(spec, params, dev), True: _place(spec, fq_weights(params), dev)}

    def fwd(switches, fq_w, x_u8):
        def tap_fn(name, t):
            return _fq_act(t, *grids[name]) if name in grids and switches[name] else t

        with torch.no_grad():
            return qmod.apply_folded(spec, placed[bool(fq_w)], normalize_images(x_u8),
                                     tap_fn=tap_fn)

    return fwd, names


def eval_images(eval_data, batch_size: int, max_images: int, device) -> torch.Tensor:
    """The first whole batches of at most ``max_images`` eval images, on the device."""
    imgs = np.asarray(eval_data[0][:max_images])
    n = (len(imgs) // batch_size) * batch_size
    if n == 0:
        raise ValueError(f"need >= {batch_size} eval images, got {len(imgs)}")
    return torch.from_numpy(np.ascontiguousarray(imgs[:n])).to(device)


def run_batches(fwd, switches, fq_w, imgs: torch.Tensor, batch_size: int) -> np.ndarray:
    """``fwd`` over ``imgs`` batch by batch -> float32 logits on the host."""
    return np.concatenate([fwd(switches, fq_w, imgs[i : i + batch_size]).float().cpu().numpy()
                           for i in range(0, len(imgs), batch_size)])


def tap_sensitivity(spec, qmod, folded: Dict, observers: Dict[str, ObserverState], eval_data, *,
                    batch_size: int = 32, max_images: int = 256, skip_taps: tuple = ("input",),
                    logger=None, device: DeviceLike = None) -> List[dict]:
    """Each quantization point's isolated logit distortion, on ``device``.
    ``eval_data`` is ``(images_u8, labels)`` (the labels unused: the metric is
    the model against itself); ``skip_taps`` defaults to the ``"input"`` tap
    (the deployed stems take raw uint8 exactly). -> rows ``{"tap",
    "logit_rmse", "top1_flips"}`` sorted most-sensitive-first, then the
    ``__weights__`` and ``__all__`` rows."""
    dev = resolve_device(device)
    imgs = eval_images(eval_data, batch_size, max_images, dev)
    fwd, names = make_switch_forward(spec, qmod, folded, observers, skip_taps=skip_taps,
                                     device=dev)

    def run(switch_on: Optional[str], fq_w: bool, all_on: bool = False):
        sw = {name: all_on or name == switch_on for name in names}
        return run_batches(fwd, sw, fq_w, imgs, batch_size)

    clean = run(None, False)
    ref_rms = float(np.sqrt(np.mean(clean**2))) + 1e-12
    ref_top1 = clean.argmax(1)

    def metrics(logits):
        rmse = float(np.sqrt(np.mean((logits - clean) ** 2))) / ref_rms
        flips = float((logits.argmax(1) != ref_top1).mean())
        return rmse, flips

    def row(label, logits):
        rmse, flips = metrics(logits)
        if logger is not None:
            logger.info("sensitivity %-12s rmse %.4f flips %.3f", label, rmse, flips)
        return {"tap": label, "logit_rmse": rmse, "top1_flips": flips}

    rows = [row(name, run(name, False)) for name in names]
    rows.sort(key=lambda r: -r["logit_rmse"])
    rows.append(row("__weights__", run(None, True)))
    rows.append(row("__all__", run(None, True, all_on=True)))
    return rows
