"""AdaRound: learned weight rounding for post-training quantization, the port
of the JAX package's ``compress/quant/adaround.py`` (Nagel et al., "Up or
Down? Adaptive Rounding for Post-Training Quantization", ICML 2020).

Per weight, a variable ``v`` decides whether its int8 value rounds down or
up, optimized against the fp32 folded model's own activations on the
calibration images (no labels, the weights frozen, AdamW on ``v`` only):

  w_soft = s * clip(floor(w/s) + h(v), -127, 127)
  h(v)   = clip(1.2 sigmoid(v) - 0.1, 0, 1)           (rectified sigmoid)
  loss   = mean over taps of MSE(tap_soft, tap_fp32) / scale_tap^2
           + reg_weight * sum(1 - |2 h(v) - 1|^beta)

with beta annealed from ``beta_hi`` to ``beta_lo`` over the last 80% of the
iterations. The reconstruction is per conversion tap: the fp32 forward gives
the targets (under ``torch.no_grad``), the simulated-int8 forward (soft
weights, activations fake-quantized to the frozen observer grid) is held to
them tap by tap, each term in units of that tap's quantization step.

Conversion-exactness contract: the conversions re-derive each channel's
scale (s = amax / 127.5) and re-round. Hardening therefore keeps each
channel's first argmax-|w| element at its original value, so the scale is
bit-identical, and writes every other weight onto the s-grid with |q| <= 127,
where re-rounding is the identity: the int8 weights of the conversion are
the learned rounding. Hardening runs in numpy on the host, in the JAX layout
(the first argmax in JAX's flattened order), as the JAX package hardens.

The variables live in the JAX layout (``qat.tensor_tree``); the rectified
sigmoid's clip takes JAX's edge gradient (``qat.clip_jax``) and beta is a
float32 tensor, as the JAX step receives it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...data.pipeline import Batches, normalize_images
from ...train.optim import adamw_init, adamw_update
from ...utils.device import DeviceLike, exact_fp32, resolve_device
from .observers import EPS, ObserverState, minmax_qparams_affine
from ...train.loop import StepClock
from .qat import _fq_act, _place, clip_jax, f32, numpy_tree, tap_grids, tensor_tree

__all__ = ["adaround_refine", "rectified_sigmoid", "init_v"]

_ZETA, _GAMMA = 1.1, -0.1  # the rectified sigmoid's stretch (the paper's constants)


def rectified_sigmoid(v: torch.Tensor) -> torch.Tensor:
    """h(v) in [0, 1]: the sigmoid stretched to (gamma, zeta), then clipped."""
    return clip_jax(torch.sigmoid(v) * f32(_ZETA - _GAMMA, v.device) + f32(_GAMMA, v.device),
                    0.0, 1.0)


def init_v(frac) -> np.ndarray:
    """v such that h(v) = frac (frac clipped into [0.01, 0.99])."""
    frac = np.clip(np.asarray(frac, np.float32), 0.01, 0.99)
    p = (frac - _GAMMA) / (_ZETA - _GAMMA)
    return np.log(p / (1.0 - p)).astype(np.float32)


def _weight_leaves(folded: Dict, fn) -> Dict:
    """``fn(path, w, channel_axis)`` applied to every quantizable weight leaf
    of a JAX-layout tree (4D conv HWIO: axis 3; 2D dense (in, out): axis 1),
    ``qat.fq_weights``' traversal -> the rebuilt tree."""

    def walk(node, path):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == "w" and getattr(v, "ndim", None) in (4, 2):
                out[k] = fn(path + (k,), v, 3 if v.ndim == 4 else 1)
            else:
                out[k] = walk(v, path + (k,))
        return out

    return walk(folded, ())


def _channel_scale(w: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """Per-channel symmetric int8 scale, broadcastable to ``w``
    (``observers.minmax_qparams_symmetric_per_channel``)."""
    axes = tuple(i for i in range(w.ndim) if i != channel_axis)
    return torch.clamp(w.abs().amax(dim=axes, keepdim=True) / f32(127.5, w.device), min=EPS)


def _channel_scale_np(w: np.ndarray, channel_axis: int) -> np.ndarray:
    axes = tuple(i for i in range(w.ndim) if i != channel_axis)
    amax = np.abs(w).max(axis=axes, keepdims=True)
    return np.maximum(amax / np.float32(127.5), np.float32(EPS))


def _argmax_mask(w, channel_axis: int) -> np.ndarray:
    """Boolean mask of each channel's first argmax-|w| element (JAX layout,
    numpy's flattened order): the weight hardening keeps at its value."""
    w = np.asarray(w, np.float32)
    moved = np.moveaxis(np.abs(w), channel_axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    mask = np.zeros_like(flat, dtype=bool)
    mask[np.arange(flat.shape[0]), flat.argmax(axis=1)] = True
    return np.moveaxis(mask.reshape(moved.shape), 0, channel_axis)


def adaround_refine(spec, qmod, folded: Dict, observers: Dict[str, ObserverState], calib_data,
                    *, iters: int = 300, lr: float = 1e-2, batch_size: int = 32,
                    reg_weight: float = 0.01, beta_hi: float = 20.0, beta_lo: float = 2.0,
                    logger=None, device: DeviceLike = None, step_ms: Optional[list] = None,
                    return_rounding: bool = False):
    """Learn the rounding of the folded model (JAX layout, numpy) on the
    calibration split (images uint8 NHWC, labels), on ``device`` (the GPU
    unless ``device="cpu"``) -> the hardened folded tree (float32 numpy)
    whose ``convert_static_int8`` reproduces the learned int8 grid exactly;
    ``folded`` is unchanged, the observers stay frozen. The leaves of
    ``qmod.ADAROUND_SKIP`` (transformed by the conversion before it
    quantizes) keep their values. ``step_ms`` (a list) receives each
    iteration's device ms; ``return_rounding`` also returns the learned
    integers clip(floor(w/s) + b, -127, 127) by leaf path ("a/b/w", int8)."""
    dev = resolve_device(device)
    frozen = tensor_tree(folded, dev)
    skip = set(getattr(qmod, "ADAROUND_SKIP", ()))

    # the rounding variables, one per quantizable weight; each leaf's scale
    # and floor are constants of the optimization
    v0, base = {}, {}

    def make_v(path, w, channel_axis):
        if path[0] in skip:
            return w
        s = _channel_scale(w, channel_axis)
        fl = torch.floor(w / s)
        key = "/".join(path)
        v0[key] = torch.from_numpy(init_v((w / s - fl).cpu().numpy())).to(dev)
        base[key] = (s, fl)
        return w

    _weight_leaves(frozen, make_v)

    def soft_weights(v_tree):
        def sub(path, w, channel_axis):
            key = "/".join(path)
            if key not in v_tree:
                return w
            s, fl = base[key]
            return s * clip_jax(fl + rectified_sigmoid(v_tree[key]), -127.0, 127.0)

        return _weight_leaves(frozen, sub)

    grids = tap_grids(observers, dev)
    step2 = {}  # each tap's scale squared: the JAX package's sc * sc in float64, then fp32
    for name, o in observers.items():
        sc = minmax_qparams_affine(o.min, o.max)[0]
        step2[name] = f32(sc * sc, dev)
    placed_fp32 = _place(spec, frozen, dev)
    batches = [(imgs, mask) for imgs, _labels, mask in
               Batches(calib_data[0], calib_data[1], batch_size, dev)]

    def loss_fn(v_tree, x, beta):
        targets = {}

        def capture(name, t):
            targets[name] = t
            return t

        with torch.no_grad():  # the fp32 targets at every conversion tap
            qmod.apply_folded(spec, placed_fp32, x, tap_fn=capture)

        recon = []

        def tap_fn(name, t):
            if name == "input":
                return t
            recon.append(torch.mean((t - targets[name]) ** 2) / step2[name])
            return _fq_act(t, *grids[name])

        qmod.apply_folded(spec, _place(spec, soft_weights(v_tree), dev), x, tap_fn=tap_fn)
        recon_loss = sum(recon) / f32(max(len(recon), 1), dev)
        reg = sum(torch.sum(1.0 - torch.abs(2.0 * rectified_sigmoid(v_tree[k]) - 1.0) ** beta)
                  for k in sorted(v_tree))
        return recon_loss + reg_weight * reg, recon_loss.detach()

    v = {k: a.clone() for k, a in v0.items()}
    opt = adamw_init(v)
    clock = StepClock(dev)
    leaves = list(v.values())
    for it in range(int(iters)):
        x_u8, _mask = batches[it % len(batches)]
        # anneal beta through the final 80% only (the paper: warm-up, then anneal)
        t = max(0.0, it / max(iters - 1, 1) - 0.2) / 0.8
        beta = beta_hi + (beta_lo - beta_hi) * min(t, 1.0)
        clock.start()
        with exact_fp32(), torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            total, recon = loss_fn(v, normalize_images(x_u8), f32(beta, dev))
            grads = list(torch.autograd.grad(total, leaves))
        v, opt = adamw_update(v, grads, opt, lr=lr, weight_decay=0.0)
        clock.stop()
        if logger is not None and (it + 1) % max(iters // 4, 1) == 0:
            logger.info("adaround %d/%d: recon %.6f beta %.1f", it + 1, iters, float(recon), beta)

    # harden, on the host in the JAX layout
    with torch.no_grad():
        up = {k: (rectified_sigmoid(a) > 0.5).cpu().numpy() for k, a in v.items()}
    rounding = {}

    def harden(path, w, channel_axis):
        w = np.asarray(w, np.float32)
        key = "/".join(path)
        if key not in up:
            return w
        s = _channel_scale_np(w, channel_axis)
        q = np.clip(np.floor(w / s) + up[key], -127, 127)
        rounding[key] = q.astype(np.int8)
        keep = _argmax_mask(w, channel_axis)
        return np.where(keep, w, (s * q).astype(np.float32))

    hardened = numpy_tree(_weight_leaves(folded, harden))
    if step_ms is not None:
        step_ms.extend(clock.ms())
    return (hardened, rounding) if return_rounding else hardened
