"""Quantization-aware fine-tuning (QAT) on the folded model, the port of the
JAX package's ``compress/quant/qat.py``.

After calibration, the folded fp32 model is fine-tuned against its int8
forward simulated in fp32: every activation tap fake-quantized to its frozen
observer range, every weight fake-quantized per channel (symmetric int8), with
straight-through-estimator gradients ``x + (deq - x).detach()``. The result
goes through the ordinary ``convert_static_int8`` with the same observers, so
the deployed int8 model is the one that was trained against.
``w4_qat_finetune`` does the same for the weight-only methods: the weights
see the int4 group grid (or the per-channel int8 one), the activations stay
float.

The trained tree is the folded tree in the JAX layout (HWIO convs, (in, out)
dense), as fp32 tensors on the device, so the fake-quant ops see the axes and
int4 groups that the conversions quantize; each forward places it in the
layout the family's ``apply_folded`` takes (``_place``), differentiably.
A step is one autograd step: normalize, the fake-quant forward, the masked
cross entropy, AdamW with no weight decay. fp32 runs with TF32 off, backward
included. The ``"input"`` tap is not fake-quantized by default: the
deployed stems fold the normalization and take raw uint8 exactly.

The clip of the fake quantizers takes JAX's gradient at its edges (1/2:
``jnp.clip`` is a max then a min, and a tie of ``jnp.maximum`` or
``jnp.minimum`` splits its gradient), not ``torch.clamp``'s (1): a ReLU tap's
window starts at 0 exactly, where many values lie.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...data.pipeline import Batches, normalize_images
from ...models.vit import ViTSpec
from ...train.loop import StepClock
from ...train.losses import cross_entropy
from ...train.optim import adamw_init, adamw_update, tree_leaves
from ...utils.device import DeviceLike, exact_fp32, resolve_device
from . import qresnet, qvit
from .observers import EPS, ObserverState, minmax_qparams_affine
from .wo4 import _keep_int8_auto, _pick_group

__all__ = [
    "clip_jax",
    "act_hook",
    "fake_quant_act",
    "fake_quant_weight",
    "fake_quant_weight_int4",
    "fq_weights",
    "fq_weights_w4",
    "fq_loss_and_grads",
    "qat_finetune",
    "w4_qat_finetune",
]


class _ClipJax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = ((x > ctx.lo) & (x < ctx.hi)).to(g.dtype)
        edge = ((x == ctx.lo) | (x == ctx.hi)).to(g.dtype)
        return g * (inside + 0.5 * edge), None, None


def clip_jax(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``torch.clamp(x, lo, hi)`` with ``jnp.clip``'s gradient: 1 inside the
    window, 1/2 on either edge, 0 outside (``lo < hi``, both exact in fp32)."""
    return _ClipJax.apply(x, lo, hi)


def f32(v: float, device) -> torch.Tensor:
    """A 0-d fp32 tensor of ``v`` on ``device``: dividing by it is a true
    division on the GPU too (a Python divisor there is a multiply by its
    reciprocal), as the JAX code divides by a weakly typed scalar."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32, device=device)


def _grid(scale: float, zp: int, device) -> tuple:
    """(lo, hi, scale as a 0-d tensor on ``device``) of a quint8 window."""
    lo, hi = (float(np.float32((q - zp) * scale)) for q in (0, 255))
    return lo, hi, f32(scale, device)


def _fq_act(x: torch.Tensor, lo: float, hi: float, s: torch.Tensor) -> torch.Tensor:
    xc = clip_jax(x, lo, hi)
    deq = torch.round(xc / s) * s
    return xc + (deq - xc).detach()


def fake_quant_act(x: torch.Tensor, scale: float, zp: int) -> torch.Tensor:
    """Simulated quint8 affine quantization with an STE gradient: clip to the
    representable window, round to the grid; the gradient is the clip's
    (``clip_jax``)."""
    return _fq_act(x, *_grid(scale, zp, x.device))


def tap_grids(observers: Dict[str, ObserverState], device) -> Dict[str, tuple]:
    """Each tap's quint8 window from its observer (``_fq_act``'s arguments)."""
    return {name: _grid(*minmax_qparams_affine(o.min, o.max), device)
            for name, o in observers.items()}


def act_hook(observers: Dict[str, ObserverState], device, fq_input: bool = False):
    """QAT's ``tap_fn``: every tap fake-quantized to its frozen observer's
    grid, the ``"input"`` tap only with ``fq_input``."""
    grids = tap_grids(observers, device)

    def tap_fn(name, t):
        if name == "input" and not fq_input:
            return t
        return _fq_act(t, *grids[name])

    return tap_fn


def fake_quant_weight(w: torch.Tensor, channel_axis: int) -> torch.Tensor:
    """Simulated qint8 symmetric per-channel weight quantization (STE), the
    scales recomputed from the live weights (``observers
    .quantize_weight_per_channel``'s 127.5 divisor, round half to even)."""
    with torch.no_grad():
        axes = tuple(i for i in range(w.ndim) if i != channel_axis)
        amax = w.abs().amax(dim=axes, keepdim=True)
        scale = torch.clamp(amax / f32(127.5, w.device), min=EPS)
        deq = torch.clamp(torch.round(w / scale), -128, 127) * scale
    return w + (deq - w).detach()


def fake_quant_weight_int4(w: torch.Tensor) -> torch.Tensor:
    """Simulated group-wise symmetric int4 weight quantization (STE) of a
    JAX-layout weight (output channels last): the flattened reduction axis in
    ``wo4._pick_group``'s groups, scales max|w| / 7 per (group, output
    channel), values in [-7, 7], as ``wo4.quantize_weight_int4`` converts."""
    out = w.shape[-1]
    r = int(np.prod(w.shape[:-1]))
    g = _pick_group(r)
    with torch.no_grad():
        wg = w.reshape(r // g, g, out)
        s = torch.clamp(wg.abs().amax(dim=1, keepdim=True) / f32(7.0, w.device), min=1e-12)
        deq = (torch.clamp(torch.round(wg / s), -7, 7) * s).reshape(w.shape)
    return w + (deq - w).detach()


def fq_weights(folded: Dict) -> Dict:
    """Every weight leaf of a JAX-layout folded tree fake-quantized
    (differentiable): 4D conv kernels (HWIO, the depthwise ones too) per
    output channel on axis 3, 2D dense matrices ((in, out)) on axis 1; biases
    and vectors pass through."""

    def fq_node(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == "w" and isinstance(v, torch.Tensor) and v.ndim in (4, 2):
                out[k] = fake_quant_weight(v, 3 if v.ndim == 4 else 1)
            else:
                out[k] = fq_node(v)
        return out

    return fq_node(folded)


def fq_weights_w4(folded: Dict, keep_int8=None) -> Dict:
    """Weight leaves fake-quantized onto the W4A16 grid, the walk of
    ``wo4.convert_weight_only_int4``: the int4 group grid, or the per-channel
    int8 one for an odd output count and the leaves ``keep_int8`` (default
    ``wo4._keep_int8_auto``) keeps int8."""
    keep_int8 = _keep_int8_auto if keep_int8 is None else keep_int8

    def walk(node, path=()):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == "w" and isinstance(v, torch.Tensor) and v.ndim >= 2:
                if v.shape[-1] % 2 != 0 or keep_int8(path + (k,), v):
                    out[k] = fake_quant_weight(v, v.ndim - 1)
                else:
                    out[k] = fake_quant_weight_int4(v)
            else:
                out[k] = walk(v, path + (k,))
        return out

    return walk(folded)


# --------------------------------------------------------------------------
# the training loops
# --------------------------------------------------------------------------


def tensor_tree(folded: Dict, device) -> Dict:
    """A JAX-layout tree -> fresh fp32 tensors on ``device``, the layout kept."""
    if isinstance(folded, dict):
        return {k: tensor_tree(v, device) for k, v in folded.items()}
    t = folded if isinstance(folded, torch.Tensor) else torch.from_numpy(np.array(folded))
    return t.detach().to(device=device, dtype=torch.float32, copy=True)


def numpy_tree(tree: Dict) -> Dict:
    """A tree of tensors or arrays -> float32 numpy arrays on the host (the
    JAX package's return)."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return np.asarray(tree, np.float32)


def _place(spec, tree: Dict, device) -> Dict:
    """A JAX-layout tree of device tensors -> the tree ``apply_folded`` takes
    (the CNNs' kernels OIHW), as differentiable views and copies."""
    mod = qvit if isinstance(spec, ViTSpec) else qresnet
    return mod.place_folded(tree, device)


def fq_loss_and_grads(spec, qmod, params: Dict, batch, fq, tap_fn=None):
    """One step's forward and backward: normalize, ``apply_folded`` on the
    fake-quantized weights ``fq(params)`` with ``tap_fn``, the masked cross
    entropy -> (loss, logits, grads in ``tree_leaves(params)`` order).
    ``params`` is the JAX-layout fp32 tree on the device."""
    imgs_u8, labels, mask = batch
    with exact_fp32(), torch.enable_grad():
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        placed = _place(spec, fq(params), imgs_u8.device)
        logits = qmod.apply_folded(spec, placed, normalize_images(imgs_u8), tap_fn=tap_fn)
        loss = cross_entropy(logits, labels, mask)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return loss.detach(), logits.detach(), grads


def _finetune(spec, qmod, folded, train_data, fq, tap_fn, *, epochs, lr, batch_size, debug,
              device, step_ms, log):
    dev = resolve_device(device)
    params = tensor_tree(folded, dev)
    opt = adamw_init(params)
    clock = StepClock(dev)
    for epoch in range(int(epochs)):
        loader = Batches(train_data[0], train_data[1], batch_size, dev, shuffle=True,
                         seed=epoch)
        loss = None
        for i, batch in enumerate(loader):
            if debug and i == 2:
                break
            clock.start()
            loss, _, grads = fq_loss_and_grads(spec, qmod, params, batch, fq, tap_fn)
            # a repair pass, not training: no weight decay (it would fight the
            # frozen activation grid), a small constant lr
            params, opt = adamw_update(params, grads, opt, lr=lr, weight_decay=0.0)
            clock.stop()
        if log is not None and loss is not None:
            log(epoch, float(loss))
    out = numpy_tree(params)
    if step_ms is not None:
        step_ms.extend(clock.ms())
    return out


def qat_finetune(spec, qmod, folded: Dict, observers: Dict[str, ObserverState], train_data, *,
                 epochs: int = 1, lr: float = 1e-5, batch_size: int = 32, fq_input: bool = False,
                 logger=None, debug: bool = False, device: DeviceLike = None,
                 step_ms: Optional[list] = None) -> Dict:
    """Fine-tune the folded model (JAX layout, numpy) against the simulated
    int8 forward on ``device`` (the GPU unless ``device="cpu"``): ``epochs``
    over ``train_data`` (images uint8 NHWC, labels) shuffled by epoch,
    DEBUG's two batches with ``debug``. -> a new folded tree (float32 numpy,
    the same structure), ready for ``convert_static_int8`` with the same
    ``observers``. ``step_ms`` (a list) receives each step's device ms."""
    dev = resolve_device(device)

    def log(epoch, loss):
        if logger is not None:
            logger.info("QAT epoch %d/%d: loss %.4f", epoch + 1, epochs, loss)

    return _finetune(spec, qmod, folded, train_data, fq_weights,
                     act_hook(observers, dev, fq_input), epochs=epochs, lr=lr,
                     batch_size=batch_size, debug=debug, device=dev, step_ms=step_ms, log=log)


def w4_qat_finetune(spec, qmod, folded: Dict, train_data, *, epochs: int = 1, lr: float = 1e-5,
                    batch_size: int = 32, keep_int8=None, bits: int = 4, logger=None,
                    debug: bool = False, device: DeviceLike = None,
                    step_ms: Optional[list] = None) -> Dict:
    """Fine-tune the folded model against the simulated weight-only forward:
    no activation fake-quant (W4A16 / W8A16 compute in bf16), the weights on
    the grid they will be rounded onto: ``bits=4`` the int4 groups and the
    int8 fallback policy (``fq_weights_w4``, for ``wo4
    .convert_weight_only_int4`` with the same ``keep_int8``), ``bits=8`` the
    per-channel int8 grid (``fq_weights``, for ``wo8.convert_weight_only``).
    -> a new folded tree (float32 numpy)."""
    if bits == 4:
        def fq(f):
            return fq_weights_w4(f, keep_int8)
    elif bits == 8:
        fq = fq_weights
    else:
        raise ValueError(f"weight-only QAT supports bits 4 or 8, got {bits}")

    def log(epoch, loss):
        if logger is not None:
            logger.info("W%d QAT epoch %d/%d: loss %.4f", bits, epoch + 1, epochs, loss)

    return _finetune(spec, qmod, folded, train_data, fq, None, epochs=epochs, lr=lr,
                     batch_size=batch_size, debug=debug, device=device, step_ms=step_ms,
                     log=log)
