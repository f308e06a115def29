"""Train and eval steps, the port of the JAX package's ``train/steps.py``.

A step takes device tensors ``(images_u8 NHWC, labels, mask)``, normalizes on
the device, runs the forward(s), the loss, the backward and the AdamW update
in place, and returns its metrics as 0-d device tensors: nothing in a step
waits for the device. fp32 steps run with TF32 off, backward included.
``*_loss_and_grads`` are the steps without the update.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..data.pipeline import normalize_images
from ..models.registry import apply_model, features_and_logits
from ..utils.device import exact_fp32
from .losses import cross_entropy, kd_loss, masked_accuracy, sp_kd_loss
from .optim import adamw_update, tree_leaves

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype_of(name) -> torch.dtype:
    return _DTYPES[str(name)]


def _tracked(params):
    """The params' leaves, marked for autograd (before the forward)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def ce_loss_and_grads(spec, params, state, batch, *, compute_dtype="bfloat16",
                      train: bool = True):
    """-> (loss, logits, new_state, grads in ``tree_leaves(params)`` order).
    ``train=False`` takes the gradient through the eval-mode forward (running
    BatchNorm statistics), as the Taylor pruning criterion does."""
    cdt = compute_dtype_of(compute_dtype)
    imgs_u8, labels, mask = batch
    with exact_fp32(), torch.enable_grad():
        leaves = _tracked(params)
        logits, new_state = apply_model(spec, params, state, normalize_images(imgs_u8, cdt),
                                        train=train, compute_dtype=cdt)
        loss = cross_entropy(logits, labels, mask)
        grads = list(torch.autograd.grad(loss, leaves))
    return loss.detach(), logits.detach(), new_state, grads


def kd_loss_and_grads(student_spec, teacher_spec, params, state, teacher_params,
                      teacher_state, batch, *, alpha, temperature, sp_weight=0.0,
                      compute_dtype="bfloat16"):
    """KD loss (1-α)·CE + α·KL·T² (+ sp_weight · similarity-preserving loss on
    the penultimate features) against the frozen teacher in eval mode.
    -> (loss, parts {"ce", "kd", "sp"}, logits, new_state, grads)."""
    cdt = compute_dtype_of(compute_dtype)
    use_sp = float(sp_weight) > 0.0
    imgs_u8, labels, mask = batch
    x = normalize_images(imgs_u8, cdt)
    with exact_fp32():
        with torch.no_grad():
            if use_sp:
                t_feats, t_logits, _ = features_and_logits(
                    teacher_spec, teacher_params, teacher_state, x, train=False,
                    compute_dtype=cdt)
            else:
                t_logits, _ = apply_model(teacher_spec, teacher_params, teacher_state, x,
                                          train=False, compute_dtype=cdt)
        with torch.enable_grad():
            leaves = _tracked(params)
            if use_sp:
                feats, logits, new_state = features_and_logits(
                    student_spec, params, state, x, train=True, compute_dtype=cdt)
            else:
                logits, new_state = apply_model(student_spec, params, state, x, train=True,
                                                compute_dtype=cdt)
            total, ce, kd = kd_loss(logits, t_logits, labels, alpha=alpha,
                                    temperature=temperature, mask=mask)
            sp = sp_kd_loss(feats, t_feats, mask) if use_sp else torch.zeros((), device=x.device)
            total = total + sp_weight * sp
            grads = list(torch.autograd.grad(total, leaves))
    parts = {"ce": ce.detach(), "kd": kd.detach(), "sp": sp.detach()}
    return total.detach(), parts, logits.detach(), new_state, grads


def _lr(learning_rate, lr_schedule, step: int) -> float:
    return lr_schedule(step) if lr_schedule is not None else learning_rate


def make_train_step(spec, *, learning_rate, compute_dtype="bfloat16", weight_decay=0.01,
                    lr_schedule: Optional[Callable[[int], float]] = None):
    """CE classifier step: (params, state, opt, batch) -> (params, state, opt,
    metrics {"loss", "acc", "n"}). ``params`` and the moments are updated in
    place. ``lr_schedule(step) -> lr`` (``optim.make_lr_schedule``) or None
    for the constant rate."""

    def step(params, state, opt, batch):
        loss, logits, new_state, grads = ce_loss_and_grads(
            spec, params, state, batch, compute_dtype=compute_dtype)
        params, opt = adamw_update(params, grads, opt,
                                   lr=_lr(learning_rate, lr_schedule, opt.step),
                                   weight_decay=weight_decay)
        _, labels, mask = batch
        return params, new_state, opt, {"loss": loss, "acc": masked_accuracy(logits, labels, mask),
                                        "n": mask.sum()}

    return step


def make_kd_train_step(student_spec, teacher_spec, *, alpha, temperature, learning_rate,
                       compute_dtype="bfloat16", weight_decay=0.01,
                       lr_schedule: Optional[Callable[[int], float]] = None, sp_weight=0.0):
    """KD step: (params, state, opt, teacher_params, teacher_state, batch) ->
    (params, state, opt, metrics {"loss", "ce", "kd", "sp", "acc", "n"})."""

    def step(params, state, opt, teacher_params, teacher_state, batch):
        loss, parts, logits, new_state, grads = kd_loss_and_grads(
            student_spec, teacher_spec, params, state, teacher_params, teacher_state, batch,
            alpha=alpha, temperature=temperature, sp_weight=sp_weight,
            compute_dtype=compute_dtype)
        params, opt = adamw_update(params, grads, opt,
                                   lr=_lr(learning_rate, lr_schedule, opt.step),
                                   weight_decay=weight_decay)
        _, labels, mask = batch
        return params, new_state, opt, {"loss": loss, **parts,
                                        "acc": masked_accuracy(logits, labels, mask),
                                        "n": mask.sum()}

    return step


def make_eval_step(spec, *, compute_dtype="float32"):
    """Eval step (params, state, batch) -> per-batch {"sum_loss", "sum_correct",
    "n"} as 0-d device tensors."""
    cdt = compute_dtype_of(compute_dtype)

    def step(params, state, batch) -> Dict[str, torch.Tensor]:
        imgs_u8, labels, mask = batch
        with torch.no_grad(), exact_fp32():
            x = normalize_images(imgs_u8, cdt)
            logits = apply_model(spec, params, state, x, train=False, compute_dtype=cdt)[0].float()
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
            correct = (logits.argmax(dim=-1) == labels.long()).float()
            return {"sum_loss": (nll * mask).sum(), "sum_correct": (correct * mask).sum(),
                    "n": mask.sum()}

    return step
