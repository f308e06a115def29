"""Train and eval steps, the port of the JAX package's ``train/steps.py``.

A step takes device tensors ``(images_u8 NHWC, labels, mask)``, normalizes on
the device, runs the forward(s), the loss, the backward and the AdamW update
in place, and returns its metrics as 0-d device tensors: nothing in a step
waits for the device. fp32 steps run with TF32 off, backward included.
``*_loss_and_grads`` are the steps without the update.

With ``mesh=`` (``parallel.make_mesh``) a step is a global-view program, as
the JAX package's steps over a mesh are: every rank is given the whole batch,
takes its rows (``parallel.mesh.GlobalView``), and the step returns what one
process returns on the whole batch: global loss and metrics, gradients
summed over the ranks, BatchNorm statistics of the whole batch, and AdamW
run identically on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..data.augment import augment_generator
from ..data.pipeline import normalize_images
from ..models.registry import apply_model, features_and_logits
from ..parallel.mesh import GlobalView
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


def _count(gv: GlobalView, mask):
    """The whole batch's mask sum, or None without a mesh (the losses' own)."""
    return None if gv.mesh is None else gv.sum(mask.float().sum())


def ce_loss_and_grads(spec, params, state, batch, *, compute_dtype="bfloat16",
                      train: bool = True, mesh=None):
    """-> (loss, logits, new_state, grads in ``tree_leaves(params)`` order).
    ``train=False`` takes the gradient through the eval-mode forward (running
    BatchNorm statistics), as the Taylor pruning criterion does. Over a
    ``mesh``, ``logits`` are this rank's rows."""
    cdt = compute_dtype_of(compute_dtype)
    gv = GlobalView(mesh, spec, params)
    imgs_u8, labels, mask = gv.batch(batch)
    n = _count(gv, mask)
    with exact_fp32(), torch.enable_grad(), gv.active():
        leaves = _tracked(params)
        logits, new_state = apply_model(spec, params, state, normalize_images(imgs_u8, cdt),
                                        train=train, compute_dtype=cdt)
        logits = gv.logits(logits)
        loss = cross_entropy(logits, labels, mask, n)
        grads = list(torch.autograd.grad(loss, leaves))
    return gv.sum(loss), logits.detach(), new_state, gv.grads(params, grads)


def kd_loss_and_grads(student_spec, teacher_spec, params, state, teacher_params,
                      teacher_state, batch, *, alpha, temperature, sp_weight=0.0,
                      compute_dtype="bfloat16", mesh=None):
    """KD loss (1-α)·CE + α·KL·T² (+ sp_weight · similarity-preserving loss on
    the penultimate features) against the frozen teacher in eval mode.
    -> (loss, parts {"ce", "kd", "sp"}, logits, new_state, grads)."""
    cdt = compute_dtype_of(compute_dtype)
    use_sp = float(sp_weight) > 0.0
    gv = GlobalView(mesh, student_spec, params)
    imgs_u8, labels, mask = gv.batch(batch)
    n = _count(gv, mask)
    x = normalize_images(imgs_u8, cdt)
    with exact_fp32(), gv.active():
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
            logits = gv.logits(logits)
            total, ce, kd = kd_loss(logits, t_logits, labels, alpha=alpha,
                                    temperature=temperature, mask=mask, total=n)
            if use_sp:  # the Gram matrix spans the whole batch: every rank computes it whole
                sp = sp_kd_loss(gv.features(feats), gv.features(t_feats), gv.features(mask))
            else:
                sp = torch.zeros((), device=x.device)
            # a split head: each model-axis rank adds the whole batch's term
            grads = list(torch.autograd.grad(total + (sp_weight * gv.replica_share) * sp,
                                             leaves))
    parts = {"ce": gv.sum(ce), "kd": gv.sum(kd), "sp": sp.detach()}
    loss = gv.sum(total) + sp_weight * parts["sp"]
    return loss, parts, logits.detach(), new_state, gv.grads(params, grads)


def _lr(learning_rate, lr_schedule, step: int) -> float:
    return lr_schedule(step) if lr_schedule is not None else learning_rate


def _augmented(batch, augment_fn, augment_seed: int, step: int):
    """The batch with its images through ``augment_fn`` (data/augment.py),
    drawn from the generator of (augment_seed, step); as is without one."""
    if augment_fn is None:
        return batch
    imgs_u8, labels, mask = batch
    gen = augment_generator(augment_seed, step, imgs_u8.device)
    return augment_fn(gen, imgs_u8), labels, mask


def _metrics(gv: GlobalView, logits, labels, mask):
    """(accuracy, mask count) of the whole batch from this rank's rows."""
    if gv.mesh is None:
        return masked_accuracy(logits, labels, mask), mask.sum()
    n = gv.sum(mask.float().sum())
    return gv.sum(masked_accuracy(logits, labels, mask, n)), n


def make_train_step(spec, *, learning_rate, compute_dtype="bfloat16", weight_decay=0.01,
                    lr_schedule: Optional[Callable[[int], float]] = None, augment_fn=None,
                    augment_seed: int = 0, mesh=None):
    """CE classifier step: (params, state, opt, batch) -> (params, state, opt,
    metrics {"loss", "acc", "n"}). ``params`` and the moments are updated in
    place. ``lr_schedule(step) -> lr`` (``optim.make_lr_schedule``) or None
    for the constant rate. ``augment_fn(gen, imgs_u8)`` (``data/augment.py``)
    augments the batch on its device first, drawing from the generator of
    (augment_seed, opt.step). With ``mesh`` the step takes the whole batch on
    every rank (augmented whole, then split)."""

    def step(params, state, opt, batch):
        batch = _augmented(batch, augment_fn, augment_seed, opt.step)
        gv = GlobalView(mesh, spec, params)
        loss, logits, new_state, grads = ce_loss_and_grads(
            spec, params, state, batch, compute_dtype=compute_dtype, mesh=mesh)
        params, opt = adamw_update(params, grads, opt,
                                   lr=_lr(learning_rate, lr_schedule, opt.step),
                                   weight_decay=weight_decay)
        _, labels, mask = gv.batch(batch)
        acc, n = _metrics(gv, logits, labels, mask)
        return params, new_state, opt, {"loss": loss, "acc": acc, "n": n}

    return step


def make_kd_train_step(student_spec, teacher_spec, *, alpha, temperature, learning_rate,
                       compute_dtype="bfloat16", weight_decay=0.01,
                       lr_schedule: Optional[Callable[[int], float]] = None, sp_weight=0.0,
                       augment_fn=None, augment_seed: int = 0, mesh=None):
    """KD step: (params, state, opt, teacher_params, teacher_state, batch) ->
    (params, state, opt, metrics {"loss", "ce", "kd", "sp", "acc", "n"}).
    With ``augment_fn``, teacher and student see the same augmented batch."""

    def step(params, state, opt, teacher_params, teacher_state, batch):
        batch = _augmented(batch, augment_fn, augment_seed, opt.step)
        gv = GlobalView(mesh, student_spec, params)
        loss, parts, logits, new_state, grads = kd_loss_and_grads(
            student_spec, teacher_spec, params, state, teacher_params, teacher_state, batch,
            alpha=alpha, temperature=temperature, sp_weight=sp_weight,
            compute_dtype=compute_dtype, mesh=mesh)
        params, opt = adamw_update(params, grads, opt,
                                   lr=_lr(learning_rate, lr_schedule, opt.step),
                                   weight_decay=weight_decay)
        _, labels, mask = gv.batch(batch)
        acc, n = _metrics(gv, logits, labels, mask)
        return params, new_state, opt, {"loss": loss, **parts, "acc": acc, "n": n}

    return step


def make_eval_step(spec, *, compute_dtype="float32", mesh=None):
    """Eval step (params, state, batch) -> per-batch {"sum_loss", "sum_correct",
    "n"} as 0-d device tensors (of the whole batch over a ``mesh``)."""
    cdt = compute_dtype_of(compute_dtype)

    def step(params, state, batch) -> Dict[str, torch.Tensor]:
        gv = GlobalView(mesh, spec, params)
        imgs_u8, labels, mask = gv.batch(batch)
        with torch.no_grad(), exact_fp32():
            x = normalize_images(imgs_u8, cdt)
            logits = gv.logits(apply_model(spec, params, state, x, train=False,
                                           compute_dtype=cdt)[0].float())
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
            correct = (logits.argmax(dim=-1) == labels.long()).float()
            return {"sum_loss": gv.sum((nll * mask).sum()),
                    "sum_correct": gv.sum((correct * mask).sum()), "n": gv.sum(mask.sum())}

    return step
