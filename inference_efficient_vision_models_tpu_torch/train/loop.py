"""Training orchestration shared by the stages, the port of the JAX package's
``train/loop.py``: per-epoch train + validate, best-val checkpoint tracking,
a resumable ``model_last``, the ``training_log.json`` history and
DEBUG_MODE's two-batch epochs.

The data live on the device (``data.pipeline.Batches``). Steps return
their metrics as device tensors, read once after the epoch, so the step
loop never waits for the device. On a GPU each step is bracketed by
CUDA events; ``history["step_ms"]`` keeps every epoch's per-step device
times (empty on the CPU, where no device time exists).

With more than one process in the group (``parallel.initialize_distributed``)
training and evaluation run data-parallel over a mesh of every rank, as the
JAX package's loop goes data-parallel over all its devices; rank 0 writes
the checkpoints, the log and the plot.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from ..core import artifacts
from ..data.augment import augment_options, make_augment_fn
from ..data.pipeline import Batches
from ..models.registry import params_from_jax, params_to_jax
from ..parallel.mesh import make_mesh, world_size
from ..utils.device import DeviceLike, resolve_device
from . import steps as steps_mod
from .optim import AdamWState, adamw_init, make_lr_schedule, opt_to_jax


class StepClock:
    """CUDA-event times of a loop's steps; nothing on the CPU, where no
    device time exists. ``ms()`` waits for the last step."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"
        self.events: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def start(self):
        if self.on:
            self.events.append((torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True)))
            self.events[-1][0].record()

    def stop(self):
        if self.on:
            self.events[-1][1].record()

    def ms(self) -> List[float]:
        if self.events:
            self.events[-1][1].synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def _maybe_mesh():
    """A data-parallel mesh over every rank (None for one process)."""
    return make_mesh(model_parallel=1) if world_size() > 1 else None


def _plot(fold_dir: str, history: Dict, title: str, logger) -> None:
    """``training_curves.png`` beside the checkpoints, where matplotlib is
    installed (the GPU machine has none: one line says no plot was written)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        logger.info("matplotlib is not installed: no training_curves.png written")
        return
    from ..metrics.plots import plot_training_curves

    plot_training_curves(fold_dir, history, title)


def _run_epoch(step_fn, carry, loader: Batches, extra_args=(), debug_mode=False):
    """Drive one epoch -> (carry, mean loss, mean acc, seconds, per-step ms)."""
    t0 = time.time()
    clock = StepClock(loader.images.device)
    device_metrics = []
    for i, batch in enumerate(loader):
        if debug_mode and i == 2:
            break
        clock.start()
        params, state, opt = carry
        params, state, opt, m = step_fn(params, state, opt, *extra_args, batch)
        carry = (params, state, opt)
        clock.stop()
        device_metrics.append(torch.stack([m["loss"], m["acc"], m["n"]]))
    if not device_metrics:
        return carry, 0.0, 0.0, time.time() - t0, []
    loss, acc, n = torch.stack(device_metrics).double().cpu().numpy().T  # one sync per epoch
    step_ms = clock.ms()
    tot_n = max(float(n.sum()), 1.0)
    return (carry, float((loss * n).sum()) / tot_n, float((acc * n).sum()) / tot_n,
            time.time() - t0, step_ms)


def evaluate(eval_step, params, state, loader: Batches, debug_mode=False) -> Dict[str, float]:
    """Returns {'loss', 'acc', 'n'} (fractions, not percents)."""
    outs = []
    for i, batch in enumerate(loader):
        if debug_mode and i == 2:
            break
        out = eval_step(params, state, batch)
        outs.append(torch.stack([out["sum_loss"], out["sum_correct"], out["n"]]))
    if not outs:
        return {"loss": 0.0, "acc": 0.0, "n": 1.0}
    sum_loss, sum_correct, n = (float(v) for v in torch.stack(outs).double().sum(0).cpu())
    n = max(n, 1.0)
    return {"loss": sum_loss / n, "acc": sum_correct / n, "n": n}


def train_classifier(
    cfg,
    spec,
    params,
    state,
    train_data,
    val_data,
    fold_dir: str,
    logger,
    *,
    teacher=None,  # (teacher_spec, teacher_params, teacher_state) -> KD mode
    epochs: Optional[int] = None,
    save: bool = True,
    device: DeviceLike = None,
):
    """Train with best-val tracking; returns (params, state, history) of the
    best epoch, on ``device`` (the GPU unless ``device="cpu"``).

    ``teacher`` switches the step to knowledge distillation with cfg.alpha /
    cfg.temperature / cfg.sp_weight. ``epochs`` overrides cfg.epochs (the
    stage-3 fine-tune passes its own). ``cfg.resume`` continues an
    interrupted run from ``model_last``, optimizer state and batch order
    included. Checkpoints are written in the JAX layout; ``save=False``
    writes nothing into ``fold_dir``."""
    dev = resolve_device(device)
    mesh = _maybe_mesh()
    if mesh is not None:
        logger.info("data-parallel over %d ranks (mesh %s)", mesh.size(),
                    dict(zip(mesh.mesh_dim_names, mesh.shape)))
    save = save and (mesh is None or mesh.get_rank() == 0)
    epochs = cfg.epochs if epochs is None else epochs
    lr, resume = cfg.learning_rate, cfg.resume

    train_loader = Batches(*train_data, cfg.batch_size, dev, shuffle=True, seed=cfg.seed)
    val_loader = Batches(*val_data, cfg.batch_size, dev)

    schedule = None
    if cfg.lr_schedule != "constant":
        schedule = make_lr_schedule(
            cfg.lr_schedule, lr, epochs * len(train_loader),
            warmup_steps=cfg.warmup_steps, min_fraction=cfg.lr_min_fraction,
        )
        logger.info("lr schedule: %s over %d steps", cfg.lr_schedule, epochs * len(train_loader))

    augment_fn = make_augment_fn(cfg)
    if augment_fn is not None:
        logger.info("train-time augmentation ON (%s)", augment_options(cfg))
    if teacher is None:
        step = steps_mod.make_train_step(spec, learning_rate=lr,
                                         compute_dtype=cfg.compute_dtype, lr_schedule=schedule,
                                         augment_fn=augment_fn, augment_seed=cfg.seed,
                                         mesh=mesh)
        extra = ()
    else:
        t_spec, t_params, t_state = teacher
        step = steps_mod.make_kd_train_step(
            spec, t_spec, alpha=cfg.alpha, temperature=cfg.temperature,
            learning_rate=lr, compute_dtype=cfg.compute_dtype,
            lr_schedule=schedule, sp_weight=float(cfg.sp_weight),
            augment_fn=augment_fn, augment_seed=cfg.seed, mesh=mesh)
        extra = (t_params, t_state)
    eval_step = steps_mod.make_eval_step(spec, compute_dtype=cfg.compute_dtype, mesh=mesh)

    history = {"train_loss": [], "train_acc": [], "val_loss": [], "val_acc": [],
               "epoch_time": [], "step_ms": []}
    best_acc, start_epoch = -1.0, 0
    opt = None
    if resume and artifacts.checkpoint_exists(fold_dir, artifacts.LAST):
        raw = artifacts.load_checkpoint_raw(fold_dir, artifacts.LAST)
        if "meta" in raw and "opt" in raw:
            params = params_from_jax(spec, raw["params"], dev)
            state = params_from_jax(spec, raw["state"], dev)
            opt = AdamWState(step=int(raw["opt"]["step"]),
                             mu=params_from_jax(spec, raw["opt"]["mu"], dev),
                             nu=params_from_jax(spec, raw["opt"]["nu"], dev))
            start_epoch = int(raw["meta"]["epoch"]) + 1
            best_acc = float(raw["meta"]["best_acc"])
            history = {**history, **(artifacts.load_training_log(fold_dir) or {})}
            # epoch e draws its order from seed + e: continue the trajectory
            train_loader.epoch = start_epoch
            logger.info("resuming from epoch %d (best val acc %.2f%%)", start_epoch,
                        best_acc * 100)
    if opt is None:
        opt = adamw_init(params)
    carry = (params, state, opt)

    def to_jax(tree):
        return params_to_jax(spec, tree)

    best = None
    for epoch in range(start_epoch, epochs):
        carry, tr_loss, tr_acc, secs, step_ms = _run_epoch(step, carry, train_loader, extra,
                                                           cfg.DEBUG_MODE)
        val = evaluate(eval_step, carry[0], carry[1], val_loader, cfg.DEBUG_MODE)
        history["train_loss"].append(tr_loss)
        history["train_acc"].append(tr_acc)
        history["val_loss"].append(val["loss"])
        history["val_acc"].append(val["acc"])
        history["epoch_time"].append(secs)
        history["step_ms"].append(step_ms)
        logger.info(
            "epoch %d/%d | train loss %.4f acc %.2f%% | val loss %.4f acc %.2f%% | %.1fs",
            epoch + 1, epochs, tr_loss, tr_acc * 100, val["loss"], val["acc"] * 100, secs,
        )
        if val["acc"] > best_acc:
            best_acc = val["acc"]
            best = (to_jax(carry[0]), to_jax(carry[1]))
            if save:
                artifacts.save_checkpoint(fold_dir, artifacts.BEST, best[0], best[1], spec)
                logger.info("new best val acc %.2f%% → model_best", best_acc * 100)
        if save:
            artifacts.save_checkpoint(
                fold_dir, artifacts.LAST, to_jax(carry[0]), to_jax(carry[1]), spec,
                opt=opt_to_jax(carry[2], to_jax), meta={"epoch": epoch, "best_acc": best_acc},
            )
            artifacts.save_training_log(fold_dir, history)
    if save and history["train_loss"]:
        _plot(fold_dir, history, spec.name, logger)

    if best is None:  # epochs == 0 or resumed past the best epoch
        if resume and best_acc >= 0 and artifacts.checkpoint_exists(fold_dir, artifacts.BEST):
            raw = artifacts.load_checkpoint_raw(fold_dir, artifacts.BEST)
            best = (raw["params"], raw["state"])
        else:
            return carry[0], carry[1], history
    return params_from_jax(spec, best[0], dev), params_from_jax(spec, best[1], dev), history
