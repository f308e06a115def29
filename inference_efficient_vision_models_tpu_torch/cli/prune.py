"""Stage 3: structured pruning + fine-tuning, the port of the JAX package's
``cli/prune.py`` (reference `pruning/main.py`): per fold, load the stage-2
student, measure baseline metrics, prune (one-shot or iterative channel
removal), recalibrate the BatchNorm statistics, re-measure, fine-tune,
re-measure, and save the pruned model as a dense JAX-layout checkpoint + its
width-descriptor JSON, with the three-row comparison table per fold.
choice=2 re-measures the saved pruned models. The fine-tune's history
(per-epoch losses and per-step device times) goes to the fold's
``training_log.json``.

    python -m inference_efficient_vision_models_tpu_torch.cli.prune key=value ...
"""

from __future__ import annotations

import os

from ..compress.prune.engine import StructuredPruningEngine, taylor_grads_accumulated
from ..core import artifacts
from ..core.config import PruningConfig
from ..core.provenance import stage_record, write_provenance
from ..data.pipeline import Batches
from ..metrics.report import summarize_folds
from ..models.registry import params_to_jax
from .common import fold_arrays, iter_folds, make_config, setup_stage, stage_device
from .teacher import load_stage_model


def _metrics_row(fold, phase, m):
    return {"fold": fold, "phase": phase, **m}


def run_prune(cfg, logger, data, split, device=None):
    device = device or stage_device()
    rows = []
    for fold in iter_folds(cfg):
        logger.info("===== fold %d/%d =====", fold, cfg.num_folds - 1)
        src_dir = os.path.join(cfg.student_exp_path, f"fold_{fold}")
        try:
            spec, params, state = load_stage_model(src_dir, cfg.test_ckpt_type, device)
        except FileNotFoundError:
            logger.warning("fold %d: student missing in %s — skipping", fold, src_dir)
            continue
        train_d, val_d, test_d = fold_arrays(data, split, fold)

        engine = StructuredPruningEngine(cfg, spec, params, state, logger, device)
        rows.append(_metrics_row(fold, "baseline", engine.evaluate_metrics(test_d, "baseline")))

        def taylor_grads_fn(spec_, params_, state_):
            # the mean gradient over cfg.taylor_batches unshuffled train batches
            it = iter(Batches(train_d[0], train_d[1], cfg.batch_size, device))
            return taylor_grads_accumulated(spec_, params_, state_,
                                            [b for _, b in zip(range(cfg.taylor_batches), it)])

        grads_fn = taylor_grads_fn if cfg.pruning_method == "taylor" else None
        if cfg.iterative_steps > 1:
            engine.prune_iterative(train_d, val_d, cfg.fold_dir(fold), grads_fn=grads_fn)
        else:
            engine.prune_model(grads=grads_fn(spec, params, state) if grads_fn else None)
            engine.recalibrate(train_d)
        rows.append(_metrics_row(fold, "pruned", engine.evaluate_metrics(test_d, "pruned")))

        if cfg.finetune_epochs > 0:
            engine.finetune(train_d, val_d, cfg.fold_dir(fold))
            artifacts.save_training_log(cfg.fold_dir(fold), engine.history)
            rows.append(_metrics_row(fold, "pruned+ft",
                                     engine.evaluate_metrics(test_d, "pruned+ft")))

        p_np = params_to_jax(engine.spec, engine.params)
        s_np = params_to_jax(engine.spec, engine.state)
        for which in (artifacts.BEST, artifacts.LAST):
            artifacts.save_checkpoint(cfg.fold_dir(fold), which, p_np, s_np, engine.spec)
        write_provenance(cfg.fold_dir(fold), stage_record(
            cfg, "pruning", fold, source_dir=src_dir,
            model_type="pruned", spec_name=engine.spec.name,
            pruning_ratio=cfg.pruning_ratio, pruning_method=cfg.pruning_method,
            round_to=cfg.round_to, global_pruning=cfg.global_pruning,
            iterative_steps=cfg.iterative_steps, finetune_epochs=cfg.finetune_epochs,
        ))
        logger.info("saved pruned model → %s", cfg.fold_dir(fold))
    summarize_folds(rows, cfg.output_dir, logger, name="results")
    return rows


def run_test(cfg, logger, data, device=None):
    device = device or stage_device()
    rows = []
    for fold in iter_folds(cfg):
        fold_dir = cfg.fold_dir(fold)
        try:
            spec, params, state = load_stage_model(fold_dir, cfg.test_ckpt_type, device)
        except FileNotFoundError:
            logger.warning("fold %d: pruned checkpoint missing — skipping", fold)
            continue
        engine = StructuredPruningEngine(cfg, spec, params, state, logger, device)
        rows.append(_metrics_row(fold, "pruned", engine.evaluate_metrics(data["test"], "pruned")))
    summarize_folds(rows, cfg.output_dir, logger, name="results")
    return rows


def main(argv=None):
    cfg = make_config(PruningConfig, argv)
    device = stage_device()
    logger, _, data, split = setup_stage(cfg)
    if cfg.choice == 1:
        return run_prune(cfg, logger, data, split, device)
    return run_test(cfg, logger, data, device)


if __name__ == "__main__":
    main()
