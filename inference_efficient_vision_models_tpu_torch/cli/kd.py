"""Stage 2: knowledge distillation, the port of the JAX package's
``cli/kd.py`` (reference `knowledge_distillation/main.py`): per fold, load
the frozen stage-1 teacher checkpoint (or a reference ``.pth`` given as
``teacher_checkpoint``), train the student (default resnet18) with the
(1-α)·CE + α·KL·T² loss, track best-val checkpoints, and evaluate on the
held-out split; choice=2 re-evaluates saved students.

    python -m inference_efficient_vision_models_tpu_torch.cli.kd key=value ...
"""

from __future__ import annotations

import os

from ..core.config import KDConfig
from ..core.prng import generator_for
from ..core.provenance import stage_record, write_provenance
from ..metrics.report import summarize_folds
from ..models.registry import create_model, make_spec
from ..models.torch_import import load_torch_checkpoint
from ..models.resnet import place
from ..train.loop import train_classifier
from .common import fold_arrays, iter_folds, make_config, setup_stage, stage_device
from .teacher import evaluate_fold, load_stage_model, run_test as _run_test


def _load_teacher(cfg, fold: int, logger, device):
    """The stage-1 teacher for this fold (frozen), on ``device``."""
    if cfg.teacher_checkpoint and os.path.exists(cfg.teacher_checkpoint):
        spec = make_spec(cfg.teacher_model, cfg.num_classes)
        params, state = load_torch_checkpoint(spec, cfg.teacher_checkpoint)
        logger.info("loaded torch teacher checkpoint %s", cfg.teacher_checkpoint)
        return spec, place(params, device), place(state, device)
    fold_dir = os.path.join(cfg.resolve_teacher_path(), f"fold_{fold}")
    teacher = load_stage_model(fold_dir, cfg.test_ckpt_type, device)
    logger.info("loaded teacher from %s", fold_dir)
    return teacher


def run_train(cfg, logger, data, split, device=None):
    device = device or stage_device()
    results = []
    for fold in iter_folds(cfg):
        logger.info("===== fold %d/%d =====", fold, cfg.num_folds - 1)
        try:
            teacher = _load_teacher(cfg, fold, logger, device)
        except FileNotFoundError as e:
            logger.warning("fold %d: teacher missing (%s) — skipping", fold, e)
            continue
        train_d, val_d, test_d = fold_arrays(data, split, fold)
        spec, params, state = create_model(
            cfg.student_model, cfg.num_classes,
            generator=generator_for(cfg.seed, "kd_fold", fold, "init"),
            pretrained=cfg.pretrained, logger=logger, device=device)
        params, state, _ = train_classifier(cfg, spec, params, state, train_d, val_d,
                                            cfg.fold_dir(fold), logger, teacher=teacher,
                                            device=device)
        write_provenance(cfg.fold_dir(fold), stage_record(
            cfg, "knowledge_distillation", fold,
            source_dir=os.path.join(cfg.teacher_exp_path, f"fold_{fold}"),
            model_type="student", student_model=cfg.student_model,
            teacher_model=cfg.teacher_model, alpha=cfg.alpha,
            temperature=cfg.temperature, epochs=cfg.epochs,
        ))
        results.append(evaluate_fold(cfg, spec, params, state, test_d, device, logger, fold))
    summarize_folds(results, cfg.output_dir, logger, name="kd_results")
    return results


def run_test(cfg, logger, data, device=None):
    return _run_test(cfg, logger, data, device, name="kd_results")


def main(argv=None):
    cfg = make_config(KDConfig, argv)
    device = stage_device()
    logger, _, data, split = setup_stage(cfg)
    if cfg.choice == 1:
        return run_train(cfg, logger, data, split, device)
    return run_test(cfg, logger, data, device)


if __name__ == "__main__":
    main()
