"""Stage 1: teacher training, the port of the JAX package's ``cli/teacher.py``
(reference `teacher_training/main.py`): choice=1 trains the teacher
(default resnet50) per fold with best-val checkpointing, then evaluates it
on the held-out test split; choice=2 reloads the per-fold checkpoints and
evaluates them.

    python -m inference_efficient_vision_models_tpu_torch.cli.teacher key=value ...
"""

from __future__ import annotations

from ..core import artifacts
from ..core.config import TeacherConfig
from ..core.prng import generator_for
from ..core.provenance import stage_record, write_provenance
from ..data.pipeline import Batches
from ..metrics.report import summarize_folds
from ..models.registry import create_model, params_from_jax, spec_from_dict
from ..train.loop import evaluate, train_classifier
from ..train.steps import make_eval_step
from ..utils.device import DeviceLike
from .common import fold_arrays, iter_folds, make_config, setup_stage, stage_device


def load_stage_model(fold_dir: str, which: str, device: DeviceLike = None):
    """Rebuild (spec, params, state) from a stage checkpoint + spec JSON, on
    ``device`` (the GPU unless ``device="cpu"``)."""
    spec_dict = artifacts.load_spec_dict(fold_dir, which)
    if spec_dict is None or not artifacts.checkpoint_exists(fold_dir, which):
        raise FileNotFoundError(f"no model_{which} checkpoint and spec JSON in {fold_dir}")
    spec = spec_from_dict(spec_dict)
    raw = artifacts.load_checkpoint_raw(fold_dir, which)
    return (spec, params_from_jax(spec, raw["params"], device),
            params_from_jax(spec, raw["state"], device))


def evaluate_fold(cfg, spec, params, state, test_d, device, logger, fold: int):
    """Evaluate on the held-out split -> the fold's result row."""
    eval_step = make_eval_step(spec, compute_dtype=cfg.compute_dtype)
    test = evaluate(eval_step, params, state,
                    Batches(*test_d, cfg.batch_size, device), cfg.DEBUG_MODE)
    logger.info("fold %d test: loss %.4f acc %.2f%%", fold, test["loss"], test["acc"] * 100)
    return {"fold": fold, "test_loss": test["loss"], "test_acc": test["acc"]}


def run_train(cfg, logger, data, split, device=None):
    device = device or stage_device()
    results = []
    for fold in iter_folds(cfg):
        logger.info("===== fold %d/%d =====", fold, cfg.num_folds - 1)
        train_d, val_d, test_d = fold_arrays(data, split, fold)
        spec, params, state = create_model(
            cfg.model_name, cfg.num_classes,
            generator=generator_for(cfg.seed, "fold", fold, "init"),
            pretrained=cfg.pretrained, logger=logger, device=device)
        params, state, _ = train_classifier(cfg, spec, params, state, train_d, val_d,
                                            cfg.fold_dir(fold), logger, device=device)
        write_provenance(cfg.fold_dir(fold), stage_record(
            cfg, "teacher_training", fold,
            model_type="teacher", model_name=cfg.model_name,
            epochs=cfg.epochs, learning_rate=cfg.learning_rate,
            pretrained=bool(cfg.pretrained),
        ))
        results.append(evaluate_fold(cfg, spec, params, state, test_d, device, logger, fold))
    summarize_folds(results, cfg.output_dir, logger, name="teacher_results")
    return results


def run_test(cfg, logger, data, device=None, name="teacher_results"):
    device = device or stage_device()
    results = []
    for fold in iter_folds(cfg):
        fold_dir = cfg.fold_dir(fold)
        try:
            spec, params, state = load_stage_model(fold_dir, cfg.test_ckpt_type, device)
        except FileNotFoundError:
            logger.warning("fold %d: checkpoint missing in %s — skipping", fold, fold_dir)
            continue
        results.append(evaluate_fold(cfg, spec, params, state, data["test"], device, logger, fold))
    summarize_folds(results, cfg.output_dir, logger, name=name)
    return results


def main(argv=None):
    cfg = make_config(TeacherConfig, argv)
    device = stage_device()
    logger, _, data, split = setup_stage(cfg)
    if cfg.choice == 1:
        return run_train(cfg, logger, data, split, device)
    return run_test(cfg, logger, data, device)


if __name__ == "__main__":
    main()
