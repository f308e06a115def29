"""Stage 4: post-training quantization, the port of the JAX package's
``cli/quantize.py`` (reference `quantization/main.py`): per fold, load the
chosen upstream model (teacher / student / pruned, rebuilt from its spec
JSON), take a calibration set of at most ``calibration_images`` from the
fold's own train split, run every requested method, measure accuracy,
size, batch-1 latency and batch throughput, save each artifact
(``model_<method>.msgpack`` from ``serializable(model)`` + ``spec.json``,
read by either package's ``load_quantized``), and emit the summary table
and CSV; the fold's provenance record also holds static_int8's
calibration and conversion seconds and what the accuracy tools took. With
``qat_epochs`` > 0 every static method and both weight-only methods run
their own QAT first (``adaround_iters`` > 0: AdaRound after it, for the
static ones); ``sensitivity=True`` and ``automix=True`` write
``sensitivity_fold{k}.csv`` and ``automix_fold{k}.csv`` into the output
directory, with the JAX CLI's columns. A method or tool that fails is
logged and skipped, as in the reference, so the others still run (a tool
that fails writes no file). choice=2 reloads the saved artifacts and
re-measures accuracy and size.

    python -m inference_efficient_vision_models_tpu_torch.cli.quantize key=value ...
"""

from __future__ import annotations

import csv
import json
import os
import traceback

import torch

from ..compress.quant.engine import QuantizationEngine, evaluate_accuracy_fn, quant_module
from ..core import artifacts
from ..core.config import QuantConfig
from ..core.provenance import stage_record, write_provenance
from ..metrics.profile import model_size_bytes
from ..metrics.report import summarize_folds
from ..serving import load_quantized
from .common import fold_arrays, iter_folds, make_config, setup_stage, stage_device
from .teacher import load_stage_model


def _source_dir(cfg, fold: int) -> str:
    root = {"teacher": cfg.teacher_exp_path, "student": cfg.student_exp_path,
            "pruned": cfg.pruning_exp_path}[cfg.model_type]
    return os.path.join(root, f"fold_{fold}")


def _save_qmodel(fold_dir: str, method: str, model, spec) -> str:
    os.makedirs(fold_dir, exist_ok=True)
    path = os.path.join(fold_dir, f"model_{method}.msgpack")
    with open(path, "wb") as f:
        f.write(artifacts.tree_bytes(quant_module(spec).serializable(model)))
    with open(os.path.join(fold_dir, "spec.json"), "w") as f:
        json.dump(spec.to_dict(), f, indent=2)
    return path


def _write_csv(path: str, rows) -> None:
    """Rows (dicts with the same keys) -> a CSV with a header, as pandas'
    ``to_csv(index=False)`` writes it (the GPU machine has no pandas)."""
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        w.writeheader()
        w.writerows(rows)


def _sweeps(cfg, logger, engine, calib, test_d, fold: int) -> None:
    """The sensitivity sweep and the automix search on the test split, each
    isolated as a method is: a failure is logged and writes no file."""
    if cfg.sensitivity:
        try:
            srows = engine.sensitivity(calib, eval_data=test_d)
            sp = os.path.join(cfg.output_dir, f"sensitivity_fold{fold}.csv")
            _write_csv(sp, srows)
            logger.info("wrote %s", sp)
        except Exception as e:
            logger.error("sensitivity sweep failed: %s", e)
            logger.error(traceback.format_exc())
    if cfg.automix:
        try:
            float_taps, ladder = engine.auto_mixed(calib, eval_data=test_d)
            ap = os.path.join(cfg.output_dir, f"automix_fold{fold}.csv")
            _write_csv(ap, [{**r, "float_taps": ";".join(r["float_taps"])} for r in ladder])
            logger.info("automix policy: %d float tap(s) %s -> wrote %s", len(float_taps),
                        float_taps, ap)
        except Exception as e:
            logger.error("automix search failed: %s", e)
            logger.error(traceback.format_exc())


def run_test(cfg, logger, data, device=None):
    """choice=2: reload the saved artifacts and re-evaluate them."""
    device = device or stage_device()
    rows = []
    for fold in iter_folds(cfg):
        fold_dir = cfg.fold_dir(fold)
        if not os.path.exists(os.path.join(fold_dir, "spec.json")):
            logger.warning("fold %d: no quantized artifacts — skipping", fold)
            continue
        for method in cfg.methods:
            if not os.path.exists(os.path.join(fold_dir, f"model_{method}.msgpack")):
                continue
            spec, _, fn, pre = load_quantized(fold_dir, method, device=device)
            acc = evaluate_accuracy_fn(cfg, fn, data["test"], pre, device)
            stored = artifacts.load_checkpoint_raw(fold_dir, method)
            size_mb = model_size_bytes(quant_module(spec).serializable(stored)) / 1e6
            rows.append({"fold": fold, "method": method, "Accuracy": acc * 100.0,
                         "Size (MB)": size_mb})
            logger.info("fold %d %s: acc %.2f%% size %.2f MB", fold, method, acc * 100, size_mb)
    summarize_folds(rows, cfg.output_dir, logger, name="quantization_summary")
    return rows


def run_quantize(cfg, logger, data, split, device=None):
    device = device or stage_device()
    rows = []
    for fold in iter_folds(cfg):
        logger.info("===== fold %d/%d (%s) =====", fold, cfg.num_folds - 1, cfg.model_type)
        src = _source_dir(cfg, fold)
        try:
            spec, params, state = load_stage_model(src, cfg.test_ckpt_type, device)
        except FileNotFoundError:
            logger.warning("fold %d: %s model missing in %s — skipping", fold, cfg.model_type, src)
            continue
        train_d, _, test_d = fold_arrays(data, split, fold)
        calib = (train_d[0][: cfg.calibration_images], train_d[1][: cfg.calibration_images])

        engine = QuantizationEngine(cfg, spec, params, state, logger, device)
        fp32_mb = engine.size_mb(engine.folded)
        methods = {
            "fp32": lambda: (engine.folded, engine.float_forward()),
            "static_int8": lambda: engine.static_quantize(calib, train_d),
            "static_int8_mixed": lambda: engine.static_quantize(calib, train_d,
                                                                executor="mixed"),
            # the bf16 activation carrier over the same conversion (ViTs)
            "static_int8_bf16": lambda: engine.static_quantize(calib, train_d, executor="bf16"),
            "dynamic_int8": engine.dynamic_quantize,
            "fp16": lambda: engine.cast_half(torch.float16),
            "bf16": lambda: engine.cast_half(torch.bfloat16),
            "weight_only_int8": lambda: engine.weight_only_quantize(train_data=train_d),
            "weight_only_int4": lambda: engine.weight_only_quantize(bits=4, train_data=train_d),
        }
        for method in ("fp32",) + tuple(cfg.methods):
            if method not in methods:
                logger.warning("unknown method %s — skipping", method)
                continue
            try:
                model, fn = methods[method]()
                pre = engine.static_preprocess(method)
                acc = engine.evaluate_accuracy(fn, test_d, host_preprocess=pre)
                size_mb = engine.size_mb(model)
                lat = engine.measure_latency(fn, batch_size=1, host_preprocess=pre)
                thr = engine.measure_latency(fn, batch_size=cfg.batch_size, host_preprocess=pre)
                if method != "fp32":
                    _save_qmodel(cfg.fold_dir(fold), method, model, spec)
                rows.append({
                    "fold": fold, "method": method, "Accuracy": acc * 100.0,
                    "Size (MB)": size_mb, "Compression": fp32_mb / max(size_mb, 1e-9),
                    "p50 latency (ms)": lat["p50"],
                    "throughput (img/s)": thr["throughput_ips"],
                })
                logger.info("%s: acc %.2f%% size %.2f MB (%.2fx) p50 %.2f ms bs%d %.0f img/s",
                            method, acc * 100, size_mb, fp32_mb / max(size_mb, 1e-9),
                            lat["p50"], cfg.batch_size, thr["throughput_ips"])
            except Exception as e:  # the reference isolates each method
                logger.error("method %s failed: %s", method, e)
                logger.error(traceback.format_exc())
        _sweeps(cfg, logger, engine, calib, test_d, fold)
        write_provenance(cfg.fold_dir(fold), stage_record(
            cfg, "quantization", fold, source_dir=src,
            model_type=cfg.model_type, spec_name=spec.name,
            num_classes=int(spec.num_classes),
            stage_widths=[int(w) for w in getattr(spec, "stage_widths", ())] or None,
            observer=cfg.observer, qat_epochs=cfg.qat_epochs,
            adaround_iters=cfg.adaround_iters, calibration_images=cfg.calibration_images,
            methods=list(cfg.methods), static_int8_timings=engine.timings,
            accuracy_tool_timings=engine.tool_timings,
        ))
    summarize_folds(rows, cfg.output_dir, logger, name="quantization_summary")
    return rows


def main(argv=None):
    cfg = make_config(QuantConfig, argv)
    device = stage_device()
    logger, _, data, split = setup_stage(cfg)
    if cfg.choice == 2:
        return run_test(cfg, logger, data, device)
    return run_quantize(cfg, logger, data, split, device)


if __name__ == "__main__":
    main()
