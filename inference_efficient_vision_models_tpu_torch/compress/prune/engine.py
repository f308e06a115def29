"""Structured pruning engine (select -> physically re-pack -> fine-tune), the
port of the JAX package's ``compress/prune/engine.py``: the ResNet family,
EfficientNet and MobileNetV2 prune channel groups through the dependency
graph (``graph.py``), a ViT prunes MLP hidden units and whole heads
(``vit_engine.py``).

Channels are physically removed: the pruned model is an ordinary smaller
network whose spec serializes to JSON. The selection and the surgery run in
numpy on the JAX-layout trees (``params_to_jax``), as the JAX package runs
them on the host, so the kept indices and the repacked leaves equal the
JAX package's by construction; the engine moves the result back to its
device (``params_from_jax``) for recalibration, fine-tuning and evaluation.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...models.efficientnet import EfficientNetSpec
from ...models.mobilenet import MobileNetV2Spec
from ...models.registry import params_from_jax, params_to_jax
from ...models.vit import ViTSpec
from ...models.widths import ResNetSpec
from ...utils.device import resolve_device
from .graph import IN_AXIS, get_path, group_slices, set_path
from .importance import channel_importance

GroupKey = Tuple


def _keep_count(width: int, ratio: float, round_to: int) -> int:
    n_prune = int(ratio * width)
    keep = width - n_prune
    if round_to > 1:
        keep = int(round(keep / round_to)) * round_to
    return int(min(max(keep, min(round_to, width), 1), width))


def select_channels(spec, params, *, ratio: float, method: str = "l2",
                    global_pruning: bool = False, round_to: int = 1,
                    rng: Optional[np.random.Generator] = None,
                    grads=None) -> Dict[GroupKey, np.ndarray]:
    """Kept channel indices (sorted, original order) per group. ``params``
    (and ``grads`` for Taylor) are JAX-layout numpy trees."""
    groups = group_slices(spec)
    scores = {}
    for g in groups:
        s = channel_importance(g, params, method, rng=rng, grads=grads)
        lanes = int(g.get("lanes", 1))
        if lanes > 1:
            # a lane group ranks lanes, importance summed over the
            # cardinality groups (channel layout is group-major)
            s = s.reshape(lanes, len(s) // lanes).sum(axis=0)
        scores[tuple(g["key"])] = s

    if global_pruning:
        # one threshold across all groups on mean-normalized scores
        if ratio >= 1.0:
            raise ValueError(f"pruning ratio must be < 1.0, got {ratio}")
        all_scores = np.concatenate([s / (s.mean() + 1e-12) for s in scores.values()])
        # 'sn >= thresh' keeps len-k channels modulo ties; k stays in range
        k = min(int(ratio * len(all_scores)), len(all_scores) - 1)
        thresh = np.partition(all_scores, k)[k] if k > 0 else -np.inf

    keep: Dict[GroupKey, np.ndarray] = {}
    for g in groups:
        key = tuple(g["key"])
        s = scores[key]
        lanes = int(g.get("lanes", 1))
        per_group = len(s)
        if global_pruning:
            sn = s / (s.mean() + 1e-12)
            kept = np.flatnonzero(sn >= thresh)
            min_keep = max(1, min(round_to, len(s)))
            if len(kept) < min_keep:
                kept = np.argsort(-sn)[:min_keep]
            if round_to > 1 and lanes == 1:  # trim to a multiple, dropping the weakest
                n = max((len(kept) // round_to) * round_to, min_keep)
                kept = kept[np.argsort(-sn[kept])][:n]
        elif lanes > 1:
            # total keep rounded to round_to, then to whole lanes
            n_total = _keep_count(len(s) * lanes, ratio, round_to)
            n_lanes = int(min(max(round(n_total / lanes), 1), len(s)))
            kept = np.argsort(-s)[:n_lanes]
        else:
            n = _keep_count(len(s), ratio, round_to)
            kept = np.argsort(-s)[:n]  # strongest n
        if lanes > 1:  # kept lanes -> absolute channel indices
            kept = (kept[None, :] + (np.arange(lanes) * per_group)[:, None]).ravel()
        keep[key] = np.sort(kept)
    return keep


def apply_pruning(spec, params, state, keep: Dict[GroupKey, np.ndarray]):
    """Slice every coupled array of the JAX-layout numpy trees; return the
    smaller model (new spec, params, state), the inputs left as they were."""
    params = copy.deepcopy(params)
    state = copy.deepcopy(state)

    new_widths: Dict[GroupKey, int] = {}
    for g in group_slices(spec):
        key = tuple(g["key"])
        if key not in keep:
            continue
        idx = np.asarray(keep[key])
        for path, axis in g["producers"]:
            set_path(params, path, np.take(np.asarray(get_path(params, path)), idx, axis=axis))
        for bn_path in g["bns"]:
            bn_p = get_path(params, bn_path)
            bn_s = get_path(state, bn_path)
            for k in ("scale", "bias"):
                bn_p[k] = np.take(np.asarray(bn_p[k]), idx, axis=0)
            for k in ("mean", "var"):
                bn_s[k] = np.take(np.asarray(bn_s[k]), idx, axis=0)
        for path, axis in g["consumers"]:
            set_path(params, path, np.take(np.asarray(get_path(params, path)), idx, axis=axis))
        for path, n_groups in g.get("grouped_in", ()):
            # grouped conv kernel (H, W, C_in/groups, C_out): its input axis
            # is indexed relative to the group, sliced by the kept lanes
            per_group = g["width"] // n_groups
            rel = np.unique(idx % per_group)
            assert len(rel) * n_groups == len(idx), (
                "grouped-conv keep set is not lane-structured: "
                f"{len(idx)} kept of {g['width']} over {n_groups} groups"
            )
            set_path(params, path, np.take(np.asarray(get_path(params, path)), rel, axis=IN_AXIS))
        for path in g.get("vectors", ()):  # 1-D biases (the SE convs)
            set_path(params, path, np.take(np.asarray(get_path(params, path)), idx, axis=0))
        if g["fc_in"]:
            params["fc"]["w"] = np.take(np.asarray(params["fc"]["w"]), idx, axis=0)
        new_widths[key] = len(idx)

    return _rebuild_spec(spec, new_widths), params, state


def _rebuild_effnet_spec(spec: EfficientNetSpec, new_widths: Dict[GroupKey, int]
                         ) -> EfficientNetSpec:
    widths = list(spec.stage_widths)
    hidden = [list(r) for r in spec.hidden_widths]
    se = [list(r) for r in spec.se_widths]
    stem, last = spec.stem_width, spec.last_width
    for key, n in new_widths.items():
        if key[0] == "stem":
            stem = n
        elif key[0] == "stage":
            widths[key[1]] = n
        elif key[0] == "hidden":
            hidden[key[1]][key[2]] = n
        elif key[0] == "se":
            se[key[1]][key[2]] = n
        elif key[0] == "last":
            last = n
    new = spec.with_widths(widths, hidden, stem, last, se_widths=se)
    # a t=1 block's hidden width is its input group's
    for s, depth in enumerate(new.depths):
        for b in range(depth):
            if not new.has_expand[s][b]:
                hidden[s][b] = new.block_in_width(s, b)
    return new.with_widths(hidden_widths=hidden)


def _rebuild_mbv2_spec(spec: MobileNetV2Spec, new_widths: Dict[GroupKey, int]
                       ) -> MobileNetV2Spec:
    widths = list(spec.stage_widths)
    hidden = [list(r) for r in spec.hidden_widths]
    stem, last = spec.stem_width, spec.last_width
    for key, n in new_widths.items():
        if key[0] == "stem":
            stem = n
        elif key[0] == "stage":
            widths[key[1]] = n
        elif key[0] == "hidden":
            hidden[key[1]][key[2]] = n
        elif key[0] == "last":
            last = n
    new = spec.with_widths(widths, hidden, stem, last)
    # a t=1 block's hidden width is its input group's
    for s, depth in enumerate(new.depths):
        for b in range(depth):
            if not new.has_expand[s][b]:
                hidden[s][b] = new.block_in_width(s, b)
    return new.with_widths(hidden_widths=hidden)


def _rebuild_spec(spec, new_widths: Dict[GroupKey, int]):
    """Record pruned widths into a fresh descriptor."""
    if isinstance(spec, EfficientNetSpec):
        return _rebuild_effnet_spec(spec, new_widths)
    if isinstance(spec, MobileNetV2Spec):
        return _rebuild_mbv2_spec(spec, new_widths)
    stage_widths = list(spec.stage_widths)
    inner = [[list(blk) for blk in stg] for stg in spec.inner_widths]
    stem_width = spec.stem_width
    for key, n in new_widths.items():
        if key[0] == "stem":
            stem_width = n
        elif key[0] == "stage":
            stage_widths[key[1]] = n
            if key[1] == 0 and spec.stem_tied_to_stage0:
                stem_width = n
        else:  # inner
            _, s, b, i = key
            if spec.groups > 1 and spec.block == "bottleneck":
                inner[s][b] = [n] * len(inner[s][b])  # one welded group sets both
            else:
                inner[s][b][i] = n
    return spec.with_widths(stage_widths=tuple(stage_widths), inner_widths=inner,
                            stem_width=stem_width)


def taylor_grads(spec, params, state, batch) -> list:
    """One batch's fp32 CE-loss gradients through the eval-mode forward (TF32
    off), in ``tree_leaves(params)`` order, on the params' device."""
    from ...train.steps import ce_loss_and_grads

    return ce_loss_and_grads(spec, params, state, batch, compute_dtype="float32",
                             train=False)[3]


def taylor_grads_accumulated(spec, params, state, batches):
    """Mean loss gradient over a calibration set of batches, as a
    JAX-layout numpy tree: one batch's |w·g| ranking is noise-dominated, so
    the gradient is averaged (running mean on the device)."""
    from ...train.optim import tree_like

    mean, n = None, 0
    for batch in batches:
        g = taylor_grads(spec, params, state, batch)
        n += 1
        if mean is None:
            mean = g
        else:
            k = torch.full((), float(n), dtype=torch.float32, device=g[0].device)
            mean = [m + (x - m) / k for m, x in zip(mean, g)]
    if mean is None:
        raise ValueError("taylor_grads_accumulated: empty calibration iterable")
    return params_to_jax(spec, tree_like(params, mean))


def prune_model(spec, params, state, *, ratio: float, method: str = "l2",
                global_pruning: bool = False, round_to: int = 1, seed: int = 42, grads=None,
                keep: Optional[Dict[GroupKey, np.ndarray]] = None) -> Tuple[object, dict, dict]:
    """One-shot structured pruning of JAX-layout numpy trees (the reference's
    single ``pruner.step()``); ``random`` draws from ``default_rng(seed)`` in
    group order. A ViT goes to ``vit_engine.prune_vit`` (MLP units and
    heads; ``global_pruning`` and ``grads`` do not apply to it)."""
    if isinstance(spec, ViTSpec):
        from .vit_engine import prune_vit

        return prune_vit(spec, params, state, ratio=ratio, method=method, round_to=round_to,
                         seed=seed, keep=keep)
    if not isinstance(spec, (ResNetSpec, EfficientNetSpec, MobileNetV2Spec)):
        raise TypeError(f"no structured pruning for {type(spec).__name__}")
    if keep is None:
        keep = select_channels(spec, params, ratio=ratio, method=method,
                               global_pruning=global_pruning, round_to=round_to,
                               rng=np.random.default_rng(seed), grads=grads)
    return apply_pruning(spec, params, state, keep)


class StructuredPruningEngine:
    """Stage-3 engine (the reference's class surface: ``prune_model`` /
    ``finetune`` / ``evaluate_metrics``). ``params`` and ``state`` are the
    port's tensors on ``device`` (the GPU unless ``device="cpu"``)."""

    def __init__(self, cfg, spec, params, state, logger, device=None):
        self.cfg = cfg
        self.spec = spec
        self.params = params
        self.state = state
        self.logger = logger
        self.device = resolve_device(device)
        self.history = None  # the last fine-tune's training history

    def prune_model(self, grads=None, ratio=None):
        """``grads``: a JAX-layout numpy tree (``taylor_grads_accumulated``)."""
        spec, params, state = prune_model(
            self.spec, params_to_jax(self.spec, self.params), params_to_jax(self.spec, self.state),
            ratio=self.cfg.pruning_ratio if ratio is None else ratio,
            method=self.cfg.pruning_method, global_pruning=self.cfg.global_pruning,
            round_to=self.cfg.round_to, seed=self.cfg.seed, grads=grads)
        self.spec = spec
        self.params = params_from_jax(spec, params, self.device)
        self.state = params_from_jax(spec, state, self.device)
        if isinstance(spec, ViTSpec):  # the widths live per block (heads, MLP units)
            self.logger.info("pruned → %s, heads %s, mlp hidden %s", spec.name,
                             spec.head_counts, spec.mlp_hidden)
        else:
            self.logger.info("pruned → stem %d, stages %s", spec.stem_width, spec.stage_widths)
        return self.spec, self.params, self.state

    def prune_iterative(self, train_d, val_d, fold_dir, grads_fn=None):
        """Gradual pruning: K prune -> fine-tune cycles, each keeping
        (1-ratio)^(1/K) of the current channels so the compounded keep
        fraction matches a one-shot run; the last step ends un-finetuned.
        ``grads_fn(spec, params, state)`` re-derives Taylor gradients on the
        current model each step."""
        k = max(int(self.cfg.iterative_steps), 1)
        step_ratio = 1.0 - (1.0 - self.cfg.pruning_ratio) ** (1.0 / k)
        for i in range(k):
            grads = grads_fn(self.spec, self.params, self.state) if grads_fn else None
            self.prune_model(grads=grads, ratio=step_ratio)
            if train_d is not None:
                self.recalibrate(train_d)
            if i < k - 1 and self.cfg.iterative_ft_epochs > 0:
                self.logger.info("iterative step %d/%d: fine-tuning %d epoch(s) before next step",
                                 i + 1, k, self.cfg.iterative_ft_epochs)
                self.finetune(train_d, val_d, fold_dir, epochs=self.cfg.iterative_ft_epochs)
        return self.spec, self.params, self.state

    def recalibrate(self, train_d):
        """Re-estimate the BN running statistics on train images
        (``train/bn_recal.py``); a no-op when ``cfg.bn_recalibrate`` is off
        and for a ViT, which has no BatchNorm."""
        if not getattr(self.cfg, "bn_recalibrate", True) or isinstance(self.spec, ViTSpec):
            return self.state
        from ...train.bn_recal import recalibrate_bn

        self.state = recalibrate_bn(
            self.spec, self.params, self.state, train_d[0], batch_size=self.cfg.batch_size,
            num_batches=getattr(self.cfg, "bn_recal_batches", 16),
            compute_dtype=self.cfg.compute_dtype)
        return self.state

    def finetune(self, train_d, val_d, fold_dir, epochs=None):
        """``epochs`` of the stage's training at cfg.learning_rate, keeping the
        best-val weights; writes nothing into ``fold_dir``."""
        from ...train.loop import train_classifier

        epochs = self.cfg.finetune_epochs if epochs is None else epochs
        if epochs <= 0:
            return self.params, self.state
        self.params, self.state, self.history = train_classifier(
            self.cfg, self.spec, self.params, self.state, train_d, val_d, fold_dir,
            self.logger, epochs=epochs, save=False,
            device=self.device)
        return self.params, self.state

    def evaluate_metrics(self, test_d, tag=""):
        """Accuracy + batch-1 p50 latency (10 warm-up / 50 timed, the
        reference protocol) + MACs + params + serialized size."""
        from ...data.pipeline import Batches, normalize_images
        from ...metrics.profile import count_params, flops_of, latency_ms, model_size_bytes
        from ...models.registry import apply_model
        from ...train.loop import evaluate
        from ...train.steps import make_eval_step

        spec, params, state = self.spec, self.params, self.state
        eval_step = make_eval_step(spec, compute_dtype=self.cfg.compute_dtype)
        self.logger.info("%s: evaluating accuracy...", tag)
        res = evaluate(eval_step, params, state,
                       Batches(test_d[0], test_d[1], self.cfg.batch_size, self.device),
                       self.cfg.DEBUG_MODE)

        def fwd(x):
            with torch.no_grad():
                return apply_model(spec, params, state, normalize_images(x), train=False)[0]

        h, w = self.cfg.image_size
        x1 = torch.zeros((1, h, w, 3), dtype=torch.uint8, device=self.device)
        self.logger.info("%s: measuring batch-1 latency + FLOPs...", tag)
        lat = latency_ms(fwd, x1)
        flops = flops_of(fwd, x1)
        metrics = {
            "Accuracy": res["acc"] * 100.0,
            "Latency (ms)": lat["p50"],
            "MACs (G)": flops / 2 / 1e9,
            "Params (M)": count_params(params) / 1e6,
            "Size (MB)": model_size_bytes(params_to_jax(spec, params),
                                          params_to_jax(spec, state)) / 1e6,
        }
        self.logger.info("%s metrics: %s", tag, {k: round(v, 4) for k, v in metrics.items()})
        return metrics
