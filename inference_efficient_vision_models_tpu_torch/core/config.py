"""Stage configuration classes: the port's copy of the JAX package's
``core/config.py`` for stages 1-2 (``BaseConfig``, ``TeacherConfig``,
``KDConfig``), with the same fields, defaults and contract:

* kwargs-override constructor (only known attributes are overridden),
* ``DEBUG_MODE`` shrinks the workload for smoke runs,
* ``<artifacts_root>/<stage>/<experiment_name>/`` is created as a side effect.

Fields the port does not act on yet keep their JAX defaults so both
packages accept the same overrides: ``data_axis``/``model_axis`` (no
multi-GPU yet) and ``profile_dir``. The device is not a field: the stage
CLIs run on ``cuda`` unless ``IEVM_PLATFORM=cpu`` (``cli/common.py``).
``PruningConfig`` and ``QuantConfig`` (stages 3-4) keep every JAX field too.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

# NEU-DET class name → id map (reference `teacher_config.py:33-40`).
CLS_NAME_ID_MAP = {
    "crazing": 0,
    "inclusion": 1,
    "patches": 2,
    "pitted_surface": 3,
    "rolled-in_scale": 4,
    "scratches": 5,
}


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class BaseConfig:
    """Shared fields + the kwargs-override / DEBUG_MODE / mkdir contract."""

    #: subdirectory of the repo-level ``output/`` tree this stage writes into
    stage_name = "base"

    def __init__(self, **kwargs):
        self.choice = 1  # 1: train/prune/quantize, 2: test
        self.experiment_name = "test"
        self.DEBUG_MODE = False

        self.num_classes = 6
        self.num_folds = 5
        # Optional fold subset, e.g. folds=(0,) for a single-fold A/B run.
        # None runs every fold of the persisted num_folds-way split; the
        # split itself is always built from num_folds so per-fold data is
        # identical whether a fold runs alone or in the full sweep.
        self.folds = None
        self.image_size: Tuple[int, int] = (224, 224)
        self.batch_size = 64
        self.learning_rate = 1e-4
        self.epochs = 2
        # LR schedule over the run: 'constant' (reference parity — it had no
        # scheduler), 'cosine', or 'warmup_cosine' (linear warmup then cosine
        # decay to lr_min_fraction * learning_rate)
        self.lr_schedule = "constant"
        self.warmup_steps = 0
        self.lr_min_fraction = 0.0
        self.test_ckpt_type = "best"  # 'best' or 'last'

        self.data_dir = os.path.join(_repo_root(), "data", "NEU-DET")
        # All stages hang off one artifacts root: <artifacts_root>/<stage>/<exp>/
        # (the reference used per-stage relative paths that required cd-ing
        # into the stage directory; one root fixes that and makes cross-stage
        # chaining overridable for tests).
        self.artifacts_root = os.path.join(_repo_root(), "output")
        self.output_root = None  # derived after kwargs unless overridden
        self.seed = 42
        self.num_workers = 2  # host-side decode threads
        self.resume = False  # continue an interrupted run from model_last
        self.profile_dir = None  # profiler traces (not written by the port yet)

        # knobs with no reference equivalent
        self.compute_dtype = "bfloat16"  # conv/matmul compute dtype ('bfloat16' | 'float32')
        self.data_axis = "data"  # mesh axis name for DP sharding
        self.model_axis = "model"  # mesh axis name for optional TP
        self.synthetic_data = "auto"  # True | False | "auto" (use if data_dir missing)
        self.synthetic_size = 256  # images per split when synthesizing
        # 'easy' — the original 6-class saturating surrogate (pipeline CI);
        # 'hard' — the discriminative surrogate for compression A/Bs:
        # fine-grained orientation×frequency classes, train→test shift,
        # deterministic label noise (pair with num_classes=12 and a small
        # synthetic_size, e.g. 150). See data/synthetic.py.
        self.synthetic_variant = "easy"
        self.synthetic_label_noise = 0.05  # train-split noise, 'hard' only

        # Train-time augmentation (data/augment.py; OFF = exact reference
        # parity — the reference has none, `teacher_training/dataset.py:14-21`).
        # augment=True fuses flip/crop/brightness-contrast jitter into the
        # train step. For the hard surrogate set augment_flip=False
        # augment_rot180=True (flips change the orientation label there).
        self.augment = False
        self.augment_flip = True
        self.augment_rot180 = False
        self.augment_crop_pad = 16
        self.augment_brightness = 0.15
        self.augment_contrast = 0.2
        # planar illumination-gradient jitter amplitude (fraction of full
        # scale); 0.5 spans the hard surrogate's shifted test range
        self.augment_illum_gradient = 0.0
        # gaussian pixel-noise jitter: per-image σ ~ U(0, augment_noise)
        self.augment_noise = 0.0

        self.cls_name_id_map = dict(CLS_NAME_ID_MAP)

        self._stage_defaults()

        # Override defaults with provided kwargs (reference
        # `teacher_config.py:44-46`: only known attributes are set).
        for key, value in kwargs.items():
            if hasattr(self, key):
                setattr(self, key, value)

        if self.output_root is None:
            self.output_root = os.path.join(self.artifacts_root, self.stage_name)
        self.output_dir = os.path.join(self.output_root, self.experiment_name)
        os.makedirs(self.output_dir, exist_ok=True)
        self._resolve_paths()

        if self.DEBUG_MODE:
            self._debug_shrink()

    # -- hooks -------------------------------------------------------------
    def _stage_defaults(self):
        """Stage-specific fields; set before kwargs override."""

    def _resolve_paths(self):
        """Derive cross-stage source paths from artifacts_root (post-kwargs);
        fields explicitly overridden by the user are left untouched."""

    def stage_path(self, stage: str, exp: str) -> str:
        return os.path.join(self.artifacts_root, stage, exp)

    def _debug_shrink(self):
        """DEBUG_MODE shrink (reference `teacher_config.py:51-54`)."""
        self.epochs = 2
        self.batch_size = 2
        self.num_folds = 3
        self.synthetic_size = 64

    # ----------------------------------------------------------------------
    def fold_dir(self, fold: int) -> str:
        return os.path.join(self.output_dir, f"fold_{fold}")

    def __repr__(self):
        return str({k: v for k, v in self.__dict__.items() if not k.startswith("_")})


class TeacherConfig(BaseConfig):
    """Stage 1: teacher baseline training (reference `teacher_config.py`)."""

    stage_name = "teacher_training"

    def _stage_defaults(self):
        self.model_name = "resnet50"
        self.pretrained = True  # torchvision-init import when available
        self.batch_size = 64
        self.learning_rate = 1e-4
        self.epochs = 2


class KDConfig(BaseConfig):
    """Stage 2: knowledge distillation (reference `kd_config.py`)."""

    stage_name = "knowledge_distillation"

    def _stage_defaults(self):
        self.teacher_exp_name = "test"
        self.teacher_model = "resnet50"
        self.student_model = "resnet18"
        # KD loss = (1-α)·CE + α·KL(log_softmax(s/T), softmax(t/T))·T²
        # (reference `knowledge_distillation/train.py:47-57`)
        self.alpha = 0.5
        self.temperature = 4.0
        # student init (reference `kd_config.py` builds the student with
        # pretrained=True); False = random init (used by the synthetic runs).
        self.pretrained = True
        # similarity-preserving feature distillation weight (beyond the
        # reference's logit-only KD; 0.0 = off = exact reference loss).
        # See train/losses.py:sp_kd_loss (Tung & Mori, ICCV 2019).
        self.sp_weight = 0.0
        self.batch_size = 32
        self.learning_rate = 1e-4
        self.epochs = 2
        self.teacher_checkpoint: Optional[str] = None
        self.teacher_exp_path: Optional[str] = None

    def _resolve_paths(self):
        if self.teacher_exp_path is None:
            self.teacher_exp_path = self.stage_path("teacher_training", self.teacher_exp_name)

    def resolve_teacher_path(self) -> str:
        return self.teacher_exp_path


class PruningConfig(BaseConfig):
    """Stage 3: structured pruning + fine-tune (reference `p_config.py`)."""

    stage_name = "pruning"

    def _stage_defaults(self):
        self.source_exp_name = "test"
        self.model_name = "resnet18"
        # Pruning hyperparameters (reference `p_config.py:30-34`)
        self.pruning_ratio = 0.05
        self.pruning_type = "structured"
        # 'l1'|'l2'|'random'|'taylor'|'group_norm' (reference menu)
        # + 'bn_act'|'apoz' (activation-based; compress/prune/importance.py)
        self.pruning_method = "l2"
        self.global_pruning = False
        # pruned channel counts kept at multiples of round_to (8 keeps the
        # int8 kernels' 16-byte rows whole)
        self.round_to = 1
        self.finetune_epochs = 0
        # Iterative (gradual) pruning: split pruning_ratio across K
        # prune -> fine-tune cycles, each keeping (1-ratio)^(1/K) of the
        # current channels so the compounded total matches a one-shot run.
        self.iterative_steps = 1
        self.iterative_ft_epochs = 1  # fine-tune epochs BETWEEN steps
        # Re-estimate BN running stats on train data right after pruning
        # (train/bn_recal.py); stale stats collapse eval accuracy at
        # aggressive ratios.
        self.bn_recalibrate = True
        self.bn_recal_batches = 16
        # Taylor criterion: loss gradients averaged over this many train
        # batches before ranking (one batch is noise-dominated).
        self.taylor_batches = 8
        self.learning_rate = 1e-5
        self.batch_size = 64
        self.student_exp_path: Optional[str] = None

    def _resolve_paths(self):
        if self.student_exp_path is None:
            self.student_exp_path = self.stage_path("knowledge_distillation",
                                                    self.source_exp_name)

    def _debug_shrink(self):
        # Reference `p_config.py:69-72`
        self.num_folds = 1
        self.fold_id = 0
        self.finetune_epochs = 1
        self.batch_size = 2
        self.synthetic_size = 64


class QuantConfig(BaseConfig):
    """Stage 4: post-training quantization (reference `q_config.py`)."""

    stage_name = "quantization"

    def _stage_defaults(self):
        self.model_type = "pruned"  # 'teacher' | 'student' | 'pruned'
        self.student_model = "resnet18"
        self.teacher_model = "resnet50"
        self.teacher_exp_name = "test"
        self.student_exp_name = "test"
        self.pruning_exp_name = "test"
        self.batch_size = 32
        # static-INT8 calibration takes at most this many train images of the
        # fold (reference `quantization/main.py:157`); num_calibration_batches
        # is the reference's dead field, kept for the overrides
        self.num_calibration_batches = 10
        self.calibration_images = 256
        # activation-range estimator: 'minmax' (EMA, reference parity) |
        # 'percentile' | 'entropy' (KL); compress/quant/calib.py
        self.observer = "minmax"
        self.percentile = 99.99  # only read by observer='percentile'
        # accuracy tools: QAT epochs before each static and weight-only
        # conversion (compress/quant/qat.py), AdaRound iterations on the
        # calibration split (adaround.py), the per-tap sensitivity sweep and
        # the automix search (sensitivity.py, automix.py), each a CSV
        self.qat_epochs = 0
        self.qat_lr = 1e-5
        self.adaround_iters = 0
        self.adaround_lr = 1e-2
        self.adaround_reg = 0.01
        self.methods = ("static_int8", "dynamic_int8", "fp16", "weight_only_int8")
        self.sensitivity = False
        self.automix = False
        self.automix_budget = 0.01
        self.automix_max_taps = 8
        self.fold_id = 0
        self.teacher_exp_path: Optional[str] = None
        self.student_exp_path: Optional[str] = None
        self.pruning_exp_path: Optional[str] = None

    def _resolve_paths(self):
        if self.teacher_exp_path is None:
            self.teacher_exp_path = self.stage_path("teacher_training", self.teacher_exp_name)
        if self.student_exp_path is None:
            self.student_exp_path = self.stage_path("knowledge_distillation",
                                                    self.student_exp_name)
        if self.pruning_exp_path is None:
            self.pruning_exp_path = self.stage_path("pruning", self.pruning_exp_name)
