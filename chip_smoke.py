#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU, end to end, on every served path.

Run from the repository root: ``python3 chip_smoke.py``. It

1. builds the CUDA kernels from ``inference_efficient_vision_models_tpu_torch/csrc``
   (nvcc for sm_90a, one process per source, all at once, at first use) and
   prints the card's name and power limit;
2. ResNet18 path (the committed static-INT8 pruned ResNet18):
   (a) holds each kernel against its plain PyTorch version on the card, at
   every shape the served model gives it (batch 256, and batch 1 for kernel
   A) and at odd shapes (kernel A over K 13..4104, N 6..1280, its 36
   input/activation/output routes, offset views and rounding ties; kernel B
   over C 3..456, ragged M and O, with and without the residual epilogue
   that ends a basic block, and its requant at rounding ties); kernels A and
   B must equal their plain versions bit for bit;
   serves the artifact through ``Predictor.from_artifact`` (requests of 1, 8
   and 2x256 images) with the launch counters set to 0 just before and read
   just after, and checks (d) 13 direct-3x3 and 8 int8-matmul launches per
   forward, (b) the logits against the plain path on the card and (c) the
   JAX package's golden logits committed in ``testdata/``;
3. EfficientNet-B0 path (the committed static-INT8 EfficientNet-B0, served by
   the fused-MBConv executor): (a) kernel C against its plain version, bit
   for bit, at the 16 block shapes (batch 256) and at odd shapes, its
   project and SE-gate launches alone at their edges (``PROJECT_EDGES``,
   ``SE_EDGES``), with each block's three launches timed apart
   (``port_block_launches.launch_ms``) beside each launch's own bound (``launch_bounds``, on
   every fused path: ``eff_c_launches``),
   kernel A at its 3 shapes (batch 256 and 1);
   (a') every block's int8 output on 8 golden images with teacher forcing
   (kernel and plain fed the same plain-path input), the check that decides
   correctness; (c') every block against the JAX package's own block outputs
   (``testdata``); serving as above with (d) 16 fused-block calls and 3
   int8-matmul launches per forward, (b) and (c) with logit tolerances
   relative to the logit scale;
3b. EfficientNet-B0's unfused and mixed executors (PR 10): the committed
   artifact served by the unfused executor (``Predictor``, 34 int8-matmul +
   16 int8-depthwise launches per forward, logits against the plain path
   and the JAX golden) and both executors timed; kernel E (``dwconv_int8``)
   against its plain version, max abs err 0, at the 16 depthwise calls
   (batch 256, timed beside its bound and the bound's share of the time)
   and at odd shapes (C 1, 8, 13, 1,152; odd H and W; k 5 stride 2 at
   every border class; zero points 0, 128 and 255);
4. ViT-Tiny path (the committed static-INT8 ViT-Tiny/16, and the float ViT
   from the same seeded weights): (a) kernel D (dense + GELU) against its
   plain version at odd shapes (offset views among them, both bf16 routes)
   and at the served mlp1 shapes in bf16 and fp32, kernel A at every ViT
   shape of both carriers (batch 256 and 1); serves both int8 carriers
   (``static_int8``, ``static_int8_bf16``) as above with (d) 50
   int8-matmul launches per forward, and runs the float forward with the
   fused mlp1 + GELU with (d) 12 kernel-D launches per forward; (b) kernel
   path against plain path on 32 images and (c) against the JAX golden of
   each route;
5. stages 1-2 (the float ResNet and its training; cuDNN and cuBLAS, no
   custom kernel): rebuilds the r2 held-out split from the artifact's data
   protocol (sha256 against ``testdata``), evaluates the committed pruned
   fp32 ResNet18 through ``load_stage_model`` in fp32 (TF32 off) and bf16
   against the JAX goldens, and beside the int8 path; holds one fp32 CE step
   of ResNet50 and one KD step of ResNet18 (gradients, BN statistics, the
   AdamW update and moments) against a JAX golden; then, in a process of
   its own, times 50 bf16 teacher and KD steps, trains a ResNet50 teacher
   (bf16, batch 64, fold 0, one epoch) and distills a ResNet18 from it
   (batch 32) through the port's stage CLIs, reads both checkpoints back
   and re-evaluates them with ``choice=2``, and profiles both steps;
6. stages 3-4: in the same process and artifacts root, prunes the student
   (l2, ratio 0.11, round_to 8, one fine-tune epoch) and quantizes it (the
   default four methods and W4A16, 256 calibration images) through the port's stage
   CLIs, then ``choice=2`` of each; the kernel launch counts are set to 0
   before the stage chain and read after it (kernels A and B must have run);
   the chain's INT8 ResNet18 is held against its plain path bit for bit on
   32 images and, in the main process, at each kernel call of its forward.
   ``convert_r2`` folds, calibrates and converts the committed pruned r2
   checkpoint on the card against the JAX package's CPU conversion
   (``testdata/r2_convert_jax.json``), records how far each fp32
   calibration lies from an fp64 one, and serves both artifacts on the r2
   held-out split;
7. times each kernel at its serving shapes beside its plain version, its
   bound and a library call where one exists, and each forward at batch 1
   and 256 with CUDA events (median of 25 runs after warm-up), and profiles
   a batch-256 forward of each path with ``torch.profiler``;
7b. this slice's stages 1-4 on EfficientNet-B0 (PR 10): one fp32 CE step
   and one KD step of B0 at 64x64 against a JAX golden
   (``effnet_train_step_golden``); a seeded B0 recalibrated, calibrated and
   converted on the card against the JAX package's CPU record
   (``convert_effnet``); in the training process, after the ResNet chain,
   B0 teacher -> KD -> prune (l2, 0.2, round_to 8) -> quantize (six
   methods) through the port's CLIs at 224x224 (``effnet_chain``); then the
   chain's INT8 model served by the unfused, fused and mixed executors,
   each against its own plain path, launches counted per forward, fused
   blocks against unfused ones, and kernels A, C and E at its shapes
   (``effnet_chain_int8``);
8. the deployment entry points: ``serve_rates`` serves r2 through
   ``Predictor`` at batch 256 three ways (host s2d by numpy, host s2d by
   the native row interleave, ``device_preprocess=True``; logits identical,
   and through ``predict_stream``); ``server_r2`` runs the HTTP server
   (``InferenceServer`` -> ``MicroBatcher`` -> ``Predictor``) at the JAX
   package's defaults under 8 clients x 40 requests, holds every answer to
   ``Predictor.predict_logits`` (the ResNet18 limit, bit-identical rows
   counted), the launches to 8 + 13 per batch the server ran, and sends
   each payload kind and error status; ``server_eff`` and ``server_vit``
   serve one 8-image request each through kernel C and kernel A;
   ``predict_cli`` runs ``python -m ….cli.predict`` over 300 seeded BMPs
   and an .npy against ``Predictor`` over ``load_images``; ``augment``
   holds ``apply_augment`` on the card to its CPU evaluation, and a timed
   teacher step with ``augment=True`` runs beside the stage-1 steps;
9. the ViT through stages 1-4: one fp32 CE step of ViT-S/16 and one
   KD step of ViT-Tiny/16 at 64x64 against a JAX golden
   (``vit_train_step_golden``); a seeded ViT-Tiny converted on the card
   against the JAX CPU record (``convert_vit``); kernel A's dynamic route
   (qparams read from a device buffer) at the dynamic INT8 ViT's 49 calls,
   timed, and at odd shapes, bit-exact; that forward under
   ``torch.cuda.set_sync_debug_mode("error")``, 49 launches, equal to its
   plain path and within ``VIT_DYN_TAU`` of the JAX golden
   (``vit_dynamic_logits``); a head-pruned ViT-Tiny (2 of 3 heads) on the
   three INT8 executors; in the training process ViT-S -> KD ViT-Tiny ->
   prune (l2 0.1, round_to 8) -> quantize (six methods) through the CLIs
   (``vit_chain``); the chain's model on the static fp32 and bf16 carriers
   and the dynamic executor through ``Predictor`` (A 50 / 50 / 49 a
   forward), its fp32, fp16, bf16 and W8A16 artifacts through ``Predictor``
   against their own ``apply_folded`` (``vit_float_serve``); and the CNN
   families' dynamic fc on kernel A's dynamic route against the float64
   formula it replaced, bit for bit (``dynamic_fc_route``);
10. the ResNeXt family and W4A16: a seeded resnext26_32x4d
   calibrated and converted on the card against the JAX CPU record
   (``convert_resnext``), served through ``Predictor`` (22 kernel-A and 8
   kernel-F launches per forward, equal to its plain path, within
   ``RX_TAU`` of the JAX golden); kernel F (``gconv_int8``, the int8
   grouped 3x3 conv + ReLU + requant) against its plain version, max abs
   err 0, at its 8 grouped calls (batch 256 and 1; timed beside its bound,
   its design bound (the mma's padded operations), the first design's time
   and cuDNN's fp16 grouped conv) and at odd shapes, zero points and requant
   ties (``gconv_shapes``), its fp32 quotient against the division over
   every y below the clip at each served output scale
   (``gconv_quotient``), kernel A at its 22 calls (``rx_a_shapes``); in
   the training process resnext50_32x4d -> KD resnext26_32x4d -> prune (l2
   0.11, round_to 8, whole lanes) -> quantize (five methods) through the
   CLIs (``rx_chain``); the chain's INT8 model through ``Predictor`` (A 22
   + F 8 a forward, equal to its plain path, timed beside its W8A16 and
   W4A16 forwards) and its kernel calls (``rx_chain_int8``); and every
   chain's ``weight_only_int4`` artifact through ``Predictor`` equal to its
   own ``apply_folded`` (``w4a16_serve``);
11. the stage-4 accuracy tools: one QAT step, one W4 QAT step and four
   AdaRound iterations of a seeded narrow ResNet against a JAX golden, and
   AdaRound's conversion contract (``qat_step_golden``); in the training
   process, after ``quantize_cli``, stage 4 again on the chain's pruned
   ResNet18 with one QAT epoch, 50 AdaRound iterations, the sensitivity
   sweep and automix (static INT8, W8A16, W4A16): every artifact restored,
   both CSVs, the QAT + AdaRound INT8 model's kernel path equal to its
   plain path with kernels A and B launched (the kernels line's path
   ``resnet18_accuracy_tools``), the contract on the card, each method's
   accuracy beside ``quantize_cli``'s and the tools' times
   (``accuracy_tools``); and one W4 QAT epoch on the ResNeXt chain's pruned
   resnext26 (``rx_w4_qat``);
12. deployment export, the mesh and the device profile: ``export_r2``
   exports the committed pruned ResNet18 (``export.export_quantized``: one
   ``torch.export`` program whose kernels are the ``ievm::*`` ops) at batch
   256 in the s2d and ``device_preprocess`` layouts and at batch 1, loads
   each container on the card, holds its logits on the r2 held-out images
   to the eager forward's bit for bit with kernels A and B launched inside
   the exported call, and times exported against eager, and the eager
   forward through the ops against direct launches (``export_r2_times``);
   ``export_families`` does the same for EfficientNet-B0 (fused: A and C;
   unfused: A and E), ViT-Tiny (``static_int8``, ``static_int8_bf16``,
   ``dynamic_int8``: A) and the seeded resnext26 (A and F);
   ``export_cpu_platform`` runs the batch-1 r2 container on the CPU against
   the CPU plain path; ``mesh_world1`` sets up a one-rank NCCL group (a
   FileStore, no port) and holds a full-width ResNet18 train step and
   ``Predictor(mesh=)`` to their one-process results, bit for bit;
   ``device_profile`` reads the r2 forward's kernels with
   ``metrics.device_profile.profile_device_ops``.

Results go to stdout as JSON lines; the line before the last gives the card
as nvidia-smi reports it and the last is ``{"ok": true, "device": ...}``.
Any failed check exits non-zero without that line; so does a machine with no
GPU. Needs one card.
"""

from __future__ import annotations

import base64
import contextlib
import http.client as http_client
import io
import json
import os
import queue
import struct
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from inference_efficient_vision_models_tpu_torch.ops import (
    _lib,
    conv3x3_s1_int8,
    conv3x3_s1_int8_plain,
    dense_gelu,
    dense_gelu_plain,
    fused_mbconv_block,
    fused_mbconv_block_plain,
    grouped_conv_int8,
    grouped_conv_int8_plain,
    int8_matmul_requant,
    int8_matmul_requant_plain,
    pack_weight,
    to_device_packed,
)
from inference_efficient_vision_models_tpu_torch.ops.gconv_int8 import gc_geom, quotient_check
from inference_efficient_vision_models_tpu_torch.ops.im2col import extract_patches_nhwc
from inference_efficient_vision_models_tpu_torch.serving import Predictor
from inference_efficient_vision_models_tpu_torch.utils.device import describe_device
from port_block_launches import LAUNCHES, launch_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(ROOT, "artifacts", "bench", "quantization", "r2", "fold_0")
TESTDATA = os.path.join(ROOT, "inference_efficient_vision_models_tpu_torch", "testdata")
GOLDEN = os.path.join(TESTDATA, "r2_fold0_jax_logits.npz")
EFF_ARTIFACT = os.path.join(TESTDATA, "effnet_b0_int8")
EFF_GOLDEN = os.path.join(TESTDATA, "effnet_b0_jax_logits.npz")
VIT_ARTIFACT = os.path.join(TESTDATA, "vit_tiny_int8")
VIT_GOLDEN = os.path.join(TESTDATA, "vit_tiny_jax_logits.npz")
PKG = "inference_efficient_vision_models_tpu_torch"
KERNEL_INFO = {
    "int8_matmul_requant": (f"{PKG}/csrc/int8_matmul.cu",
                            "inference_efficient_vision_models_tpu/ops/int8_matmul.py:87"),
    "conv3x3_s1_int8": (f"{PKG}/csrc/conv3x3.cu",
                        "inference_efficient_vision_models_tpu/ops/conv3x3.py:67"),
    "fused_mbconv_block": (f"{PKG}/csrc/fused_mbconv.cu",
                           "inference_efficient_vision_models_tpu/ops/fused_mbconv.py:222"),
    "dense_gelu": (f"{PKG}/csrc/fused_dense.cu",
                   "inference_efficient_vision_models_tpu/ops/fused_dense.py:77"),
    # not a Pallas kernel: the JAX package computes it with XLA
    "dwconv_int8": (f"{PKG}/csrc/dwconv_int8.cu",
                    "inference_efficient_vision_models_tpu/ops/dwconv_int8.py:50"),
    # not a Pallas kernel: XLA's grouped int8 conv with the ReLU + requant epilogue
    "gconv_int8": (f"{PKG}/csrc/gconv_int8.cu",
                   "inference_efficient_vision_models_tpu/compress/quant/qresnet.py:330"),
}
PLAIN = {"int8_matmul_requant": int8_matmul_requant_plain,
         "conv3x3_s1_int8": conv3x3_s1_int8_plain}
KERNEL = {"int8_matmul_requant": int8_matmul_requant, "conv3x3_s1_int8": conv3x3_s1_int8}
PER_FORWARD = {"int8_matmul_requant": 8, "conv3x3_s1_int8": 13}
# EfficientNet-B0: stem, head conv and fc on kernel A; 16 fused blocks with SE,
# each three launches (expand+depthwise, SE gate, project)
EFF_PER_FORWARD = {"int8_matmul_requant": 3, "fused_mbconv_block": 16 * 3}
# the unfused executor: stem, 15 expand, 16 project, head conv and fc on kernel
# A, 16 depthwise convs on kernel E; the mixed one: the same A, a bf16 depthwise
EFF_UNFUSED_PER_FORWARD = {"int8_matmul_requant": 34, "dwconv_int8": 16}
EFF_MIXED_PER_FORWARD = {"int8_matmul_requant": 34}
# MobileNetV2: the unfused executor runs the stem, 16 expand, 17
# project, the head conv and the fc on kernel A and 17 depthwise convs on
# kernel E (ReLU6); the fused one the stem, head conv and fc on kernel A and
# 17 blocks on kernel C, two launches each (no SE gate); the mixed one kernel
# A's 36 and a bf16 depthwise
MBV2_UNFUSED_PER_FORWARD = {"int8_matmul_requant": 36, "dwconv_int8": 17}
MBV2_FUSED_PER_FORWARD = {"int8_matmul_requant": 3, "fused_mbconv_block": 17 * 2}
MBV2_MIXED_PER_FORWARD = {"int8_matmul_requant": 36}
# ViT-Tiny int8 (either carrier): patch embed, 12 x (qkv, proj, mlp1, mlp2), head
VIT_PER_FORWARD = {"int8_matmul_requant": 50}
# float ViT-Tiny with fused_mlp: one mlp1 + GELU per block
VIT_FLOAT_PER_FORWARD = {"dense_gelu": 12}
# resnext26_32x4d int8: the stem, 8 x (conv1, conv3), 4 downsamples and the fc
# on kernel A; 8 grouped conv2 on kernel F
RX_PER_FORWARD = {"int8_matmul_requant": 22, "gconv_int8": 8}
BATCH = 256
RUNS = 25
STEP_RUNS = 50  # timed train steps of each model, in a row
SPIN_CYCLES = 2_000_000  # about 1 ms of GPU clock: longer than the host takes to enqueue a call
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
FP32_FMA_PER_S = 33.5e12    # H100 SXM: 67 TFLOP/s fp32 outside the tensor cores, 2 per FMA
FP64_FMA_PER_S = 33.5e12    # H100 SXM: 67 TFLOP/s fp64 on the tensor cores, 2 per FMA
# kernel F's first design (dp4a): ms per call at batch 256 and 1, by path
# and call, as PERF.md section 6 records them (H100 80GB HBM3, 700.00 W):
# each row's ``old_ms``
GC_OLD_MS = {
    ("resnext26_32x4d", 256): {"layer1.0.conv2": 0.1905, "layer1.1.conv2": 0.1921,
                               "layer2.0.conv2": 0.1925, "layer2.1.conv2": 0.1405,
                               "layer3.0.conv2": 0.1770, "layer3.1.conv2": 0.1249,
                               "layer4.0.conv2": 0.1348, "layer4.1.conv2": 0.1276},
    ("resnext26_32x4d", 1): {"layer1.0.conv2": 0.0091, "layer1.1.conv2": 0.0092,
                             "layer2.0.conv2": 0.0087, "layer2.1.conv2": 0.0084,
                             "layer3.0.conv2": 0.0091, "layer3.1.conv2": 0.0084,
                             "layer4.0.conv2": 0.0099, "layer4.1.conv2": 0.0096},
    ("resnext26_pipeline", 256): {"layer1.0.conv2": 0.1941, "layer1.1.conv2": 0.1941,
                                  "layer2.0.conv2": 0.6009, "layer2.1.conv2": 0.2986,
                                  "layer3.0.conv2": 0.7592, "layer3.1.conv2": 0.2388,
                                  "layer4.0.conv2": 0.1261, "layer4.1.conv2": 0.1145},
}
GC_OLD_RESNEXT50_MS = 2.3772  # its 16 calls, summed from the same rows
# EfficientNet logits: |served - reference| <= TAU * max|reference|, and the
# same argmax where the reference's top-2 margin exceeds twice that (PERF.md
# gives the measured values these were set from)
TAU_B = 0.05
TAU_C = 0.26
# ViT-Tiny logits, the same rule: against the JAX golden of each route, twice
# the worst deviation the CPU tests measure (fp32 float: summation order only,
# 1e-5); kernel path against plain path on the card, 0.05
VIT_TAU = {"int8_f32": 0.04, "int8_bf16_pair": 0.07, "float_f32": 1e-5, "float_bf16": 0.015}
VIT_TAU_B = 0.05
# stages 1-2 (the float ResNet and its training; no custom kernel on this path)
PRUNED = os.path.join(ROOT, "artifacts", "bench", "pruning", "r2", "fold_0")
FLOAT_GOLDEN = os.path.join(TESTDATA, "r2_fold0_float_jax_logits.npz")
SPLIT_SHA = os.path.join(TESTDATA, "r2_fold0_test_split.sha256")
TRAIN_GOLDEN = os.path.join(TESTDATA, "resnet_train_step_jax.npz")
# the pruned fp32 ResNet18 on the r2 split, the same rule as the ViT's: fp32
# tau 1e-5, as the float ViT's fp32 route (TF32 off: the summation order
# alone, ~3e-7; a TF32 conv would miss by ~1e-3); bf16 twice the 8.11e-4 the
# CPU measures (tests/test_torch_port_resnet_float.py)
R2_TAU = {"fp32": 1e-5, "bf16": 0.00163}
# one fp32 CE step of ResNet50 and one KD step of ResNet18 against it, batch 8
TRAIN_STEP = dict(teacher="resnet50", student="resnet18", seed=0, batch=8, size=224,
                  image_seed=0, alpha=0.5, temperature=4.0, lr=1e-3)
# leaves whose AdamW update the golden keeps whole (the stem conv, every
# BatchNorm scale and bias, the fc, the small 1x1 convs); every leaf's
# moments are kept as norms
UPDATE_LEAF_MAX = 16384
# twice the largest deviation the CPU measures between the port and the golden
# over both roles (``python tests/test_torch_port_train.py``: loss 1.61e-6,
# logits 4.66e-5 of the scale, a gradient leaf's norm 6.15e-3, a BN statistic's
# sum 3.72e-7 of its sum of magnitudes; a later run 4.96e-7, 3.49e-5, 4.78e-3,
# 3.93e-7, and a first moment's norm 6.36e-3, a second moment's 1.75e-2). The
# norms are the ill-conditioned part: BatchNorm's scale and bias gradients in
# ResNet50's early layers are sums over 8 x 56 x 56 values that cancel, and the
# JAX golden itself is 0.98% off the fp64 value on one of them
# (layer1/1/bn2/bias). The kept leaves' updates are
# held within 2 lr, plus the fp32 rounding of the parameters themselves
# (``update_slack_over_lr``): at step 1 m/sqrt(v) is +-1 for every nonzero
# gradient, so one near 0 may flip its update's sign (the CPU: 2.00009 lr)
TRAIN_LIMITS = {"loss_rel": 3.3e-6, "logits_over_scale": 9.4e-5, "grad_norm_rel": 0.0123,
                "bn_sum_over_abs_sum": 7.5e-7, "mu_norm_rel": 0.0128, "nu_norm_rel": 0.035,
                "update_dev_over_lr": 2.0}
# EfficientNet-B0's fp32 CE step (teacher role) and KD step (a B0 student from
# another seed against it), batch 8 at 64x64 (``testdata/effnet_train_step_jax.npz``,
# ``JAX_PLATFORMS=cpu python tests/test_torch_port_effnet_float.py`` writes it)
# The gradient of a block's project_bn bias is zero in exact arithmetic where
# the block's output feeds only the next conv and its train-mode BatchNorm
# (which removes a per-channel shift): those leaves hold rounding noise, ~1e-8
# of the largest leaf norm, so norms are held relative to at least 1e-4 of it
EFF_TRAIN_STEP = dict(teacher="efficientnet_b0", student="efficientnet_b0", seed=0,
                      student_seed=1, batch=8, size=64, image_seed=0, alpha=0.5,
                      temperature=4.0, lr=1e-3, norm_floor=1e-4)
EFF_TRAIN_GOLDEN = os.path.join(TESTDATA, "effnet_train_step_jax.npz")
# twice the port's CPU deviation from it, the largest over 1 to 8 intra-op
# threads (the writer prints it: loss 1.22e-6, logits 8.2e-6 of the scale, a
# gradient leaf's norm 4.28e-4 and a first moment's 4.28e-4 over the floor, a
# second moment's 4.52e-5, a BN statistic's sum 1.31e-7 of its sum of
# magnitudes, updates 1.99 lr)
EFF_TRAIN_LIMITS = {"loss_rel": 2.5e-6, "logits_over_scale": 1.7e-5, "grad_norm_rel": 8.6e-4,
                    "bn_sum_over_abs_sum": 2.7e-7, "mu_norm_rel": 8.6e-4, "nu_norm_rel": 9.1e-5,
                    "update_dev_over_lr": 2.0}
# the ViT's fp32 CE step (ViT-S/16, teacher role) and KD step (a ViT-Tiny/16
# against it), batch 8 at 64x64 (``testdata/vit_train_step_jax.npz``,
# ``JAX_PLATFORMS=cpu python tests/test_torch_port_vit_float.py`` writes it)
VIT_TRAIN_STEP = dict(teacher="vit_small_patch16_224", student="vit_tiny_patch16_224", seed=0,
                      student_seed=1, batch=8, size=64, image_seed=0, alpha=0.5,
                      temperature=4.0, lr=1e-3, norm_floor=1e-4)
VIT_TRAIN_GOLDEN = os.path.join(TESTDATA, "vit_train_step_jax.npz")
# twice the port's CPU deviation from it, the largest over 1 to 8 intra-op
# threads (the writer prints it: loss 5.49e-7, logits 1.23e-6 of the scale, a
# gradient leaf's norm 1.12e-6 and a first moment's 8.41e-7 over the floor, a
# second moment's 2.52e-6, updates 0.87 lr; a ViT has no BatchNorm), the
# update's limit 2 lr as in the other goldens: one sign flip of a near-zero
# gradient moves AdamW's first update by 2 lr
VIT_TRAIN_LIMITS = {"loss_rel": 1.1e-6, "logits_over_scale": 2.5e-6, "grad_norm_rel": 2.3e-6,
                    "bn_sum_over_abs_sum": 0.0, "mu_norm_rel": 1.7e-6, "nu_norm_rel": 5.1e-6,
                    "update_dev_over_lr": 2.0}
# stages 3-4: the JAX package's CPU conversion of the committed pruned r2
# checkpoint (minmax, the first 256 images of fold 0's train split, batch 32):
# activation qparams by value, every other leaf by sha256
# (``JAX_PLATFORMS=cpu python tests/test_torch_port_quant.py`` writes it)
CONVERT_GOLDEN = os.path.join(TESTDATA, "r2_convert_jax.json")
# a scale within twice the port's CPU deviation from that golden (5.375e-7
# relative, layer1/0/conv1/out_scale: the fp32 convs of the calibration
# forwards sum in another order in oneDNN than in XLA, and the EMA of the
# tap's max carries it); every other leaf equal
CONVERT_LIMITS = {"scale_rtol": 1.075e-6}

# this slice's conversion: a seeded EfficientNet-B0 (effnet_params_from_seed),
# its BN statistics recalibrated and its activations calibrated (minmax) on
# seeded surrogate images, converted to static INT8 at 224x224. The JAX
# package's CPU run is the record (``testdata/effnet_b0_convert_jax.json``,
# qparams + per-leaf sha256) beside the BN statistics it recalibrated
# (``effnet_b0_convert_state_jax.npz``), from which the card converts so
# that every non-activation leaf can be held equal; the card's own
# recalibration is held to those statistics
# (``JAX_PLATFORMS=cpu python tests/test_torch_port_effnet_quant.py`` writes both)
EFF_CONVERT = dict(seed=0, size=224, per_class=8, image_seed=5, batch=16)
EFF_CONVERT_GOLDEN = os.path.join(TESTDATA, "effnet_b0_convert_jax.json")
EFF_CONVERT_STATE = os.path.join(TESTDATA, "effnet_b0_convert_state_jax.npz")
# scales within twice the port's CPU deviation from the record, the largest
# over 1 to 8 intra-op threads (2.52e-6, stage6/0/out_scale: the fp32
# calibration forwards sum in another order); recalibrated statistics within
# fp32 1e-5 of each leaf's scale, the stage-3 tests' limit (the CPU: 2.49e-6)
EFF_CONVERT_LIMITS = {"scale_rtol": 5.0e-6, "recal_rtol": 1e-5}
# MobileNetV2: the same protocol on a seeded full-width MobileNetV2
# (mbv2_params_from_seed) at 224x224 (``testdata/mbv2_convert_jax.json`` and
# ``mbv2_convert_state_jax.npz``), then the JAX package's unfused and mixed
# executors on 8 seeded 224x224 images (``testdata/mbv2_jax_logits.npz``), run
# op by op on the CPU from that conversion
# (``JAX_PLATFORMS=cpu python tests/test_torch_port_mbv2_quant.py`` writes all three)
MBV2_CONVERT = dict(seed=0, size=224, per_class=8, image_seed=5, batch=16)
MBV2_CONVERT_GOLDEN = os.path.join(TESTDATA, "mbv2_convert_jax.json")
MBV2_CONVERT_STATE = os.path.join(TESTDATA, "mbv2_convert_state_jax.npz")
MBV2_GOLDEN = os.path.join(TESTDATA, "mbv2_jax_logits.npz")
MBV2_GOLDEN_IMAGES = dict(seed=3, n=8)
# scales: twice the record's own fp32 error against an fp64 calibration of
# the same images (1.94e-6, stage5/0/out_scale; the writer prints it): a
# second fp32 computation that sums in another order may sit as far on the
# other side. (Twice the port's CPU deviation, 9.22e-7 over 1 to 8 threads,
# was the first limit; the card's calibration, PyTorch's CUDA convs with
# cuDNN off, measured 2.52e-6 at that scale.) ``calib_spread.py`` measures
# the card against this record and another seed's: on an H100 the fp32 runs
# repeat exactly and read 2.52e-6 and 2.46e-6, the card's own fp32 error
# against its fp64 run is 1.49e-6 and 2.46e-6, and calibrating in fp16 or
# bf16 reads 8.8e-3 to 8.7e-2, which the limit refuses. The recalibrated
# statistics: twice the CPU's 3.82e-5 of a leaf's scale (17 blocks of
# train-mode sums)
MBV2_CONVERT_LIMITS = {"scale_rtol": 3.9e-6, "recal_rtol": 7.7e-5}
# a seeded full-width ViT-Tiny/16 converted at 224x224 on 48 surrogate images
# (minmax, batch 16) by the JAX package run op by op on the CPU
# (``testdata/vit_tiny_convert_jax.json``), and its dynamic INT8 logits on 8
# seeded images (``testdata/vit_tiny_dynamic_jax_logits.npz``); both written by
# ``JAX_PLATFORMS=cpu python tests/test_torch_port_vit_quant.py``
VIT_CONVERT = dict(seed=0, size=224, per_class=8, image_seed=5, batch=16)
VIT_CONVERT_GOLDEN = os.path.join(TESTDATA, "vit_tiny_convert_jax.json")
VIT_DYN_GOLDEN = os.path.join(TESTDATA, "vit_tiny_dynamic_jax_logits.npz")
VIT_DYN_IMAGES = dict(seed=3, n=8)
# scales within twice the CPU port's deviation from the record (6.88e-7 at 1-8
# threads; the record's own fp32 error against an fp64 calibration: 4.91e-7);
# the dynamic logits within twice the CPU port's 0.0167 of the logit scale
# (XLA and torch round LayerNorm, softmax, the attention products and erfc at
# other places; an activation within that rounding of an edge of a per-batch
# quantize moves one quantum, and the 48 dynamic layers of a random-init
# model carry such flips to the logits)
VIT_CONVERT_LIMITS = {"scale_rtol": 1.4e-6}
VIT_DYN_TAU = 0.034
# a seeded full-width resnext26_32x4d (resnet_params_from_seed) converted at
# 224x224 on 48 surrogate images (minmax, batch 16) by the JAX package on the
# CPU (``testdata/resnext26_convert_jax.json``: qparams by value, every other
# leaf by sha256), and its static INT8 logits on 8 seeded images by the JAX
# package's executor run op by op (``impl="lax"``,
# ``testdata/resnext26_int8_jax_logits.npz``); both written by
# ``JAX_PLATFORMS=cpu python tests/test_torch_port_resnext_quant.py``
RX_CONVERT = dict(seed=0, size=224, per_class=8, image_seed=5, batch=16)
RX_CONVERT_GOLDEN = os.path.join(TESTDATA, "resnext26_convert_jax.json")
RX_GOLDEN = os.path.join(TESTDATA, "resnext26_int8_jax_logits.npz")
RX_GOLDEN_IMAGES = dict(seed=3, n=8)
# scales within twice the record's own fp32 error against an fp64 calibration
# of the same images (5.41e-7, layer2/1/conv1/out_scale; the CPU port sits
# 4.68e-7 from the record at 1 to 8 threads); logits (the card's integer
# leaves with the record's activation qparams) within twice the CPU port's
# 0.00351 of the logit scale at 1 to 8 threads (kernel A requantizes the 1x1
# convs by 1/s_y, JAX's lax path divides: ties round one quantum apart);
# both set before the card's first reading
RX_CONVERT_LIMITS = {"scale_rtol": 1.082e-6}
RX_TAU = 0.0071
# the unfused and mixed logits against the JAX goldens: the CPU measures 0 for
# both (every operation is the JAX executor's, the mixed depthwise sums of
# bf16 products are exact in fp32 in any order: reversed taps measure 0 too),
# so the card may differ only where a reduction's order moves the fc's
# quantized input (the mean pool): by one fc quantum, in_scale * max w_scale *
# 127 (1.8e-4 of the logit scale) per flipped feature; held within two
MBV2_FC_QUANTA = 2


class SmokeFailure(RuntimeError):
    pass


# The ViT-Tiny's float weights are not committed: both packages draw them
# from a seed with this function (the test data script imports it from here).
VIT_SEED = 0
VIT_HEAD_STD = 0.25  # at 0.02 the logits would stay within ~0.3 of each other


def vit_params_from_seed(spec, seed: int) -> dict:
    """ViT parameters in the JAX layout (HWIO patch embed, (in, out) linears):
    nested dicts of fp32 numpy arrays drawn leaf by leaf, in this order, from
    ``np.random.default_rng(seed)`` as clip(N(0, 1), -2, 2) * std: std 0.02 for
    every weight, bias and LayerNorm bias, 1 + that for LayerNorm scales, and
    ``VIT_HEAD_STD`` for the head weight."""
    rng = np.random.default_rng(seed)

    def draw(shape, std=0.02, mean=0.0):
        return (mean + np.clip(rng.standard_normal(shape), -2.0, 2.0) * std).astype(np.float32)

    def ln(d):
        return {"scale": draw((d,), mean=1.0), "bias": draw((d,))}

    def linear(cin, cout, std=0.02):
        return {"w": draw((cin, cout), std), "b": draw((cout,))}

    d = spec.dim
    params = {
        "patch_embed": {"w": draw((spec.patch, spec.patch, spec.in_chans, d)), "b": draw((d,))},
        "cls_token": draw((1, 1, d)),
        "pos_embed": draw((1, spec.tokens, d)),
        "norm": ln(d),
        "head": linear(d, spec.num_classes, VIT_HEAD_STD),
        "blocks": {},
    }
    for i in range(spec.depth):
        attn = spec.block_heads(i) * spec.head_dim
        hidden = spec.block_mlp_hidden(i)
        params["blocks"][str(i)] = {
            "ln1": ln(d), "qkv": linear(d, 3 * attn), "proj": linear(attn, d),
            "ln2": ln(d), "mlp1": linear(d, hidden), "mlp2": linear(hidden, d),
        }
    return params


def resnet_params_from_seed(spec, seed: int):
    """ResNet (params, BN state) in the JAX layout (HWIO convs, (in, out) fc):
    nested dicts of fp32 numpy arrays drawn leaf by leaf, in the JAX init's
    order, from ``np.random.default_rng(seed)``: convs N(0, 2 / fan_out)
    (Kaiming, fan_out), BN scale 1 + 0.1 N, bias 0.1 N, running mean 0.1 N,
    running var 1 + 0.1 |N|, the fc weight and bias U(±1/sqrt(in))."""
    rng = np.random.default_rng(seed)

    def conv(kh, kw, cin, cout):
        std = (2.0 / (kh * kw * cout)) ** 0.5
        return {"w": (rng.standard_normal((kh, kw, cin, cout)) * std).astype(np.float32)}

    def bn(c):
        def n():
            return rng.standard_normal(c)
        p = {"scale": (1 + 0.1 * n()).astype(np.float32), "bias": (0.1 * n()).astype(np.float32)}
        s = {"mean": (0.1 * n()).astype(np.float32),
             "var": (1 + 0.1 * np.abs(n())).astype(np.float32)}
        return p, s

    params, state = {"conv1": conv(7, 7, spec.in_chans, spec.stem_width)}, {}
    params["bn1"], state["bn1"] = bn(spec.stem_width)
    for si, depth in enumerate(spec.depths):
        lp, ls = {}, {}
        for b in range(depth):
            cin, cout = spec.block_in_width(si, b), spec.stage_widths[si]
            inner = spec.inner_widths[si][b]
            bp, bs = {}, {}
            if spec.block == "basic":
                shapes = [(3, 3, cin, inner[0]), (3, 3, inner[0], cout)]
            else:
                shapes = [(1, 1, cin, inner[0]), (3, 3, inner[0] // spec.groups, inner[1]),
                          (1, 1, inner[1], cout)]
            for c, shape in enumerate(shapes, 1):
                bp[f"conv{c}"] = conv(*shape)
                bp[f"bn{c}"], bs[f"bn{c}"] = bn(shape[-1])
            if spec.has_downsample(si, b):
                bp["down_conv"] = conv(1, 1, cin, cout)
                bp["down_bn"], bs["down_bn"] = bn(cout)
            lp[str(b)], ls[str(b)] = bp, bs
        params[f"layer{si + 1}"], state[f"layer{si + 1}"] = lp, ls
    cin = spec.stage_widths[-1]
    bound = cin ** -0.5
    params["fc"] = {"w": rng.uniform(-bound, bound, (cin, spec.num_classes)).astype(np.float32),
                    "b": rng.uniform(-bound, bound, spec.num_classes).astype(np.float32)}
    return params, state


def effnet_params_from_seed(spec, seed: int):
    """EfficientNet (params, BN state) in the JAX layout (HWIO convs, a
    depthwise kernel (k, k, 1, C), (in, out) SE and fc matrices): nested dicts
    of fp32 numpy arrays drawn leaf by leaf, in the JAX init's order, from
    ``np.random.default_rng(seed)``: convs N(0, 2 / fan_out) (Kaiming, fan_out;
    a depthwise kernel's fan is k*k), SE matrices N(0, 2 / out) with biases
    0.1 N, BN scale 1 + 0.1 N, bias 0.1 N, running mean 0.1 N, running var
    1 + 0.1 |N|, the fc weight U(±1/sqrt(classes)) and bias 0.1 N."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def conv(kh, kw, cin, cout, fan=None):
        return {"w": normal((kh, kw, cin, cout), (2.0 / (fan or kh * kw * cout)) ** 0.5)}

    def se(cin, cout):
        return {"w": normal((cin, cout), (2.0 / cout) ** 0.5), "b": normal((cout,), 0.1)}

    def bn(c):
        p = {"scale": (1 + normal((c,), 0.1)).astype(np.float32), "bias": normal((c,), 0.1)}
        s = {"mean": normal((c,), 0.1),
             "var": (1 + 0.1 * np.abs(rng.standard_normal(c))).astype(np.float32)}
        return p, s

    params, state = {"stem": conv(3, 3, spec.in_chans, spec.stem_width)}, {}
    params["stem_bn"], state["stem_bn"] = bn(spec.stem_width)
    for si, depth in enumerate(spec.depths):
        k = spec.stage_kernels[si]
        lp, ls = {}, {}
        for b in range(depth):
            cin, h = spec.block_in_width(si, b), spec.hidden_widths[si][b]
            cout, sq = spec.stage_widths[si], spec.se_widths[si][b]
            bp, bs = {}, {}
            if spec.has_expand[si][b]:
                bp["expand"] = conv(1, 1, cin, h)
                bp["expand_bn"], bs["expand_bn"] = bn(h)
            bp["dw"] = conv(k, k, 1, h, fan=k * k)
            bp["dw_bn"], bs["dw_bn"] = bn(h)
            bp["se_reduce"], bp["se_expand"] = se(h, sq), se(sq, h)
            bp["project"] = conv(1, 1, h, cout)
            bp["project_bn"], bs["project_bn"] = bn(cout)
            lp[str(b)], ls[str(b)] = bp, bs
        params[f"stage{si}"], state[f"stage{si}"] = lp, ls
    params["last"] = conv(1, 1, spec.stage_widths[-1], spec.last_width)
    params["last_bn"], state["last_bn"] = bn(spec.last_width)
    bound = spec.num_classes ** -0.5
    params["fc"] = {"w": rng.uniform(-bound, bound, (spec.last_width, spec.num_classes))
                    .astype(np.float32), "b": normal((spec.num_classes,), 0.1)}
    return params, state


def mbv2_params_from_seed(spec, seed: int):
    """MobileNetV2 (params, BN state) in the JAX layout (HWIO convs, a
    depthwise kernel (3, 3, 1, C), an (in, out) fc): nested dicts of fp32
    numpy arrays drawn leaf by leaf, in the JAX init's order, from
    ``np.random.default_rng(seed)``: convs N(0, 2 / fan_out) (Kaiming,
    fan_out; a depthwise kernel's fan is 9), BN scale 1 + 0.1 N, bias 0.1 N,
    running mean 0.1 N, running var 1 + 0.1 |N|, the fc weight
    U(±1/sqrt(classes)) and bias 0.1 N."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def conv(kh, kw, cin, cout, fan=None):
        return {"w": normal((kh, kw, cin, cout), (2.0 / (fan or kh * kw * cout)) ** 0.5)}

    def bn(c):
        p = {"scale": (1 + normal((c,), 0.1)).astype(np.float32), "bias": normal((c,), 0.1)}
        s = {"mean": normal((c,), 0.1),
             "var": (1 + 0.1 * np.abs(rng.standard_normal(c))).astype(np.float32)}
        return p, s

    params, state = {"stem": conv(3, 3, spec.in_chans, spec.stem_width)}, {}
    params["stem_bn"], state["stem_bn"] = bn(spec.stem_width)
    for si, depth in enumerate(spec.depths):
        lp, ls = {}, {}
        for b in range(depth):
            cin, h, cout = spec.block_in_width(si, b), spec.hidden_widths[si][b], \
                spec.stage_widths[si]
            bp, bs = {}, {}
            if spec.has_expand[si][b]:
                bp["expand"] = conv(1, 1, cin, h)
                bp["expand_bn"], bs["expand_bn"] = bn(h)
            bp["dw"] = conv(3, 3, 1, h, fan=9)
            bp["dw_bn"], bs["dw_bn"] = bn(h)
            bp["project"] = conv(1, 1, h, cout)
            bp["project_bn"], bs["project_bn"] = bn(cout)
            lp[str(b)], ls[str(b)] = bp, bs
        params[f"stage{si}"], state[f"stage{si}"] = lp, ls
    params["last"] = conv(1, 1, spec.stage_widths[-1], spec.last_width)
    params["last_bn"], state["last_bn"] = bn(spec.last_width)
    bound = spec.num_classes ** -0.5
    params["fc"] = {"w": rng.uniform(-bound, bound, (spec.last_width, spec.num_classes))
                    .astype(np.float32), "b": normal((spec.num_classes,), 0.1)}
    return params, state


def params_from_seed(spec, seed: int):
    """Seeded (params, BN state) in the JAX layout of a ResNet, an EfficientNet,
    a MobileNetV2 or a ViT (whose state is empty)."""
    from inference_efficient_vision_models_tpu_torch.models.efficientnet import EfficientNetSpec
    from inference_efficient_vision_models_tpu_torch.models.mobilenet import MobileNetV2Spec
    from inference_efficient_vision_models_tpu_torch.models.vit import ViTSpec

    if isinstance(spec, ViTSpec):
        return vit_params_from_seed(spec, seed), {}
    if isinstance(spec, EfficientNetSpec):
        return effnet_params_from_seed(spec, seed)
    if isinstance(spec, MobileNetV2Spec):
        return mbv2_params_from_seed(spec, seed)
    return resnet_params_from_seed(spec, seed)


def leaf_sums(tree) -> np.ndarray:
    """float64 sum of every leaf, in the tree's order: a fingerprint that makes
    a drifting copy of the parameters fail loudly."""
    if isinstance(tree, dict):
        return np.concatenate([leaf_sums(v) for v in tree.values()] or [np.zeros(0)])
    return np.array([np.sum(np.asarray(tree), dtype=np.float64)])


def flat_raw(tree, prefix=""):
    """A nested dict of arrays -> {"/a/b": numpy array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_raw(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


_ACT_QPARAMS = ("out_scale", "out_zp", "in_scale", "in_zp", "se_scale", "se_zp")


def conversion_record(qmodel, observers=None) -> dict:
    """A static-int8 conversion's record: every activation qparam by value,
    every other leaf by dtype, shape and sha256 (and the observers' ranges)."""
    import hashlib

    qparams, leaves = {}, {}
    for k, v in flat_raw(qmodel).items():
        if k.split("/")[-1] in _ACT_QPARAMS or k in ("/input/scale", "/input/zp"):
            qparams[k] = float(v) if v.dtype.kind == "f" else int(v)
        else:
            leaves[k] = {"dtype": v.dtype.name, "shape": list(v.shape),
                         "sha256": hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()}
    rec = {"qparams": qparams, "leaves": leaves}
    if observers is not None:
        rec["observers"] = {k: [float(o.min), float(o.max)] for k, o in observers.items()}
    return rec


def _tap_of(path: str) -> str:
    """The calibration tap whose range sets an activation qparam."""
    parts = path.strip("/").split("/")
    if parts[0] in ("input", "stem"):
        return parts[0]
    if parts[0] == "fc":
        return "feat"
    s, b = int(parts[0][5:]) - 1, parts[1]
    if parts[2] in ("conv1", "conv2"):
        return f"l{s}b{b}i{int(parts[2][4:]) - 1}"
    return f"l{s}b{b}o"


def _vit_tap_of(path: str) -> str:
    """The calibration tap of a ViT activation qparam: each dense layer's
    input (``b{i}qkv`` ... ``head``) or the image (``input``)."""
    parts = path.strip("/").split("/")
    if parts[0] in ("input", "head"):
        return parts[0]
    return f"b{parts[1]}{parts[2]}"


def _eff_tap_of(path: str) -> str:
    """The calibration tap of an EfficientNet activation qparam."""
    parts = path.strip("/").split("/")
    if parts[0] in ("input", "stem"):
        return parts[0]
    if parts[0] in ("last", "fc"):
        return {"last": "head", "fc": "feat"}[parts[0]]
    s, b = parts[0][5:], parts[1]
    if parts[2] in ("expand", "dw"):
        return f"s{s}b{b}{parts[2][0]}"
    return f"s{s}b{b}" + ("se" if parts[2].startswith("se_") else "o")


def compare_conversion(qmodel, ref: dict, limits=CONVERT_LIMITS, tap_of=_tap_of) -> dict:
    """A conversion (``serializable`` tree) against a reference record: every
    non-activation leaf equal, every scale within ``scale_rtol``, every zero
    point equal or one apart where the reference's -min/scale lies within
    that limit of a rounding edge (k + 1/2)."""
    got = conversion_record(qmodel)
    rt = limits["scale_rtol"]
    unequal = sorted(k for k in ref["leaves"] if got["leaves"].get(k) != ref["leaves"][k])
    extra = sorted(set(got["leaves"]) - set(ref["leaves"]))
    rel, worst, zp_edge, zp_bad = 0.0, None, [], []
    for k, r in ref["qparams"].items():
        g = got["qparams"].get(k)
        if g is None:
            zp_bad.append(k)
        elif isinstance(r, float):
            d = abs(g - r) / max(abs(r), 1e-30)
            if d > rel:
                rel, worst = d, k
        elif g != r:
            lo = min(ref["observers"][tap_of(k)][0], 0.0)
            scale = ref["qparams"][k.replace("zp", "scale")]
            frac = -lo / scale
            edge = abs(frac - (np.floor(frac) + 0.5)) <= rt * max(abs(frac), 1.0)
            (zp_edge if abs(g - r) == 1 and edge else zp_bad).append(k)
    return {"ok": not unequal and not extra and not zp_bad and rel <= rt,
            "leaves": len(ref["leaves"]), "leaves_unequal": unequal + extra,
            "qparams": len(ref["qparams"]), "max_scale_rel": rel, "worst_scale": worst,
            "zp_one_apart_on_edge": zp_edge, "zp_bad": zp_bad, "scale_rtol": rt}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, runs: int = RUNS, warm: int = 3, spin: bool = False) -> float:
    """Median time of one call, CUDA events around each call. A forward is
    timed as its caller sees it, host launch overhead included. A kernel
    (``spin=True``) is timed on the device alone: a spin kernel holds the
    stream while the host enqueues the start event, the call and the end
    event, so the events bracket only the call's device work."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(runs)]
    for s, e in ev:
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def compare(got: torch.Tensor, ref: torch.Tensor, atol: float = 1e-3):
    """-> (ok, max_abs_err) at the port's kernel tolerances: int8 within one
    quantum and >= 99% exact; fp32 rtol 1e-5 / ``atol``; bf16 within one
    bf16 ulp or ``atol``, whichever is larger."""
    if got.dtype == torch.int8:
        return compare_block(got, ref, 0.99)[:2]
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return False, float("inf")
    d = (got.float() - ref.float()).abs()
    err = float(d.max()) if d.numel() else 0.0
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(got.float().abs(), ref.float().abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        return bool((d <= ulp.clamp_min(atol)).all()), err
    return bool(torch.allclose(got, ref, rtol=1e-5, atol=atol)), err


# --------------------------------------------------------------------------
# the kernels' calls on the served path
# --------------------------------------------------------------------------


def main_path_calls(model, b: int):
    """Every kernel call of one forward of the basic-block ResNet at batch b:
    (kernel, label, x shape, x dtype, conv leaf, kwargs). Mirrors apply_int8."""
    spec, q = model.spec, model.q
    if spec.block != "basic":
        raise SmokeFailure("the smoke run serves the committed basic-block ResNet18")
    st = q["stem"]
    h = st["e4"].shape[1]
    calls = [("int8_matmul_requant", "stem", (b * h * h, st["w"].k), torch.int8, st,
              dict(in_scale=1.0, in_zp=128))]
    h = (h - 1) // 2 + 1  # max pool
    cin, in_s, in_z = spec.stem_width, st["out_scale"], st["out_zp"]
    for s, depth in enumerate(spec.depths):
        for bi in range(depth):
            blk = q[f"layer{s + 1}"][str(bi)]
            stride = spec.block_stride(s, bi)
            ho = (h - 1) // stride + 1
            c1, c2 = blk["conv1"], blk["conv2"]
            inner = c1["w"].n
            rq = dict(relu=True, out_scale=c1["out_scale"], out_zp=c1["out_zp"])
            tag = f"layer{s + 1}.{bi}"
            if "down" in blk:
                calls.append(("int8_matmul_requant", f"{tag}.down", (b * ho * ho, cin),
                              torch.int8, blk["down"], dict(in_scale=in_s, in_zp=in_z)))
            if stride == 1:
                calls.append(("conv3x3_s1_int8", f"{tag}.conv1", (b, h, h, cin), torch.int8, c1,
                              dict(in_scale=in_s, in_zp=in_z, **rq)))
            else:
                calls.append(("int8_matmul_requant", f"{tag}.conv1", (b * ho * ho, 9 * cin),
                              torch.int8, c1, dict(in_scale=in_s, in_zp=in_z, **rq)))
            # conv2 ends the block: its residual is the downsample's fp32 output
            # or the block's int8 input (made a tensor by with_residual)
            res = ("float32",) if "down" in blk else ("int8", in_s, in_z)
            calls.append(("conv3x3_s1_int8", f"{tag}.conv2", (b, ho, ho, inner), torch.int8, c2,
                          dict(in_scale=c1["out_scale"], in_zp=c1["out_zp"], residual=res,
                               out_scale=blk["out_scale"], out_zp=blk["out_zp"])))
            h, cin, in_s, in_z = ho, spec.stage_widths[s], blk["out_scale"], blk["out_zp"]
    fc = q["fc"]
    calls.append(("int8_matmul_requant", "fc", (b, fc["w"].k), torch.float32, fc,
                  dict(in_scale=fc["in_scale"], in_zp=fc["in_zp"])))
    return calls


def make_input(shape, dtype, in_zp: int, gen: torch.Generator) -> torch.Tensor:
    """Activations spread around the zero point, as a post-ReLU layer's are."""
    if dtype == torch.int8:
        v = torch.randn(shape, generator=gen, device="cuda") * 30 + (in_zp - 128 + 20)
        return v.round().clamp(-128, 127).to(torch.int8)
    return torch.randn(shape, generator=gen, device="cuda").abs() * 2


def with_residual(kw, shape, n: int, gen: torch.Generator):
    """``kw`` with a conv2 call's residual spec made a tensor of the output's
    shape: the block's int8 input around its zero point, or an fp32
    downsample output spread over the block's requant range."""
    spec = kw.get("residual")
    if spec is None:
        return kw
    rshape = (*shape[:3], n)
    if spec[0] == "int8":
        _, scale, zp = spec
        return dict(kw, residual=("int8", make_input(rshape, torch.int8, zp, gen), scale, zp))
    return dict(kw, residual=torch.randn(rshape, generator=gen, device="cuda")
                * (30 * kw["out_scale"]))


def cost(kernel: str, x: torch.Tensor, leaf, kw):
    """(bytes, int8 ops) the call must move and do: each input read once (a
    residual's identity too), each output written once; 2 ops per
    multiply-add of the GEMM."""
    n = leaf["w"].n
    if kernel == "conv3x3_s1_int8":
        m, k = x.numel() // x.shape[-1], 9 * x.shape[-1]
    else:
        m, k = x.shape
    out_bytes = 1 if kw.get("out_scale") is not None else \
        torch.empty((), dtype=kw.get("out_dtype", torch.float32)).element_size()
    res = kw.get("residual")
    res_bytes = 0 if res is None else m * n * (4 if isinstance(res, torch.Tensor) else 1)
    nbytes = x.numel() * x.element_size() + k * n + 3 * 4 * n + m * n * out_bytes + res_bytes
    return nbytes, 2 * m * k * n


def int_mm_ms(x: torch.Tensor, leaf):
    """torch._int_mm at the same (M, K, N), as the library yardstick (timing
    only; the port never calls it). K and N are zero-padded to multiples of 8,
    which leaves the product unchanged."""
    w = leaf["w"].kn()
    m, k = x.shape
    k8, n8 = (k + 7) // 8 * 8, (w.shape[1] + 7) // 8 * 8
    x8 = torch.zeros((m, k8), dtype=torch.int8, device=x.device)
    if x.dtype == torch.int8:
        x8[:, :k] = x
    w8 = torch.zeros((k8, n8), dtype=torch.int8, device=x.device)
    w8[:k, : w.shape[1]] = w
    try:
        torch._int_mm(x8, w8)
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return time_ms(lambda: torch._int_mm(x8, w8), spin=True), None


def compare_exact(got: torch.Tensor, ref: torch.Tensor):
    """-> (ok, max_abs_err): kernel A equals its plain version bit for bit."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return False, float("inf")
    err = float((got.float() - ref.float()).abs().max()) if got.numel() else 0.0
    return bool(torch.equal(got, ref)), err


def kernel_a_row(path: str, label: str, x: torch.Tensor, leaf, kw, *, batch: int = BATCH,
                 calls: int = 1, timed: bool = True, plain_runs: int = RUNS):
    """(a) kernel A at one served call, exact against its plain version, then
    (``timed``) its time beside the plain version's, its bound and
    torch._int_mm's. Rows off the batch-256 forward are left out of the
    kernels line."""
    args = (x, leaf["w"], leaf["w_scale"], leaf["bias"], leaf["w_sum"])
    ok, err = compare_exact(int8_matmul_requant(*args, **kw), int8_matmul_requant_plain(*args, **kw))
    nbytes, ops = cost("int8_matmul_requant", x, leaf, kw)
    row = {
        "path": path, "kernel": "int8_matmul_requant", "call": label, "batch": batch,
        "x": list(x.shape), "x_dtype": str(x.dtype)[6:], "n": leaf["w"].n, "max_abs_err": err,
        "bytes": nbytes, "ops": ops,
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / INT8_OPS_PER_S * 1e3,
        "calls": calls, "in_forward": batch == BATCH,
    }
    if timed:
        lib, lib_note = int_mm_ms(x, leaf)
        row.update({
            "ms": time_ms(lambda: int8_matmul_requant(*args, **kw), spin=True),
            "plain_ms": time_ms(lambda: int8_matmul_requant_plain(*args, **kw),
                                runs=plain_runs, spin=True),
            "library_ms": lib, **({"library_note": lib_note} if lib_note else {})})
    return row, [] if ok else [f"int8_matmul_requant {path} {label} {tuple(x.shape)} "
                               f"b{batch}: max abs err {err}"]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


# kernel A's routes: input dtype x activation x output (int8 requant, fp32, bf16)
A_ROUTES = [(xd, act, out) for xd in (torch.int8, torch.float32, torch.bfloat16)
            for act in (None, "relu", "gelu", "gelu_tanh")
            for out in (torch.int8, torch.float32, torch.bfloat16)]


# kernels A and B are held bit-exact
CHECK = {"int8_matmul_requant": compare_exact, "conv3x3_s1_int8": compare_exact}
# kernel B's odd shapes (N, H, W, C, O): every load width (C 3, 8, 16, 40, 72,
# 112, 456), ragged M and O, O not a multiple of 4, a window-streamed K
B_ODD_SHAPES = [(2, 12, 14, 8, 72), (3, 7, 9, 72, 56), (2, 5, 6, 3, 8), (2, 5, 6, 3, 6),
                (2, 9, 10, 16, 40), (3, 11, 9, 40, 112), (2, 13, 13, 112, 224),
                (1, 7, 7, 456, 456)]


def a_kwargs(act, out):
    kw = dict(in_scale=0.05, in_zp=113, act=act)
    return dict(kw, out_scale=0.04, out_zp=120) if out == torch.int8 else dict(kw, out_dtype=out)


def residual_ties(s_out: float, count: int) -> torch.Tensor:
    """``count`` fp32 values t >= 0 whose t / s_out is a half-integer, or one
    float above or below one, and a few extremes (zeros, a denormal, huge)."""
    s = torch.tensor(s_out, device="cuda")
    ties = ((torch.arange(0, 300, device="cuda", dtype=torch.float32) + 0.5) * s).float()
    vals = torch.cat([ties, torch.nextafter(ties, ties + 1), torch.nextafter(ties, ties - 1),
                      torch.tensor([0.0, -0.0, 1e-40, 3e38], device="cuda")])
    return vals.repeat(-(-count // vals.numel()))[:count]


def check_odd_shapes(gen: torch.Generator):
    """(a) at shapes off the served path. Kernel A, bit-exact: K from 13 to
    4104 (element, 4-byte, contiguous-row and vector loads; whole panel and
    windows) by N from 6 to 1280, M in {1, 197, 1000}, the 36 routes between
    them; activations at odd offsets; quotients at rint's ties. Kernel B,
    bit-exact: C of 3, 8, 16, 40, 72, 112 and 456 (every load width), ragged
    M and O (O not a multiple of 4), fp32 out, requant + ReLU, and both
    residual kinds; its residual requant at rint's ties (zero weights, so the
    quotient is the identity's over s_out)."""
    errs, fails = {k: 0.0 for k in KERNEL}, []

    def leaf(shape):
        wq = torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        n = shape[-1]
        return {"w": pack_weight(wq),
                "w_scale": torch.rand(n, generator=gen, device="cuda") * 0.009 + 0.001,
                "bias": torch.randn(n, generator=gen, device="cuda"),
                "w_sum": wq.reshape(-1, n).int().sum(0, dtype=torch.int32)}

    def act_input(m, k, dtype):
        if dtype == torch.int8:
            return torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        return (torch.randn((m, k), generator=gen, device="cuda") * 3).to(dtype)

    cases = []
    for i, k in enumerate((13, 27, 192, 504, 768, 1280, 2016, 4104)):
        for j, n in enumerate((6, 37, 192, 456, 576, 768, 1000, 1280)):
            m = (1, 197, 1000)[(i + j) % 3]
            xd, act, out = A_ROUTES[(8 * i + j) % len(A_ROUTES)]
            cases.append(("int8_matmul_requant", f"{m}x{k}x{n}", act_input(m, k, xd), leaf((k, n)),
                          a_kwargs(act, out)))
    for k in (13, 27, 504):  # an odd element offset, and one row of odd K in
        lf = leaf((k, 37))
        for xd in (torch.int8, torch.float32, torch.bfloat16):
            flat = act_input(1, 301 * k + 1, xd)[0]
            for x in (flat[1 : 1 + 300 * k].view(300, k), flat[k : 301 * k].view(300, k)):
                cases.append(("int8_matmul_requant", f"view+{x.storage_offset()} 300x{k}x37", x,
                              lf, a_kwargs("gelu", torch.int8)))
    s = torch.tensor(0.05, device="cuda")
    ties = ((torch.arange(-300, 300, device="cuda", dtype=torch.float32) + 0.5) * s).float()
    ties = torch.cat([ties, torch.nextafter(ties, ties + 1), torch.nextafter(ties, ties - 1)])
    ties = ties[: ties.numel() // 64 * 64]
    lf = leaf((64, 24))
    for xd in (torch.float32, torch.bfloat16):
        cases.append(("int8_matmul_requant", "rounding ties", ties.reshape(-1, 64).to(xd), lf,
                      dict(in_scale=0.05, in_zp=128)))
    for (n, h, w, c, o) in B_ODD_SHAPES:
        lf = leaf((3, 3, c, o))
        x = torch.randint(-128, 128, (n, h, w, c), generator=gen, device="cuda",
                          dtype=torch.int8)
        ident = torch.randint(-128, 128, (n, h, w, o), generator=gen, device="cuda",
                              dtype=torch.int8)
        down = torch.randn((n, h, w, o), generator=gen, device="cuda") * 2
        rq = dict(out_scale=0.05, out_zp=100)
        for kw in [dict(), dict(relu=True, out_scale=0.05, out_zp=110),
                   dict(residual=("int8", ident, 0.04, 120), **rq), dict(residual=down, **rq)]:
            cases.append(("conv3x3_s1_int8", f"{n}x{h}x{w}x{c}->{o}", x, lf,
                          dict(in_scale=0.03, in_zp=150, **kw)))
    for o in (30, 32):  # the residual requant's quotient on and beside rint's ties
        zero = {"w": pack_weight(torch.zeros((3, 3, 8, o), dtype=torch.int8, device="cuda")),
                "w_scale": torch.full((o,), 0.01, device="cuda"),
                "bias": torch.zeros(o, device="cuda"),
                "w_sum": torch.zeros(o, dtype=torch.int32, device="cuda")}
        for s_out in (0.05, 0.0123):
            t = residual_ties(s_out, 2 * 5 * 6 * o).reshape(2, 5, 6, o)
            cases.append(("conv3x3_s1_int8", f"residual ties s_out {s_out} O {o}",
                          torch.zeros((2, 5, 6, 8), dtype=torch.int8, device="cuda"), zero,
                          dict(in_scale=0.03, in_zp=150, residual=t, out_scale=s_out, out_zp=3)))
    for kernel, label, x, lf, kw in cases:
        args = (x, lf["w"], lf["w_scale"], lf["bias"], lf["w_sum"])
        ok, err = CHECK[kernel](KERNEL[kernel](*args, **kw), PLAIN[kernel](*args, **kw))
        errs[kernel] = max(errs[kernel], err)
        if not ok:
            fails.append(f"{kernel} {label} {x.dtype} {kw}: max abs err {err}")
    emit({"phase": "a_odd_shapes", "checks": len(cases), "max_abs_err": errs, "failed": fails})
    return fails


def call_key(row) -> tuple:
    """What a kernel call's time depends on: its kernel, shapes and epilogue."""
    return (row["kernel"], row["batch"], tuple(row["x"]), row.get("x_dtype"), row["n"],
            row.get("residual"))


def check_and_time_main_shapes(model, gen: torch.Generator, path: str = "resnet18",
                               timed_rows=()):
    """(a) at every served shape (batch 256; kernel A at batch 1 too), then
    the timings; ``path`` names the model's path in the rows. A call whose
    ``call_key`` one of ``timed_rows`` has is checked and not timed again."""
    rows, fails = [], []
    seen = {call_key(r) for r in timed_rows}
    for kernel, label, shape, dtype, leaf, kw in main_path_calls(model, 1):
        if kernel == "int8_matmul_requant":
            x = make_input(shape, dtype, kw["in_zp"], gen)
            key = (kernel, 1, tuple(shape), str(dtype)[6:], leaf["w"].n, None)
            row, f = kernel_a_row(path, label, x, leaf, kw, batch=1, timed=key not in seen)
            rows.append(row)
            fails += f
            emit({"phase": "a_main_shape", **row})
    for kernel, label, shape, dtype, leaf, kw in main_path_calls(model, BATCH):
        x = make_input(shape, dtype, kw["in_zp"], gen)
        if kernel == "int8_matmul_requant":
            key = (kernel, BATCH, tuple(shape), str(dtype)[6:], leaf["w"].n, None)
            row, f = kernel_a_row(path, label, x, leaf, kw, timed=key not in seen)
            rows.append(row)
            fails += f
            emit({"phase": "a_main_shape", **row})
            continue
        n = leaf["w"].n
        kw = with_residual(kw, shape, n, gen)
        args = (x, leaf["w"], leaf["w_scale"], leaf["bias"], leaf["w_sum"])
        ok, err = compare_exact(KERNEL[kernel](*args, **kw), PLAIN[kernel](*args, **kw))
        if not ok:
            fails.append(f"{kernel} {label} {tuple(shape)}: max abs err {err}")
        nbytes, ops = cost(kernel, x, leaf, kw)
        res = kw.get("residual")
        row = {
            "path": path, "kernel": kernel, "call": label, "batch": BATCH, "x": list(shape),
            "n": n, "max_abs_err": err,
            "residual": None if res is None else ("float32" if isinstance(res, torch.Tensor)
                                                  else "int8"),
            "bytes": nbytes, "ops": ops,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / INT8_OPS_PER_S * 1e3,
        }
        if call_key(row) not in seen:
            m, k = x.numel() // shape[-1], 9 * shape[-1]
            lib, lib_note = int_mm_ms(make_input((m, k), torch.int8, kw["in_zp"], gen), leaf)
            row.update({
                "ms": time_ms(lambda: KERNEL[kernel](*args, **kw), spin=True),
                "plain_ms": time_ms(lambda: PLAIN[kernel](*args, **kw), spin=True),
                "library_ms": lib, **({"library_note": lib_note} if lib_note else {}),
                "library": "torch._int_mm at (M, 9C, O): the GEMM only, no patch matrix"})
        rows.append(row)
        emit({"phase": "a_main_shape", **rows[-1]})
        del x, args, kw
    if timed_rows:
        return rows, fails
    # the stem's patch matrix, built outside the kernel (plain data movement)
    st = model.q["stem"]
    h = st["e4"].shape[1]
    xp = torch.zeros((BATCH, h + 3, h + 3, st["w"].shape[2]), dtype=torch.int8, device="cuda")
    emit({"phase": "stem_im2col", "path": path,
          "ms": time_ms(lambda: extract_patches_nhwc(xp, 4, 4, 1, 0, 0), spin=True)})
    del xp
    return rows, fails


def profile_window(run, per: int = 1, unit: str = "forward"):
    """Device time by kernel over ``run()`` (torch.profiler: the kernels of
    every thread of the process, read by ``metrics.device_profile.device_rows``),
    and the device's idle share of that window's host wall time; counts and
    times per ``per`` ``unit``s."""
    from torch.profiler import ProfilerActivity, profile

    from inference_efficient_vision_models_tpu_torch.metrics.device_profile import device_rows

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof, per)
    busy_ms = sum(r["total_self_us"] for r in rows) / 1e3
    return {
        f"{unit}s": per, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        f"launches_per_{unit}": sum(r["occurrences"] for r in rows) / per,
        "idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
        "top": [{"kernel": r["name"][:100], f"ms_per_{unit}": r["avg_self_us"] / 1e3,
                 f"calls_per_{unit}": r["occurrences"] / per} for r in rows[:12]],
    }


def profile_forward(model, x: torch.Tensor, iters: int = 3):
    """``profile_window`` over ``iters`` forwards of ``model`` on ``x``."""
    return profile_window(lambda: [model(x) for _ in range(iters)], iters)


def serve(model_dir: str, golden_imgs: np.ndarray, gen_np: np.random.Generator,
          method: str = "static_int8"):
    """A main path: Predictor on cuda, three requests, launches counted."""
    pred = Predictor.from_artifact(model_dir, method, device="cuda", batch_size=BATCH,
                                   bucket_sizes=(1, 8))
    pred.warmup(golden_imgs.shape[1:])
    big = np.concatenate([golden_imgs, gen_np.integers(
        0, 256, (2 * BATCH - len(golden_imgs), *golden_imgs.shape[1:]), dtype=np.uint8)])
    requests = [golden_imgs[:1], golden_imgs[:8], big]
    forwards = sum(-(-len(r) // BATCH) for r in requests)
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    served = [pred.predict_logits(r) for r in requests]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.launches)
    return requests, served, forwards, launches, wall


# --------------------------------------------------------------------------
# the EfficientNet-B0 path: kernel C (fused MBConv) and kernel A
# --------------------------------------------------------------------------


def random_block(rng: np.random.Generator, *, cin: int, ce: int, co: int, se: int, k: int,
                 expand: bool):
    """A packed MBConv block (``pack_fused``'s numpy layout) with random int8
    weights and scales that put every requant mid-range, and its input's
    zero point; ``se = 0`` leaves out the SE gate, ``expand = False`` the
    expand conv (then Ce = Cin)."""
    in_zp = int(rng.integers(100, 150))

    def affine(w_q, zp_s, in_std, out_std):
        # (eff, bias - zp_s * sum(w) * eff): the zero-point correction folded in
        k_dim, n = w_q.shape
        eff = out_std / (np.sqrt(k_dim) * 73.0 * in_std) * rng.uniform(0.5, 1.5, n)
        bias = rng.normal(0.0, 0.5, n) - zp_s * w_q.astype(np.float64).sum(0) * eff
        return np.stack([eff, bias]).astype(np.float32)

    p = {}
    if expand:
        p["we"] = rng.integers(-127, 128, (cin, ce), dtype=np.int8)
        p["ve"] = affine(p["we"], in_zp - 128, 30.0, 2.0)
    else:
        ce = cin
    p["wdw"] = rng.integers(-127, 128, (k * k, ce)).astype(np.float32)
    p["vdw"] = affine(p["wdw"], 0, 50.0, 2.0)
    if se:
        p["srw"] = (rng.normal(0, 1, (ce, se)) / np.sqrt(ce)).astype(np.float32)
        p["srb"] = rng.normal(0, 0.5, (1, se)).astype(np.float32)
        p["sew"] = (rng.normal(0, 1, (se, ce)) / np.sqrt(se)).astype(np.float32)
        p["seb"] = rng.normal(0, 1, (1, ce)).astype(np.float32)
    p["wp"] = rng.integers(-127, 128, (ce, co), dtype=np.int8)
    p["vp"] = affine(p["wp"], 12 - 128, 40.0, 1.5)
    e_scale, d_scale, q_scale, o_scale = 6 / 255, 6 / 255, 5 / 255, 8 / 255
    p["scal"] = np.array([[in_zp - 128, 1 / e_scale, 12, 1 / d_scale, 12, d_scale,
                           1 / q_scale, 12, 1 / o_scale, 128, 0.05, in_zp - 128]], np.float32)
    return p, in_zp


def int8_around(shape, zp: int, gen: torch.Generator) -> torch.Tensor:
    """int8 activations spread around a zero point."""
    v = torch.randn(shape, generator=gen, device="cuda") * 30 + (zp - 128 + 10)
    return v.round().clamp(-128, 127).to(torch.int8)


def compare_block(got: torch.Tensor, ref: torch.Tensor, min_exact: float = 0.98):
    """-> (ok, max_abs_err, exact share): int8 within one quantum, >= min_exact exact."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return False, float("inf"), 0.0
    d = (got.int() - ref.int()).abs()
    err, exact = float(d.max()), int((d == 0).sum()) / d.numel()  # 1.0 exactly when all agree
    return err <= 1 and exact >= min_exact, err, exact


# kernel C's project launch alone: (n, ho, wo, ce, co, se, residual). B0's
# first and last block shapes, Co 320 split across blocks at batch 1, Co past
# 320, Ce not a multiple of 16, 8 or 4 (copies of 8, 4 and 1 bytes), Co not a
# multiple of 8, 7 x 7 images straddling panels, 1 x 1 maps, two K chunks
PROJECT_EDGES = [
    (4, 112, 112, 32, 16, True, False), (3, 7, 7, 1152, 320, True, False),
    (1, 7, 7, 1152, 320, True, False), (5, 7, 7, 1152, 192, True, True),
    (2, 7, 9, 38, 30, True, True), (3, 5, 5, 37, 20, False, True), (2, 15, 15, 24, 16, True, False),
    (2, 6, 6, 36, 24, False, True), (2, 9, 9, 100, 37, True, False), (2, 7, 7, 200, 330, False, False),
    (200, 1, 1, 96, 24, True, False), (4, 14, 14, 672, 112, True, True),
    (4, 7, 7, 960, 160, False, True), (2, 56, 56, 144, 24, False, True),
]
# kernel C's SE-gate launch alone: (n, ce, se). B0's late and first blocks,
# one image, groups with a ragged last one, Ce not a multiple of 4 (4-byte
# copies), Se of 256, FC2 chunks of one row, the pruned chain's late blocks
SE_EDGES = [(256, 1152, 48), (256, 32, 8), (1, 1152, 48), (3, 100, 5), (133, 240, 10),
            (2, 37, 256), (5, 37, 3), (9, 4100, 7), (256, 920, 40)]
# launch 3 at an output scale TINY_SCALE times smaller, the gate path and the
# table path: y * inv_o then spans about +-2.4e7, through (-3 * 2^23, -1.5 *
# 2^23), where the bits of y * inv_o + 1.5 * 2^23 read as an int wrap round
PROJECT_TINY_SCALE = [(2, 14, 14, 96, 24, True, True), (3, 7, 7, 37, 20, False, False)]
TINY_SCALE = 5e5


def project_inputs(rng: np.random.Generator, n, ho, wo, ce, co, se, residual, offset=0,
                   inv_o_mul=1.0, device="cuda"):
    """A random packed block and launch 3's inputs on ``device``: yq, the SE
    gate (or None) and x_res (or None), the int8 ones ``offset`` bytes into
    their buffers; the output requant's 1 / scale times ``inv_o_mul``."""
    from inference_efficient_vision_models_tpu_torch.ops.fused_mbconv import INV_O

    p_np, _ = random_block(rng, cin=8, ce=ce, co=co, se=4 if se else 0, k=3, expand=True)
    packed = to_device_packed(p_np, device)
    sc = list(packed["scal"])
    sc[INV_O] *= inv_o_mul
    packed["scal"] = tuple(sc)

    def int8_at(shape, mean):
        v = np.clip(np.rint(rng.normal(mean, 40, int(np.prod(shape)) + offset)), -128, 127)
        return torch.from_numpy(v.astype(np.int8)).to(device)[offset:].view(shape)

    g = (torch.from_numpy(rng.uniform(0.05, 0.95, (n, ce)).astype(np.float32)).to(device)
         if se else None)
    return (packed, int8_at((n, ho, wo, ce), -100), g,
            int8_at((n, ho, wo, co), 0) if residual else None)


def check_launch_edges(rng: np.random.Generator):
    """Launch 3 alone at PROJECT_EDGES, three offset views and
    PROJECT_TINY_SCALE, launch 2 alone at SE_EDGES, each against its plain
    version bit for bit; -> (checks, max abs err, failures)."""
    from inference_efficient_vision_models_tpu_torch.ops import fused_mbconv as fm

    fails, err, checks = [], 0.0, 0
    cases = ([(c, 0, 1.0) for c in PROJECT_EDGES]
             + [((2, 14, 14, 96, 24, True, True), o, 1.0) for o in (1, 4, 8)]
             + [(c, 0, TINY_SCALE) for c in PROJECT_TINY_SCALE])
    for case, offset, mul in cases:
        packed, yq, g, x_res = project_inputs(rng, *case, offset=offset, inv_o_mul=mul)
        wp = packed["wp"]
        args = (yq, g, wp.wt, list(wp.shape), packed["vp"], x_res, list(packed["scal"]))
        got, ref = fm._project_cuda(*args), fm._project_plain(*args)
        torch.cuda.synchronize()
        e = float((got.int() - ref.int()).abs().max())
        err, checks = max(err, e), checks + 1
        if not torch.equal(got, ref):
            fails.append(f"fused_mbconv_project {case} offset {offset} 1/scale x{mul}: "
                         f"max abs err {e}")
    for n, ce, se in SE_EDGES:
        p_np, _ = random_block(rng, cin=8, ce=ce, co=8, se=se, k=3, expand=True)
        packed = to_device_packed(p_np, "cuda")
        pool = torch.from_numpy(rng.integers(-2000, 20000, (n, ce)).astype(np.int32)).cuda()
        args = (pool, packed["srw"], packed["srb"], packed["sew"], packed["seb"], 0.01 / 49)
        got, ref = fm._se_gate_cuda(*args), fm._se_gate_plain(*args)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        err, checks = max(err, e), checks + 1
        if not torch.equal(got, ref):
            fails.append(f"fused_mbconv_se_gate {(n, ce, se)}: max abs err {e}")
    return checks, err, fails


def block_cost(x: torch.Tensor, packed, kernel: int, stride: int, residual: bool):
    """(bytes, int8 ops, depthwise MACs) of one fused block call: the bytes the
    TPU kernel moves (x_in, x_res, y_out, every operand once; the port's extra
    int8 round trip of the hidden tensor is not counted), 2 ops per int8
    multiply-add of the two GEMMs, k*k MACs per depthwise output."""
    n, h, w, cin = x.shape
    pad = (kernel - 1) // 2
    ho, wo = (h + 2 * pad - kernel) // stride + 1, (w + 2 * pad - kernel) // stride + 1
    ce, co = packed["wdw"].shape[-1], packed["wp"].n
    weights = sum(v.numel() * v.element_size() for k, v in packed.items()
                  if isinstance(v, torch.Tensor)) + ce * co + (cin * ce if "we" in packed else 0)
    out = n * ho * wo * co
    nbytes = x.numel() + (out if residual else 0) + out + weights
    ops = 2 * (n * h * w * cin * ce if "we" in packed else 0) + 2 * n * ho * wo * ce * co
    return nbytes, ops, n * ho * wo * ce * kernel * kernel


def launch_bounds(x: torch.Tensor, packed, kernel: int, stride: int, residual: bool):
    """Each of kernel C's launches' own bound at one block call (ms), the
    larger of its bytes (each input read once, each output written once)
    over HBM and its operations over the card's rate for them, and which of
    the two decides it ("bytes" or "operations"):
    - expand_dw: x, the expand and depthwise weights and scales in, yq and
      the pool sums out; the expand's int8 operations, the depthwise MACs;
    - se_gate: the pool sums, both SE weights and biases in, the gate out;
      the two FCs' float64 multiply-adds (at the tensor cores' fp64 rate);
    - project: yq, the gate, x_res, the project weight and vp in, the output
      out; its int8 operations.
    -> ({launch: ms}, {launch: "bytes" or "operations"}); no SE: 0.0, None."""
    n, h, w, cin = x.shape
    pad = (kernel - 1) // 2
    ho, wo = (h + 2 * pad - kernel) // stride + 1, (w + 2 * pad - kernel) // stride + 1
    ce, co = packed["wdw"].shape[-1], packed["wp"].n
    m, se = n * ho * wo, packed["srw"].shape[1] if "srw" in packed else 0
    expand = "we" in packed
    b1 = (x.numel() + (cin * ce + 8 * ce if expand else 0) + (kernel * kernel + 2) * ce * 4
          + m * ce + (n * ce * 4 if se else 0))
    ops1 = max((2 * n * h * w * cin * ce if expand else 0) / INT8_OPS_PER_S,
               m * ce * kernel * kernel / FP32_FMA_PER_S)
    b2 = 2 * n * ce * 4 + 2 * ce * se * 4 + (se + ce) * 4
    b3 = m * ce + (n * ce * 4 if se else 0) + (m * co if residual else 0) + m * co + ce * co + 8 * co
    terms = {"expand_dw": (b1 / HBM_BYTES_PER_S, ops1),
             "se_gate": (b2 / HBM_BYTES_PER_S, 2 * n * ce * se / FP64_FMA_PER_S),
             "project": (b3 / HBM_BYTES_PER_S, 2 * m * ce * co / INT8_OPS_PER_S)}
    if not se:
        del terms["se_gate"]
    ms = {k: max(t) * 1e3 for k, t in terms.items()}
    by = {k: "bytes" if t[0] >= t[1] else "operations" for k, t in terms.items()}
    return {"se_gate": 0.0, **ms}, {"se_gate": None, **by}


def eff_block_inputs(model, b: int, gen: torch.Generator):
    """(name, x, kernel, stride, residual) at every block of the served model,
    batch b, int8 inputs spread around each block's input zero point."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.engine import quant_module

    h = model.q["stem"]["e"].shape[1]
    out = []
    for name, k, stride, residual in quant_module(model.spec).block_plan(model.spec):
        sc = model.qf[name]["scal"]
        cin = model.qf[name]["we"].shape[0] if "we" in model.qf[name] else \
            model.qf[name]["wdw"].shape[-1]
        out.append((name, int8_around((b, h, h, cin), int(sc[0]) + 128, gen), k, stride,
                    residual))
        h = (h - 1) // stride + 1
    return out


def eff_check_odd_shapes(gen_np: np.random.Generator, gen: torch.Generator):
    """(a) kernel C at shapes off the served path, bit for bit: relu6 without
    SE, without expand, no residual, ragged H/W, Ce not a multiple of 8 or of
    the channel tile (and not of 4), stride 2 on odd H, k = 1/3/5; Ce of 32
    and 96, Cin of 16, k5 at stride 2; then its project and SE-gate launches
    alone at their edges (``check_launch_edges``)."""
    cases = [  # (n, h, w, cin, ce, co, se, k, stride, expand, act, residual)
        (3, 12, 12, 24, 36, 20, 0, 3, 1, True, "relu6", False),
        (2, 10, 10, 40, 40, 40, 0, 3, 1, False, "relu6", True),
        (2, 7, 9, 24, 36, 24, 6, 5, 1, True, "silu", True),
        (2, 15, 15, 16, 100, 24, 4, 3, 2, True, "silu", False),
        (3, 13, 11, 22, 38, 30, 5, 5, 2, True, "silu", False),
        (2, 20, 20, 72, 72, 72, 18, 5, 1, False, "silu", True),
        (2, 9, 9, 32, 200, 48, 8, 1, 1, True, "silu", False),
        (1, 33, 31, 8, 8, 16, 2, 3, 2, False, "silu", False),
        (2, 30, 30, 32, 32, 16, 8, 3, 1, False, "silu", False),
        (2, 31, 29, 16, 96, 24, 4, 3, 2, True, "silu", False),
        (2, 23, 23, 24, 144, 40, 6, 5, 2, True, "silu", False),
        (2, 16, 16, 40, 200, 40, 10, 5, 1, True, "silu", True),
        (2, 11, 11, 112, 672, 192, 28, 5, 2, True, "silu", False),
    ]
    fails, err_max = [], 0.0
    for n, h, w, cin, ce, co, se, k, stride, expand, act, residual in cases:
        p_np, in_zp = random_block(gen_np, cin=cin, ce=ce, co=co, se=se, k=k, expand=expand)
        packed = to_device_packed(p_np, "cuda")
        x = int8_around((n, h, w, cin), in_zp, gen)
        res = None
        if residual:
            res = x if cin == co else int8_around(
                (n, (h - 1) // stride + 1, (w - 1) // stride + 1, co), in_zp, gen)
        kw = dict(kernel=k, stride=stride, act=act, x_res=res)
        ok, err, exact = compare_block(fused_mbconv_block(x, packed, **kw),
                                       fused_mbconv_block_plain(x, packed, **kw), 1.0)
        err_max = max(err_max, err)
        if not ok:
            fails.append(f"fused_mbconv_block {(n, h, w, cin, ce, co, se, k, stride, expand, act, residual)}:"
                         f" max abs err {err}, exact {exact}")
    checks, err, f = check_launch_edges(gen_np)
    fails += f
    emit({"phase": "eff_a_odd_shapes", "checks": len(cases) + checks,
          "max_abs_err": max(err_max, err), "launch_edges": checks, "failed": fails})
    return fails


def eff_kernel_a_calls(model, b: int):
    """Kernel A's three calls of one forward at batch b: stem (im2col patches,
    K = 27), the head conv (K = 320) and the fc (float input)."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.engine import quant_module

    q = model.q
    st, last, fc = q["stem"], q["last"], q["fc"]
    hs = hl = st["e"].shape[1]
    for _, _, stride, _ in quant_module(model.spec).block_plan(model.spec):
        hl = (hl - 1) // stride + 1
    return [
        ("int8_matmul_requant", "stem", (b * hs * hs, st["w"].k), torch.int8, st,
         dict(in_scale=1.0, in_zp=128)),
        ("int8_matmul_requant", "last", (b * hl * hl, last["w"].k), torch.int8, last,
         dict(in_scale=last["in_scale"], in_zp=last["in_zp"])),
        ("int8_matmul_requant", "fc", (b, fc["w"].k), torch.float32, fc,
         dict(in_scale=fc["in_scale"], in_zp=fc["in_zp"])),
    ]


def eff_check_and_time_main_shapes(model, gen: torch.Generator, path: str = "efficientnet_b0",
                                   time_a: bool = False):
    """(a) kernel C at every block shape, bit for bit, and kernel A at its
    3, batch 256, then the timings: each block's launches apart (device
    time, CUDA events: ``port_block_launches.launch_ms``) beside the whole call, its bound and
    each launch's own bound (``launch_bounds``), on every path. ``path`` names the
    model's path in the rows; kernel A is timed on the committed model's
    path and, with ``time_a``, on ``path``."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.engine import quant_module

    main = path == "efficientnet_b0"
    act = quant_module(model.spec).ACT
    rows, fails = [], []
    for name, x, k, stride, residual in eff_block_inputs(model, BATCH, gen):
        packed = model.qf[name]
        kw = dict(kernel=k, stride=stride, act=act, x_res=x if residual else None)
        ok, err, exact = compare_block(fused_mbconv_block(x, packed, **kw),
                                       fused_mbconv_block_plain(x, packed, **kw), 1.0)
        if not ok:
            fails.append(f"fused_mbconv_block {name} {tuple(x.shape)}: max abs err {err}, "
                         f"exact {exact}")
        nbytes, ops, dw = block_cost(x, packed, k, stride, residual)
        lb_ms, lb_by = launch_bounds(x, packed, k, stride, residual)
        rows.append({
            "path": path, "kernel": "fused_mbconv_block", "call": name,
            "x": list(x.shape), "ce": packed["wdw"].shape[-1], "n": packed["wp"].n,
            "k": k, "stride": stride, "act": act, "max_abs_err": err, "exact": exact,
            "ms": time_ms(lambda: fused_mbconv_block(x, packed, **kw), spin=True),
            "plain_ms": time_ms(lambda: fused_mbconv_block_plain(x, packed, **kw), spin=True),
            "bytes": nbytes, "ops": ops, "dw_macs": dw,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / INT8_OPS_PER_S * 1e3,
            "dw_ms": dw / FP32_FMA_PER_S * 1e3, "library_ms": None,
            "launch_ms": launch_ms(x, packed, k, stride, act, kw["x_res"]),
            "launch_bound_ms": lb_ms, "launch_bound_by": lb_by,
        })
        emit({"phase": "eff_a_main_shape", **rows[-1]})
        del x
    mine = [r for r in rows if r["kernel"] == "fused_mbconv_block"]
    emit({"phase": "eff_c_launches", "path": path, "batch": BATCH,
          "blocks": [{"block": r["call"], **r["launch_ms"], "ms": r["ms"],
                      "bound_ms": max(r["bytes_ms"], r["ops_ms"], r["dw_ms"]),
                      "launch_bound_ms": r["launch_bound_ms"],
                      "launch_bound_by": r["launch_bound_by"]} for r in mine],
          "total": {k: sum(r["launch_ms"][k] for r in mine) for k in LAUNCHES},
          "launch_bound_ms": {k: sum(r["launch_bound_ms"][k] for r in mine) for k in LAUNCHES},
          # the blocks whose launch bound each term decides
          "launch_bound_by": {k: {by: sum(r["launch_bound_by"][k] == by for r in mine)
                                  for by in ("bytes", "operations")} for k in LAUNCHES},
          "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"], r["dw_ms"]) for r in mine)})
    if not main:
        emit({"phase": "eff_c_blocks", "path": path, "batch": BATCH, "calls": len(mine),
              "ms": sum(r["ms"] for r in mine), "plain_ms": sum(r["plain_ms"] for r in mine),
              "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"], r["dw_ms"]) for r in mine)})
        for _, label, shape, dtype, leaf, kw in eff_kernel_a_calls(model, BATCH):
            row, f = kernel_a_row(path, label, make_input(shape, dtype, kw["in_zp"], gen), leaf,
                                  kw, timed=time_a)
            rows.append(row)
            fails += f
        return rows, fails
    for b in (BATCH, 1):
        for _, label, shape, dtype, leaf, kw in eff_kernel_a_calls(model, b):
            row, f = kernel_a_row("efficientnet_b0", label,
                                  make_input(shape, dtype, kw["in_zp"], gen), leaf, kw, batch=b)
            rows.append(row)
            fails += f
            emit({"phase": "eff_a_main_shape", **row})
    return rows, fails


def eff_blocks_teacher_forced(model, imgs: np.ndarray):
    """(a') every block on the golden images: kernel and plain fed the same
    plain-path input, so flips do not compound; within one quantum, >= 98%
    exact on every block."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.qeffnet import block_plan, stem_int8

    fails, per = [], []
    with torch.inference_mode():
        cur = stem_int8(model.q, torch.from_numpy(imgs).cuda(), impl="plain")
        for name, k, stride, residual in block_plan(model.spec):
            kw = dict(kernel=k, stride=stride, act="silu", x_res=cur if residual else None)
            ref = fused_mbconv_block_plain(cur, model.qf[name], **kw)
            ok, err, exact = compare_block(fused_mbconv_block(cur, model.qf[name], **kw), ref)
            per.append({"block": name, "max_abs_err": err, "exact": exact})
            if not ok:
                fails.append(f"(a') block {name}: max abs err {err}, exact share {exact}")
            cur = ref
    worst = min(per, key=lambda r: r["exact"])
    emit({"phase": "eff_a_prime_blocks_teacher_forced", "images": len(imgs),
          "worst_block": worst["block"], "worst_exact": worst["exact"],
          "max_abs_err": max(r["max_abs_err"] for r in per), "blocks": per, "failed": fails})
    return fails


def eff_blocks_vs_jax(model, golden):
    """(c') every block fed the JAX package's own input to it (its block
    outputs on golden images, committed in testdata): the kernel's int8
    output against JAX's, within one quantum and >= 98% exact."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.qeffnet import block_plan

    fails, per = [], []
    names = ["stem"] + [name for name, *_ in block_plan(model.spec)]
    with torch.inference_mode():
        for (name, k, stride, residual), src in zip(block_plan(model.spec), names):
            x = torch.from_numpy(golden[f"block_{src}"]).cuda()
            kw = dict(kernel=k, stride=stride, act="silu", x_res=x if residual else None)
            got = fused_mbconv_block(x, model.qf[name], **kw)
            ok, err, exact = compare_block(got, torch.from_numpy(golden[f"block_{name}"]).cuda())
            per.append({"block": name, "max_abs_err": err, "exact": exact})
            if not ok:
                fails.append(f"(c') block {name} vs JAX: max abs err {err}, exact share {exact}")
    worst = min(per, key=lambda r: r["exact"])
    emit({"phase": "eff_c_prime_blocks_vs_jax", "images": int(golden["block_stem"].shape[0]),
          "worst_block": worst["block"], "worst_exact": worst["exact"],
          "max_abs_err": max(r["max_abs_err"] for r in per), "failed": fails})
    return fails


def logits_close(got: np.ndarray, ref: np.ndarray, tau: float):
    """-> (ok, max abs err, atol): |got - ref| <= tau * max|ref| and the same
    argmax wherever ref's top-2 margin exceeds 2 * atol."""
    atol = tau * float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    top2 = np.sort(ref, axis=1)[:, -2:]
    wide = top2[:, 1] - top2[:, 0] > 2 * atol
    ok = (got.shape == ref.shape and np.isfinite(got).all() and err <= atol
          and bool((got.argmax(1) == ref.argmax(1))[wide].all()))
    return ok, err, atol


def run_mbv2(dev, gen: torch.Generator, gen_np: np.random.Generator):
    """The MobileNetV2 phases on a seeded full-width model at 224x224:
    ``convert_mbv2`` (BN recalibration, calibration and conversion on the
    card against the JAX CPU record); the JAX model exactly (the card's
    integer leaves, equal to the record's by sha256, with the record's
    activation qparams) on the unfused, mixed and fused executors:
    ``mbv2_logits_vs_jax`` (launches per forward A 36 + E 17, A 36, A 3 +
    C 34; kernel path equal to plain path; unfused and mixed logits against
    the JAX goldens within MBV2_FC_QUANTA fc quanta), ``mbv2_fused_vs_unfused``
    (teacher forcing, within one quantum, >= 98% exact); ``mbv2_e_shapes``
    (kernel E's ReLU6 epilogue at the 17 calls at batch 256, bit for bit,
    timed beside its bound and its plain version, then odd shapes),
    ``mbv2_c_shapes`` (kernel C at the 17 blocks, bit for bit, timed, and
    kernel A at the fused executor's 3 calls), ``mbv2_a_shapes`` (kernel A at
    the unfused executor's 36 calls at batch 256, bit for bit, timed beside
    its bound, its plain version and torch._int_mm) and ``mbv2_forward``.
    -> (rows, {path: launches})."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import fusedpath as tfp
    from inference_efficient_vision_models_tpu_torch.compress.quant import qmobilenet as tqm
    from inference_efficient_vision_models_tpu_torch.compress.quant.qeffnet import stem_int8

    with open(MBV2_CONVERT_GOLDEN) as f:
        record = json.load(f)
    spec, p, s, imgs, labels = effnet_convert_inputs("mobilenet_v2", MBV2_CONVERT)
    ref_state = nested_from_npz(np.load(MBV2_CONVERT_STATE))
    t0 = time.perf_counter()
    recal = port_recal_effnet(spec, p, s, imgs, "cuda", MBV2_CONVERT)
    torch.cuda.synchronize()
    recal_s = time.perf_counter() - t0
    recal_dev = state_deviation(recal, ref_state)
    q, _, t = port_convert_effnet(spec, p, ref_state, imgs, labels, "cuda", MBV2_CONVERT)
    report = compare_conversion(tqm.serializable(q), record, MBV2_CONVERT_LIMITS, _eff_tap_of)
    ok = report["ok"] and recal_dev <= MBV2_CONVERT_LIMITS["recal_rtol"]
    emit({"phase": "convert_mbv2", **_stage_card(dev), "model": spec.name, "images": len(imgs),
          "size": MBV2_CONVERT["size"], "recal_s": recal_s, "recal_dev": recal_dev, **t,
          "limits": MBV2_CONVERT_LIMITS, **report, "ok": ok})
    if not ok:
        raise SmokeFailure(f"convert_mbv2: outside the limits: recal {recal_dev}, {report}")

    qj = with_record_qparams(q, record)
    sd = spec.to_dict()
    models = {"unfused": tqm.from_jax_qmodel(sd, qj, "cuda"),
              "mixed": tqm.from_jax_qmodel(sd, qj, "cuda", executor="mixed"),
              "fused": tfp.from_jax_qmodel(sd, qj, "cuda")}
    per = {"unfused": MBV2_UNFUSED_PER_FORWARD, "mixed": MBV2_MIXED_PER_FORWARD,
           "fused": MBV2_FUSED_PER_FORWARD}
    golden = np.load(MBV2_GOLDEN)
    x_np = mbv2_golden_images()
    x = torch.from_numpy(x_np).cuda()
    fc = qj["fc"]
    quantum = float(np.float32(fc["in_scale"])) * float(np.abs(fc["w_scale"]).max()) * 127
    launches_by, fails = {}, []
    with torch.inference_mode():
        for ex, model in models.items():
            _lib.reset_launch_counts()  # the main path: one forward of the 8 images
            kern = model(x)
            torch.cuda.synchronize()
            launches = dict(_lib.launches)
            launches_by[f"mobilenet_v2_{ex}"] = launches
            plain = model(x, impl="plain").cpu().numpy()
            kern = kern.cpu().numpy()
            rec = {"phase": "mbv2_logits_vs_jax", **_stage_card(dev), "executor": ex,
                   "images": len(x_np), "launches_per_forward": launches,
                   "expected_launches": per[ex], "kernel_equals_plain":
                   bool(np.array_equal(kern, plain)),
                   "kernel_vs_plain_max_abs_err": float(np.abs(kern - plain).max())}
            ok = launches == per[ex] and rec["kernel_equals_plain"]
            if ex in ("unfused", "mixed"):
                ref = golden["int8" if ex == "unfused" else "mixed"]
                tau = MBV2_FC_QUANTA * quantum / float(np.abs(ref).max())
                l_ok, err, atol = logits_close(kern, ref, tau)
                rec.update({"vs_jax_max_abs_err": err, "vs_jax_atol": atol, "tau": tau,
                            "vs_jax_equal": bool(np.array_equal(kern, ref)),
                            "logit_scale": float(np.abs(ref).max()),
                            "argmax_identical": bool((kern.argmax(1) == ref.argmax(1)).all())})
                ok = ok and l_ok
            emit(rec)
            if not ok:
                fails.append(f"{ex}: {rec}")
        unfused, fused = models["unfused"], models["fused"]
        outs, per_block = block_outputs(unfused, x), []
        prev = stem_int8(unfused.q, x, impl="plain", act=tqm.ACT)
        for name, k, stride, residual in tqm.block_plan(spec):
            got = fused_mbconv_block(prev, fused.qf[name], kernel=k, stride=stride, act="relu6",
                                     x_res=prev if residual else None)
            b_ok, b_err, exact = compare_block(got, outs[name])
            per_block.append({"block": name, "max_abs_err": b_err, "exact": exact})
            if not b_ok:
                fails.append(f"fused block {name} vs unfused: max abs err {b_err}, exact {exact}")
            prev = outs[name]
    emit({"phase": "mbv2_fused_vs_unfused", "images": len(x_np),
          "worst_exact": min(r["exact"] for r in per_block),
          "max_abs_err": max(r["max_abs_err"] for r in per_block), "blocks": per_block})
    if fails:
        raise SmokeFailure("MobileNetV2 executors:\n" + "\n".join(fails))

    rows, fails = check_e_main_shapes(unfused, gen, "mobilenet_v2_unfused", "mbv2_e_shapes")
    odd = []
    for n, h, w, c, k, stride in E_ODD_SHAPES:
        leaf = {"w_q": torch.from_numpy(gen_np.integers(-127, 128, (k, k, 1, c),
                                                        dtype=np.int8)).cuda(),
                "w_scale": torch.from_numpy(gen_np.uniform(0.002, 0.02, c)
                                            .astype(np.float32)).cuda(),
                "bias": torch.from_numpy(gen_np.standard_normal(c).astype(np.float32)).cuda()}
        for in_zp, out_zp in E_ZPS:
            xo = int8_around((n, h, w, c), in_zp, gen)
            kw = dict(stride=stride, in_scale=0.04, in_zp=in_zp, out_scale=0.03, out_zp=out_zp,
                      act="relu6")
            row, f = e_row("odd", f"{h}x{w}x{c} k{k} s{stride} relu6", xo, leaf, kw,
                           timed=False)
            odd.append(row)
            fails += f
    # requant ties: s_in * s_w = 2^-12, s_out = 2^-9, so y / s_out = acc / 8
    xt = int8_around((8, 28, 28, 40), 128, gen)
    tie_leaf = {"w_q": torch.from_numpy(gen_np.integers(-127, 128, (3, 3, 1, 40),
                                                        dtype=np.int8)).cuda(),
                "w_scale": torch.full((40,), 1 / 64, device="cuda"),
                "bias": torch.zeros(40, device="cuda")}
    for stride in (1, 2):
        kw = dict(stride=stride, in_scale=1 / 64, in_zp=128, out_scale=1 / 512, out_zp=0,
                  act="relu6")
        row, f = e_row("odd", f"ties s{stride} relu6", xt, tie_leaf, kw, timed=False)
        odd.append(row)
        fails += f
    emit({"phase": "mbv2_e_odd_shapes", "checks": len(odd),
          "max_abs_err": max(r["max_abs_err"] for r in odd), "failed": fails})
    c_rows, f2 = eff_check_and_time_main_shapes(fused, gen, "mobilenet_v2_fused", time_a=True)
    rows += odd + c_rows
    fails += f2
    a_rows, f3 = check_unfused_a_shapes(unfused, gen, "mobilenet_v2_unfused", "mbv2_a_shapes")
    rows += a_rows
    fails += f3
    emit({"phase": "mbv2_kernels", "checks": len(rows),
          "max_abs_err": max(r["max_abs_err"] for r in rows), "failed": fails})
    if fails:
        raise SmokeFailure("kernels disagree at MobileNetV2's shapes:\n" + "\n".join(fails))

    fwd = {}
    with torch.inference_mode():
        for b in (1, BATCH):
            xb = torch.from_numpy(np.random.default_rng(2).integers(
                0, 256, (b, 224, 224, 3), dtype=np.uint8)).cuda()
            for ex, model in models.items():
                fwd[f"{ex}_forward_ms_b{b}"] = time_ms(lambda: model(xb))
        for ex in models:
            fwd[f"{ex}_images_per_s_b256"] = BATCH / fwd[f"{ex}_forward_ms_b{BATCH}"] * 1e3
        emit({"phase": "mbv2_forward", **_stage_card(dev), **fwd,
              "unfused_profile_b256": profile_forward(unfused, xb),
              "fused_profile_b256": profile_forward(fused, xb)})
    return rows, launches_by


def run_efficientnet(gen: torch.Generator):
    """Every phase of the EfficientNet-B0 path; -> (rows, launches, forward ms)."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.fusedpath import (
        load_static_int8_fused,
    )

    fails = eff_check_odd_shapes(np.random.default_rng(3), gen)
    model = load_static_int8_fused(EFF_ARTIFACT, device="cuda")
    rows, f = eff_check_and_time_main_shapes(model, gen)
    fails += f
    golden = np.load(EFF_GOLDEN)
    golden_imgs = np.random.default_rng(int(golden["seed"])).integers(
        0, 256, tuple(golden["shape"]), dtype=np.uint8)
    fails += eff_blocks_teacher_forced(model, golden_imgs)
    fails += eff_blocks_vs_jax(model, golden)
    if fails:
        raise SmokeFailure("EfficientNet-B0 kernels disagree:\n" + "\n".join(fails))
    if not all("srw" in p for p in model.qf.values()):
        raise SmokeFailure("expected the SE gate (three launches) on every EfficientNet block")

    requests, served, forwards, launches, wall = serve(
        EFF_ARTIFACT, golden_imgs, np.random.default_rng(1), "static_int8_fused")
    emit({"phase": "eff_serve", "requests": [len(r) for r in requests], "forwards": forwards,
          "launches": launches, "wall_s": wall})
    for r, out in zip(requests, served):
        if out.shape != (len(r), model.spec.num_classes) or not np.isfinite(out).all():
            raise SmokeFailure(f"served logits have shape {out.shape} or are not finite")
    for k in set(EFF_PER_FORWARD) | set(launches):  # (d)
        want = EFF_PER_FORWARD.get(k, 0) * forwards
        if launches.get(k, 0) != want:
            raise SmokeFailure(f"(d) {k} launched {launches.get(k, 0)} times in {forwards} "
                               f"EfficientNet forwards, expected {want}")

    # (b) kernel path (served) against the plain path on the card
    big = requests[-1]
    with torch.inference_mode():
        plain = np.concatenate([
            model(torch.from_numpy(big[i : i + BATCH]).cuda(), impl="plain").cpu().numpy()
            for i in range(0, len(big), BATCH)])
    ok, err, atol = logits_close(served[-1], plain, TAU_B)
    emit({"phase": "eff_b_kernel_vs_plain_forward", "images": len(big), "max_abs_err": err,
          "atol": atol, "tau": TAU_B,
          "argmax_identical": bool((served[-1].argmax(1) == plain.argmax(1)).all())})
    if not ok:
        raise SmokeFailure(f"(b) kernel-path logits differ from the plain path: {err} > {atol}")

    # (c) served logits against the JAX package's golden logits
    ref = golden["logits"]
    errs = []
    for r, out in zip(requests, served):
        k = min(len(r), len(ref))
        ok, err, atol = logits_close(out[:k], ref[:k], TAU_C)
        errs.append(err)
        if not ok:
            raise SmokeFailure(f"(c) served logits differ from the JAX golden logits: {err} > {atol}")
    emit({"phase": "eff_c_served_vs_jax_golden", "images": len(ref), "max_abs_err": max(errs),
          "atol": TAU_C * float(np.abs(ref).max()), "tau": TAU_C,
          "max_abs_err_over_scale": max(errs) / float(np.abs(ref).max()),
          "argmax_identical": bool((served[-1][: len(ref)].argmax(1) == ref.argmax(1)).all())})

    fwd = {}
    with torch.inference_mode():
        for b in (1, BATCH):
            x = torch.from_numpy(np.random.default_rng(2).integers(
                0, 256, (b, *golden_imgs.shape[1:]), dtype=np.uint8)).cuda()
            fwd[f"forward_ms_b{b}"] = time_ms(lambda: model(x))
            fwd[f"plain_forward_ms_b{b}"] = time_ms(lambda: model(x, impl="plain"))
        torch.cuda.synchronize()
        fwd["images_per_s_b256"] = BATCH / fwd[f"forward_ms_b{BATCH}"] * 1e3
        fwd["served_images_per_s"] = sum(len(r) for r in requests) / wall
        emit({"phase": "eff_forward", **fwd})
        emit({"phase": "eff_profile_b256", **profile_forward(model, x)})
    return rows, launches


# --------------------------------------------------------------------------
# EfficientNet-B0's unfused and mixed executors: kernel E (int8 depthwise)
# --------------------------------------------------------------------------

# kernel E's odd shapes (N, H, W, C, k, stride): byte loads (C 13, 1), 8-byte
# loads (C 8), odd H and W, k 5 at stride 2 on every border class (H mod 4)
E_ODD_SHAPES = [(4, 13, 13, 8, 3, 1), (4, 13, 11, 13, 5, 2), (2, 9, 15, 13, 3, 2),
                (2, 7, 7, 1152, 5, 2), (3, 15, 9, 1152, 3, 1), (2, 11, 13, 8, 5, 2),
                (2, 10, 10, 8, 5, 2), (2, 14, 14, 13, 5, 2), (2, 12, 11, 1152, 5, 2),
                (3, 17, 17, 1, 5, 2)]
E_ZPS = ((0, 255), (128, 128), (255, 0))  # (input zero point, output zero point)
# kernel F's odd shapes (N, H, W, C, groups, stride): Cg 1, 3, 4, 5, 8, 14 and
# 32 (byte copies for Cg not a multiple of 4), groups 2 and 32, odd H and W,
# a ragged last slab (Cg 32 at 2 groups: one slab of one group per block)
GC_ODD_SHAPES = [(4, 13, 13, 32, 32, 1), (4, 13, 11, 96, 32, 2), (2, 9, 15, 8, 2, 2),
                 (2, 11, 7, 10, 2, 1), (2, 15, 9, 256, 32, 2), (3, 7, 9, 28, 2, 1),
                 (2, 9, 9, 1024, 32, 1), (2, 10, 10, 64, 2, 2), (3, 17, 17, 448, 32, 2),
                 (2, 5, 7, 160, 32, 1)]


def dw_calls(model, b: int):
    """Kernel E's calls of one unfused forward at batch b (16 for B0, 17 for
    MobileNetV2): (block, x shape, depthwise leaf, stride, in_scale, in_zp)."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.engine import quant_module

    q = model.q
    h = q["stem"]["e"].shape[1]
    cur_s, cur_z = q["stem"]["out_scale"], q["stem"]["out_zp"]
    out = []
    for name, _, stride, _ in quant_module(model.spec).block_plan(model.spec):
        blk = q["blocks"][name]
        e = blk.get("expand")
        in_s, in_z = (e["out_scale"], e["out_zp"]) if e else (cur_s, cur_z)
        out.append((name, (b, h, h, blk["dw"]["w_q"].shape[-1]), blk["dw"], stride, in_s, in_z))
        h = (h - 1) // stride + 1
        cur_s, cur_z = blk["out_scale"], blk["out_zp"]
    return out


def unfused_a_calls(model, b: int):
    """Kernel A's calls of one unfused forward at batch b (34 for B0, 36 for
    MobileNetV2): the stem (im2col patches), each expand and project (fp32
    out; a project's input is the SE gate's output, or the depthwise conv's
    without one), the head conv and the fc."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.engine import quant_module

    q = model.q
    st = q["stem"]
    h = st["e"].shape[1]
    calls = [("stem", (b * h * h, st["w"].k), torch.int8, st, dict(in_scale=1.0, in_zp=128))]
    cur_s, cur_z = st["out_scale"], st["out_zp"]
    for name, _, stride, _ in quant_module(model.spec).block_plan(model.spec):
        blk = q["blocks"][name]
        if "expand" in blk:
            calls.append((f"{name}.expand", (b * h * h, blk["expand"]["w"].k), torch.int8,
                          blk["expand"], dict(in_scale=cur_s, in_zp=cur_z)))
        h = (h - 1) // stride + 1
        p_in = ((blk["se_scale"], blk["se_zp"]) if "se_scale" in blk
                else (blk["dw"]["out_scale"], blk["dw"]["out_zp"]))
        calls.append((f"{name}.project", (b * h * h, blk["project"]["w"].k), torch.int8,
                      blk["project"], dict(in_scale=p_in[0], in_zp=p_in[1])))
        cur_s, cur_z = blk["out_scale"], blk["out_zp"]
    last, fc = q["last"], q["fc"]
    calls.append(("last", (b * h * h, last["w"].k), torch.int8, last,
                  dict(in_scale=last["in_scale"], in_zp=last["in_zp"])))
    calls.append(("fc", (b, fc["w"].k), torch.float32, fc,
                  dict(in_scale=fc["in_scale"], in_zp=fc["in_zp"])))
    return calls


def check_unfused_a_shapes(model, gen: torch.Generator, path: str, phase: str):
    """Kernel A at the unfused executor's calls of ``model`` at batch 256
    (``unfused_a_calls``), bit for bit, each timed beside its bound, its
    plain version and torch._int_mm, and their sum (``phase`` with
    ``_forward`` for ``_shapes``). -> (rows, failures)."""
    rows, fails = [], []
    for label, shape, dtype, leaf, kw in unfused_a_calls(model, BATCH):
        row, f = kernel_a_row(path, label, make_input(shape, dtype, kw["in_zp"], gen), leaf, kw)
        emit({"phase": phase, **row})
        rows.append(row)
        fails += f
    emit({"phase": phase.replace("_shapes", "_forward"), "path": path, "batch": BATCH,
          "calls": len(rows),
          **{k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bytes", "ops")},
          "library_ms": (None if any(r["library_ms"] is None for r in rows)
                         else sum(r["library_ms"] for r in rows)),
          "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) for r in rows)})
    return rows, fails


def e_row(path: str, label: str, x: torch.Tensor, leaf, kw, *, timed: bool = True):
    """Kernel E at one call, bit for bit against its plain version, its bound
    (bytes: x, out, the k*k x C weights and two fp32 C-vectors once; the
    depthwise MACs at the CUDA cores' FMA rate) and, ``timed``, its time
    beside the plain version's and the bound's share of it."""
    from inference_efficient_vision_models_tpu_torch.ops import (
        depthwise_conv_int8, depthwise_conv_int8_plain)

    args = (x, leaf["w_q"], leaf["w_scale"], leaf["bias"])
    ok, err = compare_exact(depthwise_conv_int8(*args, **kw),
                            depthwise_conv_int8_plain(*args, **kw))
    n, h, w, c = x.shape
    k, stride = leaf["w_q"].shape[0], kw["stride"]
    out = n * ((h - 1) // stride + 1) * ((w - 1) // stride + 1) * c
    nbytes, macs = x.numel() + out + k * k * c + 8 * c, out * k * k
    row = {"path": path, "kernel": "dwconv_int8", "call": label, "batch": n, "x": list(x.shape),
           "n": c, "k": k, "stride": stride, "act": kw.get("act", "silu"),
           "in_zp": int(kw["in_zp"]),
           "out_zp": int(kw["out_zp"]), "max_abs_err": err, "bytes": nbytes, "ops": 0,
           "dw_macs": macs, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": 0.0,
           "dw_ms": macs / FP32_FMA_PER_S * 1e3, "library_ms": None,
           "in_forward": n == BATCH}
    if timed:
        row["ms"] = time_ms(lambda: depthwise_conv_int8(*args, **kw), spin=True)
        row["plain_ms"] = time_ms(lambda: depthwise_conv_int8_plain(*args, **kw), spin=True)
        row["bound_share"] = max(row["bytes_ms"], row["dw_ms"]) / row["ms"]
    return row, [] if ok else [f"dwconv_int8 {path} {label} {tuple(x.shape)} {kw}: "
                               f"max abs err {err}"]


def check_e_main_shapes(model, gen: torch.Generator, path: str, phase: str = "effnet_e_shapes"):
    """Kernel E at the depthwise calls of ``model`` at batch 256 (its
    family's activation), bit for bit and timed."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.engine import quant_module

    rows, fails = [], []
    for name, shape, leaf, stride, in_s, in_z in dw_calls(model, BATCH):
        x = int8_around(shape, in_z, gen)
        kw = dict(stride=stride, in_scale=in_s, in_zp=in_z, out_scale=leaf["out_scale"],
                  out_zp=leaf["out_zp"], act=quant_module(model.spec).ACT)
        row, f = e_row(path, name, x, leaf, kw)
        rows.append(row)
        fails += f
        emit({"phase": phase, **row})
        del x
    ms, bound = sum(r["ms"] for r in rows), sum(max(r["bytes_ms"], r["dw_ms"]) for r in rows)
    emit({"phase": phase.replace("_shapes", "_forward"), "path": path, "batch": BATCH,
          "calls": len(rows),
          "ms": ms, "plain_ms": sum(r["plain_ms"] for r in rows), "bound_ms": bound,
          "bound_share": bound / ms, "bytes": sum(r["bytes"] for r in rows),
          "dw_macs": sum(r["dw_macs"] for r in rows)})
    return rows, fails


def run_effnet_e_shapes(gen: torch.Generator, gen_np: np.random.Generator):
    """The committed EfficientNet-B0 artifact served by the unfused executor
    (``Predictor``, three requests, A 34 + E 16 launches per forward; logits
    against the plain path within TAU_B and the JAX package's fused-executor
    golden within TAU_C), then ``effnet_e_shapes``: kernel E against its
    plain version, max abs err 0, at B0's 16 depthwise calls (batch 256,
    timed) and at odd shapes, each at zero points 0, 128 and 255, and
    ``effnet_a_shapes``: kernel A at the executor's 34 calls, bit for bit,
    timed. -> (rows, launches)."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.qeffnet import (
        load_static_int8 as load_unfused)

    model = load_unfused(EFF_ARTIFACT, "cuda")
    # the main path: the committed artifact served by the unfused executor
    golden = np.load(EFF_GOLDEN)
    golden_imgs = np.random.default_rng(int(golden["seed"])).integers(
        0, 256, tuple(golden["shape"]), dtype=np.uint8)
    requests, served, forwards, launches, wall = serve(
        EFF_ARTIFACT, golden_imgs, np.random.default_rng(1), "static_int8")
    big = requests[-1]
    with torch.inference_mode():
        plain = np.concatenate([
            model(torch.from_numpy(big[i : i + BATCH]).cuda(), impl="plain").cpu().numpy()
            for i in range(0, len(big), BATCH)])
    ok_b, err_b, _ = logits_close(served[-1], plain, TAU_B)
    ok_c, err_c, atol_c = logits_close(served[1], golden["logits"][: len(served[1])], TAU_C)
    counts_ok = all(launches.get(k, 0) == EFF_UNFUSED_PER_FORWARD.get(k, 0) * forwards
                    for k in set(EFF_UNFUSED_PER_FORWARD) | set(launches))
    emit({"phase": "eff_unfused_serve", "requests": [len(r) for r in requests],
          "forwards": forwards, "launches": launches, "wall_s": wall,
          "kernel_vs_plain_max_abs_err": err_b, "vs_jax_fused_golden_max_abs_err": err_c,
          "vs_jax_fused_golden_atol": atol_c})
    if not (ok_b and ok_c and counts_ok):
        raise SmokeFailure(f"eff_unfused_serve: kernel vs plain {ok_b} ({err_b}), vs the JAX "
                           f"golden {ok_c} ({err_c}), launches {launches} in {forwards}")
    mixed = load_unfused(EFF_ARTIFACT, "cuda", executor="mixed")
    fwd = {}
    with torch.inference_mode():
        for b in (1, BATCH):
            x = torch.from_numpy(np.random.default_rng(2).integers(
                0, 256, (b, *golden_imgs.shape[1:]), dtype=np.uint8)).cuda()
            fwd[f"unfused_forward_ms_b{b}"] = time_ms(lambda: model(x))
            fwd[f"mixed_forward_ms_b{b}"] = time_ms(lambda: mixed(x))
        emit({"phase": "eff_unfused_forward", **fwd,
              "unfused_profile_b256": profile_forward(model, x)})
    del mixed, x
    rows, fails = check_e_main_shapes(model, gen, "efficientnet_b0_unfused")
    a_rows, f = check_unfused_a_shapes(model, gen, "efficientnet_b0_unfused", "effnet_a_shapes")
    rows += a_rows
    fails += f
    odd = []
    for n, h, w, c, k, stride in E_ODD_SHAPES:
        leaf = {"w_q": torch.from_numpy(gen_np.integers(-127, 128, (k, k, 1, c),
                                                        dtype=np.int8)).cuda(),
                "w_scale": torch.from_numpy(gen_np.uniform(0.002, 0.02, c)
                                            .astype(np.float32)).cuda(),
                "bias": torch.from_numpy(gen_np.standard_normal(c).astype(np.float32)).cuda()}
        for in_zp, out_zp in E_ZPS:
            x = int8_around((n, h, w, c), in_zp, gen)
            kw = dict(stride=stride, in_scale=0.04, in_zp=in_zp, out_scale=0.03, out_zp=out_zp)
            row, f = e_row("odd", f"{h}x{w}x{c} k{k} s{stride}", x, leaf, kw, timed=False)
            odd.append(row)
            fails += f
    emit({"phase": "effnet_e_odd_shapes", "checks": len(odd),
          "max_abs_err": max(r["max_abs_err"] for r in odd), "failed": fails})
    if fails:
        raise SmokeFailure("kernels E and A disagree with their plain versions at B0's "
                           "unfused calls:\n" + "\n".join(fails))
    return rows, launches


def chain_images(size: int, n: int = 64) -> np.ndarray:
    """``n`` seeded surrogate images of ``size`` x ``size``, every class."""
    from inference_efficient_vision_models_tpu_torch.data.synthetic import make_synthetic_neudet

    return make_synthetic_neudet(-(-n // 6), image_size=size, seed=9)[0][:n]


def block_outputs(model, x: torch.Tensor, impl: str = "plain") -> dict:
    """Each block's int8 output in a forward of an unfused or mixed
    EfficientNet or MobileNetV2 (``qeffnet.QEffNetInt8Unfused``) on raw
    uint8 images."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.engine import quant_module

    from inference_efficient_vision_models_tpu_torch.compress.quant.qeffnet import stem_int8

    fam = quant_module(model.spec)
    block = fam.block_int8 if model.executor == "int8" else fam.block_mixed
    q = model.q
    cur = stem_int8(q, x, impl=impl, act=fam.ACT)
    cur_s, cur_z = q["stem"]["out_scale"], q["stem"]["out_zp"]
    outs = {}
    for name, k, stride, residual in fam.block_plan(model.spec):
        blk = q["blocks"][name]
        cur = outs[name] = block(blk, cur, cur_s, cur_z, kernel=k, stride=stride,
                                 residual=residual, impl=impl)
        cur_s, cur_z = blk["out_scale"], blk["out_zp"]
    return outs


def run_effnet_chain_int8(dev, gen: torch.Generator, quant_dir: str):
    """``effnet_chain_int8`` (``run_mbconv_chain_int8`` on the EfficientNet
    chain's artifact: launches per forward unfused A 34 + E 16, fused A 3 +
    C 48, mixed A 34)."""
    return run_mbconv_chain_int8(dev, gen, quant_dir, "efficientnet_b0", "effnet", {
        "static_int8": EFF_UNFUSED_PER_FORWARD, "static_int8_fused": EFF_PER_FORWARD,
        "static_int8_mixed": EFF_MIXED_PER_FORWARD})


def run_mbconv_chain_int8(dev, gen: torch.Generator, quant_dir: str, model_name: str,
                          tag: str, per: dict):
    """``{tag}_chain_int8``: a stage chain's static-INT8 MBConv network served
    three ways through ``load_quantized`` -> ``Predictor.from_artifact``
    (launches counted per forward against ``per``), each forward held to its
    own ``impl="plain"`` on 64 images (unfused and fused bit for bit, mixed
    within TAU_B), every fused block to the unfused one (teacher forcing,
    within one quantum, >= 98% exact), the forwards timed at batch 1 and
    256; then each kernel at the chain model's shapes against its plain
    version (kernels C and E timed; kept out of the kernels line's sums).
    -> (rows, {path: launches})."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.engine import quant_module
    from inference_efficient_vision_models_tpu_torch.compress.quant.qeffnet import stem_int8
    from inference_efficient_vision_models_tpu_torch.serving import load_quantized

    models = {m: load_quantized(quant_dir, m, device="cuda")[1] for m in per}
    fam = quant_module(models["static_int8"].spec)
    hw = 2 * models["static_int8"].q["stem"]["e"].shape[1]  # the size it was converted for
    imgs = chain_images(hw)
    x = torch.from_numpy(imgs).cuda()
    pipe = f"{model_name}_pipeline"
    logits, launches_by, fails = {}, {}, []
    with torch.inference_mode():
        for method, model in models.items():
            # one forward of the 64 images, the batch the plain path runs
            pred = Predictor.from_artifact(quant_dir, method, device="cuda",
                                           batch_size=len(imgs))
            pred.warmup(imgs.shape[1:])
            _lib.reset_launch_counts()
            served = pred.predict_logits(imgs)
            torch.cuda.synchronize()
            launches = dict(_lib.launches)
            launches_by[f"{pipe}_{method}"] = launches
            kern, plain = model(x), model(x, impl="plain")
            torch.cuda.synchronize()
            kern, plain = kern.cpu().numpy(), plain.cpu().numpy()
            logits[method] = kern
            if method == "static_int8_mixed":
                ok, err, _ = logits_close(kern, plain, TAU_B)
            else:
                ok, err = bool(np.array_equal(kern, plain)), float(np.abs(kern - plain).max())
            s_ok, s_err, s_atol = logits_close(served, plain, TAU_B)
            fwd = {}
            for b in (1, BATCH):
                xb = torch.from_numpy(np.random.default_rng(2).integers(
                    0, 256, (b, hw, hw, 3), dtype=np.uint8)).cuda()
                fwd[f"forward_ms_b{b}"] = time_ms(lambda: model(xb))
            counts_ok = launches == per[method]
            emit({"phase": f"{tag}_chain_int8", **_stage_card(dev), "method": method,
                  "images": len(imgs), "launches_per_forward": launches,
                  "expected_launches": per[method], "kernel_vs_plain_max_abs_err": err,
                  "kernel_vs_plain_ok": ok, "served_vs_plain_max_abs_err": s_err,
                  "served_atol": s_atol, "logit_scale": float(np.abs(plain).max()), **fwd,
                  "images_per_s_b256": BATCH / fwd[f"forward_ms_b{BATCH}"] * 1e3})
            if not (ok and s_ok and counts_ok):
                fails.append(f"{method}: kernel vs plain {ok} ({err}), served {s_ok} ({s_err}), "
                             f"launches {launches} (expected {per[method]})")
            if method == "static_int8":
                emit({"phase": f"{tag}_chain_int8_profile_b256",
                      **profile_forward(model, xb)})
        # every fused block (kernel C) fed the unfused executor's input, against
        # the unfused block's output
        unfused, fused = models["static_int8"], models["static_int8_fused"]
        outs, per_block = block_outputs(unfused, x), []
        prev = stem_int8(unfused.q, x, impl="plain", act=fam.ACT)
        for name, k, stride, residual in fam.block_plan(unfused.spec):
            got = fused_mbconv_block(prev, fused.qf[name], kernel=k, stride=stride, act=fam.ACT,
                                     x_res=prev if residual else None)
            b_ok, b_err, exact = compare_block(got, outs[name])
            per_block.append({"block": name, "max_abs_err": b_err, "exact": exact})
            if not b_ok:
                fails.append(f"fused block {name} vs unfused: max abs err {b_err}, exact {exact}")
            prev = outs[name]
    u, f = logits["static_int8"], logits["static_int8_fused"]
    emit({"phase": f"{tag}_chain_fused_vs_unfused", "images": len(imgs),
          "worst_exact": min(r["exact"] for r in per_block),
          "max_abs_err": max(r["max_abs_err"] for r in per_block), "blocks": per_block,
          "logits_max_abs_diff_over_scale": float(np.abs(f - u).max() / np.abs(u).max()),
          "argmax_agreement": float((f.argmax(1) == u.argmax(1)).mean()),
          "mixed_vs_unfused_over_scale": float(np.abs(logits["static_int8_mixed"] - u).max()
                                               / np.abs(u).max())})
    if fails:
        raise SmokeFailure(f"{tag}_chain_int8:\n" + "\n".join(fails))

    # each kernel at the chain model's shapes against its plain version
    rows, fails = check_e_main_shapes(unfused, gen, pipe, f"{tag}_chain_e_shapes")
    c_rows, f2 = eff_check_and_time_main_shapes(fused, gen, pipe)
    rows += c_rows
    fails += f2
    for label, shape, dtype, leaf, kw in unfused_a_calls(unfused, BATCH):
        row, f3 = kernel_a_row(pipe, f"unfused.{label}",
                               make_input(shape, dtype, kw["in_zp"], gen), leaf, kw, timed=False)
        rows.append(row)
        fails += f3
    emit({"phase": f"{tag}_chain_kernels", "checks": len(rows),
          "max_abs_err": max(r["max_abs_err"] for r in rows), "failed": fails})
    if fails:
        raise SmokeFailure("kernels disagree at the chain model's shapes:\n" + "\n".join(fails))
    return rows, launches_by


# --------------------------------------------------------------------------
# the ViT-Tiny path: kernel D (dense + GELU) and kernel A
# --------------------------------------------------------------------------


# kernel D's tolerance (compare's atol): bf16 within one bf16 ulp, 1e-4 near
# GELU's zero, where the fp32 sums' order moves an output that rounds to a
# tiny bf16 value; fp32 rtol 1e-5 / atol 1e-5
DENSE_ATOL = {torch.bfloat16: 1e-4, torch.float32: 1e-5}


def dense_inputs(m: int, k: int, n: int, dtype, gen: torch.Generator):
    """LayerNorm-like x (m, k), w with std 1/sqrt(k), b: outputs of order one."""
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((k, n), generator=gen, device="cuda") / k**0.5).to(dtype)
    b = torch.randn((n,), generator=gen, device="cuda").to(dtype)
    return x, w, b


def dense_cost_ms(m: int, k: int, n: int, dtype):
    """(bytes ms, operations ms) of one dense_gelu call: x, w, b read once,
    out written once; bf16 products on the tensor cores, fp32 FMAs on the
    CUDA cores (the function is exact fp32, not TF32)."""
    e = torch.empty((), dtype=dtype).element_size()
    nbytes = (m * k + k * n + n + m * n) * e
    ops_ms = (2 * m * k * n / BF16_FLOPS_PER_S if dtype == torch.bfloat16
              else m * k * n / FP32_FMA_PER_S) * 1e3
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3, ops_ms


def vit_check_dense(gen: torch.Generator):
    """(a) kernel D against its plain version at odd shapes (ragged M, N, K; K
    not a multiple of 16 or of 8; K past the Hopper route's 192; the
    element-wise loaders; activations at a 16-byte and at a 2-byte offset,
    which take the Hopper and the general route) and at the served shapes:
    the mlp1 of one batch-256 forward (M = 256 * 197) in bf16 and fp32, and
    of a batch-1 forward (M = 197). Returns the kernels-line rows (the bf16
    batch-256 call, 12 per forward) and the failures."""
    import torch.nn.functional as F

    fails, err_max, checks = [], {"bfloat16": 0.0, "float32": 0.0}, 0
    for m, k, n in [(77, 40, 24), (300, 72, 168), (333, 13, 37), (1000, 768, 192), (129, 8, 8),
                    (5, 200, 130), (4097, 72, 24), (50, 16, 1000), (3000, 192, 8),
                    (64, 192, 136), (65, 184, 200)]:
        for dtype in (torch.bfloat16, torch.float32):
            x, w, b = dense_inputs(m, k, n, dtype, gen)
            views = [x]
            if m == 300:  # the same rows at an element offset of 8 (16-byte aligned) and 1
                flat = torch.randn((m * k + 8,), generator=gen, device="cuda").to(dtype)
                views += [flat[8:].view(m, k), flat[1 : 1 + m * k].view(m, k)]
            for xv in views:
                ok, err = compare(dense_gelu(xv, w, b), dense_gelu_plain(xv, w, b),
                                  DENSE_ATOL[dtype])
                checks += 1
                err_max[str(dtype)[6:]] = max(err_max[str(dtype)[6:]], err)
                if not ok:
                    fails.append(f"dense_gelu {m}x{k}x{n} {dtype} offset {xv.storage_offset()}: "
                                 f"max abs err {err}")
    emit({"phase": "vit_a_dense_odd_shapes", "checks": checks, "max_abs_err": err_max,
          "failed": fails})
    rows = []
    d, hidden, tokens = 192, 768, 197
    for m, dtype in [(BATCH * tokens, torch.bfloat16), (BATCH * tokens, torch.float32),
                     (tokens, torch.bfloat16)]:
        x, w, b = dense_inputs(m, d, hidden, dtype, gen)
        ok, err = compare(dense_gelu(x, w, b), dense_gelu_plain(x, w, b), DENSE_ATOL[dtype])
        if not ok:
            fails.append(f"dense_gelu served {m}x{d}x{hidden} {dtype}: max abs err {err}")
        nbytes, bytes_ms, ops_ms = dense_cost_ms(m, d, hidden, dtype)
        row = {
            "path": "vit_tiny_float", "kernel": "dense_gelu", "call": "mlp1", "x": [m, d],
            "n": hidden, "dtype": str(dtype)[6:], "max_abs_err": err,
            "ms": time_ms(lambda: dense_gelu(x, w, b), spin=True),
            "plain_ms": time_ms(lambda: dense_gelu_plain(x, w, b), spin=True),
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "library_ms": time_ms(lambda: F.gelu(torch.addmm(b, x, w), approximate="none"),
                                  spin=True),
            "library": "torch.addmm + F.gelu(approximate='none') in the same dtype",
            "calls": 12,
            # the kernels line sums the served forward: bf16 at batch 256
            "in_forward": m == BATCH * tokens and dtype == torch.bfloat16,
        }
        rows.append(row)
        emit({"phase": "vit_a_dense_main_shape", **row})
        del x, w, b
    return rows, fails


def vit_kernel_a_calls(model, b: int):
    """Kernel A's calls of one forward at batch b (the carrier's dtypes): the
    u8 patch embed, then per block qkv, proj, mlp1 and mlp2 (on the bf16
    carrier mlp1 requantizes to mlp2's input, the int8 MLP pair), and the
    head: (label, x shape, x dtype, leaf, kwargs, calls per forward)."""
    spec, q = model.spec, model.q
    act = model.act_dtype
    blk = q["blocks"]["0"]
    t, d = spec.tokens, spec.dim
    hidden = blk["mlp1"]["w"].n
    pe = q["patch_embed"]

    def qp(leaf):
        return dict(in_scale=leaf["in_scale"], in_zp=leaf["in_zp"])

    calls = [("patch_embed", (b * (t - 1), pe["w"].k), torch.int8, pe,
              dict(in_scale=1.0, in_zp=128), 1),
             ("qkv", (b * t, d), act, blk["qkv"], dict(**qp(blk["qkv"]), out_dtype=act), 12),
             ("proj", (b * t, d), act, blk["proj"], dict(**qp(blk["proj"]), out_dtype=act), 12)]
    if act == torch.float32:
        calls += [("mlp1", (b * t, d), act, blk["mlp1"], dict(**qp(blk["mlp1"]), act="gelu"), 12),
                  ("mlp2", (b * t, hidden), act, blk["mlp2"], qp(blk["mlp2"]), 12)]
    else:
        calls += [("mlp1", (b * t, d), act, blk["mlp1"],
                   dict(**qp(blk["mlp1"]), act="gelu", out_scale=blk["mlp2"]["in_scale"],
                        out_zp=blk["mlp2"]["in_zp"]), 12),
                  ("mlp2", (b * t, hidden), torch.int8, blk["mlp2"],
                   dict(**qp(blk["mlp2"]), out_dtype=act), 12)]
    calls.append(("head", (b, d), act, q["head"], qp(q["head"]), 1))
    return calls


def vit_check_kernel_a(model, path: str, gen: torch.Generator):
    """(a) kernel A at every ViT shape of one carrier, batch 256 and 1, and
    the timings."""
    rows, fails = [], []
    for b in (BATCH, 1):
        for label, shape, dtype, leaf, kw, calls in vit_kernel_a_calls(model, b):
            if dtype == torch.int8:
                x = make_input(shape, dtype, kw["in_zp"], gen)
            else:
                x = (torch.randn(shape, generator=gen, device="cuda") * 1.5).to(dtype)
            row, f = kernel_a_row(path, label, x, leaf, kw, batch=b, calls=calls)
            rows.append(row)
            fails += f
            emit({"phase": "vit_a_main_shape", **row})
    return rows, fails


def count_forwards(fn, xs, want: dict, label: str):
    """Run ``fn`` on each input with the launch counters set to 0 just before
    and read just after; each forward must launch ``want``."""
    _lib.reset_launch_counts()
    with torch.inference_mode():
        outs = [fn(x) for x in xs]
    torch.cuda.synchronize()
    launches = dict(_lib.launches)
    for k in set(want) | set(launches):
        if launches.get(k, 0) != want.get(k, 0) * len(xs):
            raise SmokeFailure(f"(d) {k} launched {launches.get(k, 0)} times in {len(xs)} "
                               f"{label} forwards, expected {want.get(k, 0) * len(xs)}")
    return outs, launches


def run_vit(gen: torch.Generator):
    """Every phase of the ViT-Tiny path; -> (rows, launches by path)."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.qvit import load_static_int8
    from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images
    from inference_efficient_vision_models_tpu_torch.models import vit

    rows, fails = vit_check_dense(gen)
    models = {"vit_tiny_int8": load_static_int8(VIT_ARTIFACT, "cuda", act_dtype=torch.float32),
              "vit_tiny_int8_bf16": load_static_int8(VIT_ARTIFACT, "cuda",
                                                     act_dtype=torch.bfloat16)}
    for path, model in models.items():
        r, f = vit_check_kernel_a(model, path, gen)
        rows += r
        fails += f
    if fails:
        raise SmokeFailure("ViT kernels disagree with their plain versions:\n" + "\n".join(fails))

    golden = np.load(VIT_GOLDEN)
    golden_imgs = np.random.default_rng(int(golden["seed"])).integers(
        0, 256, tuple(golden["shape"]), dtype=np.uint8)
    spec = models["vit_tiny_int8"].spec
    params_np = vit_params_from_seed(spec, int(golden["param_seed"]))
    if not np.array_equal(leaf_sums(params_np), golden["param_sums"]):
        raise SmokeFailure("vit_params_from_seed no longer gives the weights the goldens used")
    params = vit.params_from_jax(params_np, "cuda")
    launches_by_path, checks = {}, []

    # serving both int8 carriers; (b) kernel path against the plain path on 32
    # images; (c) served logits against the JAX golden of the route each takes
    small = torch.from_numpy(golden_imgs).cuda()
    x32 = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (32, *golden_imgs.shape[1:]), dtype=np.uint8)).cuda()
    for path, method, route in [("vit_tiny_int8_bf16", "static_int8_bf16", "int8_bf16_pair"),
                                ("vit_tiny_int8", "static_int8", "int8_f32")]:
        model = models[path]
        requests, served, forwards, launches, wall = serve(
            VIT_ARTIFACT, golden_imgs, np.random.default_rng(1), method)
        launches_by_path[path] = launches
        emit({"phase": f"{path}_serve", "requests": [len(r) for r in requests],
              "forwards": forwards, "launches": launches, "wall_s": wall,
              "served_images_per_s": sum(len(r) for r in requests) / wall})
        for r, out in zip(requests, served):
            if out.shape != (len(r), spec.num_classes) or not np.isfinite(out).all():
                raise SmokeFailure(f"{path}: served logits have shape {out.shape} or are "
                                   f"not finite")
        for k in set(VIT_PER_FORWARD) | set(launches):  # (d)
            want = VIT_PER_FORWARD.get(k, 0) * forwards
            if launches.get(k, 0) != want:
                raise SmokeFailure(f"(d) {k} launched {launches.get(k, 0)} times in {forwards} "
                                   f"{path} forwards, expected {want}")
        with torch.inference_mode():
            got, plain = model(x32).cpu().numpy(), model(x32, impl="plain").cpu().numpy()
        checks.append((f"{path}_b_kernel_vs_plain_forward", got, plain, VIT_TAU_B))
        checks.append((f"{path}_c_served_vs_jax_golden", served[-1][: len(golden_imgs)],
                       golden[route], VIT_TAU[route]))

    # the float forward with the fused mlp1 + GELU on kernel D: the main path
    # is the bf16 forward on the golden images, at batch 256 and at batch 1
    def fwd(dtype, impl="kernel"):
        return lambda u8: vit.apply(spec, params, {}, normalize_images(u8), compute_dtype=dtype,
                                    fused_mlp=True, impl=impl)[0]

    xb = {b: torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (b, *golden_imgs.shape[1:]), dtype=np.uint8)).cuda() for b in (1, BATCH)}
    outs, launches = count_forwards(fwd(torch.bfloat16), [small, xb[BATCH], xb[1]],
                                    VIT_FLOAT_PER_FORWARD, "float bf16")
    launches_by_path["vit_tiny_float"] = launches
    emit({"phase": "vit_tiny_float_launches", "forwards": 3, "launches": launches})
    outs32, _ = count_forwards(fwd(torch.float32), [small], VIT_FLOAT_PER_FORWARD, "float fp32")
    for dtype, route, out in [(torch.bfloat16, "float_bf16", outs[0]),
                              (torch.float32, "float_f32", outs32[0])]:
        with torch.inference_mode():
            got, plain = fwd(dtype)(x32).cpu().numpy(), fwd(dtype, "plain")(x32).cpu().numpy()
        tau_b = VIT_TAU_B if dtype == torch.bfloat16 else VIT_TAU["float_f32"]
        checks.append((f"vit_tiny_{route}_b_kernel_vs_plain_forward", got, plain, tau_b))
        checks.append((f"vit_tiny_{route}_c_vs_jax_golden", out.cpu().numpy(), golden[route],
                       VIT_TAU[route]))
    for name, got, ref, tau in checks:
        ok, err, atol = logits_close(got, ref, tau)
        emit({"phase": name, "images": len(ref), "max_abs_err": err, "atol": atol, "tau": tau,
              "max_abs_err_over_scale": err / float(np.abs(ref).max()),
              "argmax_identical": bool((got.argmax(1) == ref.argmax(1)).all())})
        if not ok:
            raise SmokeFailure(f"{name}: {err} > {atol} or an argmax differs")

    # forward times (CUDA events) and a batch-256 profile of each forward
    fwd_ms = {}
    with torch.inference_mode():
        for path, model in models.items():
            for b in (1, BATCH):
                fwd_ms[f"{path}_b{b}"] = time_ms(lambda: model(xb[b]))
                fwd_ms[f"{path}_plain_b{b}"] = time_ms(lambda: model(xb[b], impl="plain"))
            emit({"phase": f"{path}_profile_b256", **profile_forward(model, xb[BATCH], 1)})
        for b in (1, BATCH):
            fwd_ms[f"vit_tiny_float_bf16_b{b}"] = time_ms(lambda: fwd(torch.bfloat16)(xb[b]))
            fwd_ms[f"vit_tiny_float_bf16_plain_b{b}"] = time_ms(
                lambda: fwd(torch.bfloat16, "plain")(xb[b]))
        fwd_ms[f"vit_tiny_float_f32_b{BATCH}"] = time_ms(lambda: fwd(torch.float32)(xb[BATCH]))
        emit({"phase": "vit_tiny_float_bf16_profile_b256",
              **profile_forward(fwd(torch.bfloat16), xb[BATCH], 1)})
    fwd_ms.update({f"{k}_images_per_s": BATCH / v * 1e3 for k, v in list(fwd_ms.items())
                   if k.endswith(f"_b{BATCH}")})
    emit({"phase": "vit_forward", **fwd_ms})
    return rows, launches_by_path



# --------------------------------------------------------------------------
# the ViT through stages 1-4: kernel A's dynamic route, the chain's
# INT8 model on three executors, its float artifacts, a head-pruned model
# --------------------------------------------------------------------------


VIT_DYN_PER_FORWARD = {"int8_matmul_requant": 49}  # the patch embed is a float conv
VIT_HEAD_PRUNE = dict(ratio=0.34, method="l2", round_to=8)  # 2 of 3 heads a block


def vit_dyn_calls(model, b: int):
    """Kernel A's calls of one dynamic forward at batch b: (label, x shape,
    leaf, calls per forward); every input fp32, qparams per call."""
    spec, q = model.spec, model.q
    blk, t, d = q["blocks"]["0"], spec.tokens, spec.dim
    return [("qkv", (b * t, d), blk["qkv"], spec.depth),
            ("proj", (b * t, blk["proj"]["w"].k), blk["proj"], spec.depth),
            ("mlp1", (b * t, d), blk["mlp1"], spec.depth),
            ("mlp2", (b * t, blk["mlp2"]["w"].k), blk["mlp2"], spec.depth),
            ("head", (b, d), q["head"], 1)]


def dyn_input(label: str, shape, gen: torch.Generator) -> torch.Tensor:
    """A LayerNorm-like activation, or for mlp2 a GELU's output."""
    x = torch.randn(shape, generator=gen, device="cuda") * 1.5
    return torch.nn.functional.gelu(x) if label == "mlp2" else x


def kernel_a_dyn_row(path: str, label: str, x: torch.Tensor, leaf, *, batch: int = BATCH,
                     calls: int = 1, timed: bool = True):
    """Kernel A's dynamic route at one call: exact against its plain version
    on the same qparams buffer, then (``timed``) its time beside the plain
    version's, the qparams step's, its bound (x, weight, vectors and the
    32-byte buffer read once, the fp32 output written once) and
    torch._int_mm's (the GEMM only)."""
    from inference_efficient_vision_models_tpu_torch.ops import (
        dynamic_qparams, int8_matmul_requant_dynamic, int8_matmul_requant_dynamic_plain)

    qp = dynamic_qparams(x)
    args = (x, leaf["w"], leaf["w_scale"], leaf["bias"], leaf["w_sum"], qp)
    ok, err = compare_exact(int8_matmul_requant_dynamic(*args),
                            int8_matmul_requant_dynamic_plain(*args))
    nbytes, ops = cost("int8_matmul_requant", x, leaf, {})
    nbytes += qp.numel() * qp.element_size()
    row = {
        "path": path, "kernel": "int8_matmul_requant", "route": "dynamic", "call": label,
        "batch": batch, "x": list(x.shape), "x_dtype": str(x.dtype)[6:], "n": leaf["w"].n,
        "max_abs_err": err, "bytes": nbytes, "ops": ops,
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / INT8_OPS_PER_S * 1e3,
        "calls": calls, "in_forward": batch == BATCH,
    }
    if timed:
        lib, lib_note = int_mm_ms(x, leaf)
        row.update({
            "ms": time_ms(lambda: int8_matmul_requant_dynamic(*args), spin=True),
            "plain_ms": time_ms(lambda: int8_matmul_requant_dynamic_plain(*args), spin=True),
            "qparams_ms": time_ms(lambda: dynamic_qparams(x), spin=True),
            "library_ms": lib, **({"library_note": lib_note} if lib_note else {})})
    return row, [] if ok else [f"int8_matmul_requant dynamic {path} {label} {tuple(x.shape)} "
                               f"b{batch}: max abs err {err}"]


def dyn_odd_shapes(gen: torch.Generator):
    """Kernel A's dynamic route at odd shapes: K 13..1000 (16-byte, 4-byte and
    element loads), M 1 and 197, N 6..576, inputs all positive, all negative
    and mixed, fp32 and bf16 in and out; each equal to its plain version."""
    from inference_efficient_vision_models_tpu_torch.ops import (
        dynamic_qparams, int8_matmul_requant_dynamic, int8_matmul_requant_dynamic_plain)

    fails, checks = [], 0
    for m in (1, 197):
        for k in (13, 27, 50, 192, 504, 768, 1000):
            for n, shift in ((6, 0.0), (37, 3.0), (576, -3.0)):
                w = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                                  dtype=torch.int8)
                leaf = {"w": pack_weight(w), "bias": torch.randn(n, generator=gen, device="cuda"),
                        "w_scale": torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-3,
                        "w_sum": w.to(torch.int32).sum(0, dtype=torch.int32)}
                x = torch.randn((m, k), generator=gen, device="cuda") * 2 + shift
                for xd, od in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)):
                    xx = x.to(xd)
                    qp = dynamic_qparams(xx)
                    args = (xx, leaf["w"], leaf["w_scale"], leaf["bias"], leaf["w_sum"], qp)
                    ok, err = compare_exact(int8_matmul_requant_dynamic(*args, out_dtype=od),
                                            int8_matmul_requant_dynamic_plain(*args, out_dtype=od))
                    checks += 1
                    if not ok:
                        fails.append(f"dynamic {m}x{k}x{n} {xd} shift {shift}: max abs err {err}")
    emit({"phase": "vit_dynamic_odd_shapes", "checks": checks, "failed": fails})
    return fails


def run_vit_dynamic(dev, gen: torch.Generator):
    """``vit_dynamic_shapes`` and ``vit_dynamic_logits``: kernel A's dynamic
    route at the 49 calls of a seeded full-width ViT-Tiny's dynamic INT8
    forward (batch 256, timed, and batch 1) and at odd shapes, each equal to
    its plain version; then the whole forward on 8 seeded images, launches
    counted (49), under ``torch.cuda.set_sync_debug_mode("error")``, equal
    to its plain path and against the JAX golden (``VIT_DYN_TAU``); the
    forward timed at batch 1 and 256 and profiled.
    -> (rows, {path: launches})."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import qvit
    from inference_efficient_vision_models_tpu_torch.models.vit import vit_spec

    spec = vit_spec("vit_tiny_patch16_224", 6)
    params = vit_params_from_seed(spec, VIT_SEED)
    golden = np.load(VIT_DYN_GOLDEN)
    if not np.array_equal(leaf_sums(params), golden["param_sums"]):
        raise SmokeFailure("vit_params_from_seed no longer gives the dynamic golden's weights")
    model = qvit.from_dynamic_qmodel(spec, qvit.convert_dynamic_int8(spec, params), "cuda")
    rows, fails = [], []
    for b in (BATCH, 1):
        for label, shape, leaf, calls in vit_dyn_calls(model, b):
            row, f = kernel_a_dyn_row("vit_tiny_dynamic", label, dyn_input(label, shape, gen),
                                      leaf, batch=b, calls=calls)
            rows.append(row)
            fails += f
            emit({"phase": "vit_dynamic_shapes", **row})
    fails += dyn_odd_shapes(gen)
    if fails:
        raise SmokeFailure("kernel A's dynamic route disagrees with its plain version:\n"
                           + "\n".join(fails))

    x8 = torch.from_numpy(vit_dyn_images()).cuda()
    with torch.inference_mode():
        model(x8)  # the first call makes the tensor maps and normalization constants
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = model(x8)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launches = dict(_lib.launches)
        plain = model(x8, impl="plain")
        got, plain = got.cpu().numpy(), plain.cpu().numpy()
    if launches != VIT_DYN_PER_FORWARD:
        raise SmokeFailure(f"(d) the dynamic ViT launched {launches}, expected "
                           f"{VIT_DYN_PER_FORWARD} a forward")
    ok, err, atol = logits_close(got, golden["logits"], VIT_DYN_TAU)
    emit({"phase": "vit_dynamic_logits", **_stage_card(dev), "images": len(got),
          "launches_per_forward": launches, "sync_debug_mode": "error",
          "kernel_vs_plain_equal": bool(np.array_equal(got, plain)),
          "kernel_vs_plain_max_abs_err": float(np.abs(got - plain).max()),
          "vs_jax_max_abs_err": err, "atol": atol, "tau": VIT_DYN_TAU,
          "vs_jax_over_scale": err / float(np.abs(golden["logits"]).max()),
          "argmax_identical": bool((got.argmax(1) == golden["logits"].argmax(1)).all())})
    if not np.array_equal(got, plain):
        raise SmokeFailure("vit_dynamic_logits: the kernel path differs from its plain path")
    if not ok:
        raise SmokeFailure(f"vit_dynamic_logits: {err} > {atol} against the JAX golden")
    fwd = {}
    with torch.inference_mode():
        for b in (1, BATCH):
            xb = torch.from_numpy(np.random.default_rng(2).integers(
                0, 256, (b, 224, 224, 3), dtype=np.uint8)).cuda()
            fwd[f"forward_ms_b{b}"] = time_ms(lambda: model(xb))
            fwd[f"plain_forward_ms_b{b}"] = time_ms(lambda: model(xb, impl="plain"))
        emit({"phase": "vit_tiny_dynamic_forward", **_stage_card(dev), **fwd,
              "images_per_s_b256": BATCH / fwd[f"forward_ms_b{BATCH}"] * 1e3})
        emit({"phase": "vit_tiny_dynamic_profile_b256", **profile_forward(model, xb, 1)})
    return rows, {"vit_tiny_dynamic": launches}


def run_convert_vit(dev):
    """``convert_vit``: the seeded full-width ViT-Tiny folded, calibrated
    (minmax, 48 surrogate 224x224 images, batch 16) and converted on the
    card, against the JAX package's CPU record (op by op): every
    non-activation leaf equal by sha256, every activation scale within
    ``VIT_CONVERT_LIMITS``, zero points equal or one apart on an edge."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import qvit

    with open(VIT_CONVERT_GOLDEN) as f:
        rec = json.load(f)
    spec, p, s, imgs, labels = vit_convert_inputs(VIT_CONVERT)
    if leaf_sums(p).tolist() != rec["provenance"]["param_sums"]:
        raise SmokeFailure("convert_vit: the seeded weights are no longer the record's")
    q, _, t = port_convert_effnet(spec, p, s, imgs, labels, "cuda", VIT_CONVERT)
    report = compare_conversion(qvit.serializable(q), rec, VIT_CONVERT_LIMITS, _vit_tap_of)
    emit({"phase": "convert_vit", **_stage_card(dev), "images": len(imgs), **t,
          "limits": VIT_CONVERT_LIMITS, **report})
    if not report["ok"]:
        raise SmokeFailure(f"convert_vit: {report}")


def vit_int8_models(spec, q: dict, dyn: dict):
    """The three INT8 executors of one conversion: {path suffix: (model,
    launches a forward, kernel-vs-plain check)}."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import qvit

    return {
        "int8": (qvit.from_jax_qmodel(spec.to_dict(), q, "cuda", torch.float32),
                 VIT_PER_FORWARD, VIT_TAU_B),
        "int8_bf16": (qvit.from_jax_qmodel(spec.to_dict(), q, "cuda", torch.bfloat16),
                      VIT_PER_FORWARD, VIT_TAU_B),
        "dynamic": (qvit.from_dynamic_qmodel(spec, dyn, "cuda"), VIT_DYN_PER_FORWARD, 0.0),
    }


def check_vit_executors(dev, phase: str, path: str, models: dict, x: torch.Tensor):
    """Each executor: one forward of ``x`` with the launches counted (exactly
    its count a forward), its kernel path against its plain path (the
    dynamic one equal, the static ones within their tau). -> {path: launches}."""
    by, fails = {}, []
    for suffix, (model, per, tau) in models.items():
        outs, launches = count_forwards(model, [x], per, f"{path}_{suffix}")
        by[f"{path}_{suffix}"] = launches
        with torch.inference_mode():
            plain = model(x, impl="plain").cpu().numpy()
        got = outs[0].cpu().numpy()
        if tau == 0.0:
            ok, err = bool(np.array_equal(got, plain)), float(np.abs(got - plain).max())
        else:
            ok, err, _ = logits_close(got, plain, tau)
        emit({"phase": phase, **_stage_card(dev), "executor": suffix, "images": len(got),
              "launches_per_forward": launches, "kernel_vs_plain_max_abs_err": err, "tau": tau,
              "kernel_vs_plain_ok": ok, "logit_scale": float(np.abs(plain).max()),
              "finite": bool(np.isfinite(got).all())})
        if not ok or not np.isfinite(got).all():
            fails.append(f"{suffix}: max abs err {err}")
    if fails:
        raise SmokeFailure(f"{phase}:\n" + "\n".join(fails))
    return by


def run_vit_head_pruned(dev):
    """A seeded full-width ViT-Tiny pruned to 2 of its 3 heads a block
    (``VIT_HEAD_PRUNE``: qkv N 384, proj K 128, MLP units l2 round_to 8),
    calibrated and converted on the card, on the three INT8 executors:
    kernel path against plain path on 32 images, launches 50 / 50 / 49."""
    from inference_efficient_vision_models_tpu_torch.compress.prune.vit_engine import prune_vit
    from inference_efficient_vision_models_tpu_torch.compress.quant import qvit

    spec, p, _, imgs, labels = vit_convert_inputs(VIT_CONVERT)
    pspec, pp, _ = prune_vit(spec, p, {}, **VIT_HEAD_PRUNE)
    q, _, t = port_convert_effnet(pspec, pp, {}, imgs, labels, "cuda", VIT_CONVERT)
    shapes = {"qkv_n": int(q["blocks"]["0"]["qkv"]["w_q"].shape[1]),
              "proj_k": int(q["blocks"]["0"]["proj"]["w_q"].shape[0])}
    emit({"phase": "vit_head_pruned", **_stage_card(dev), "head_counts": pspec.head_counts,
          "mlp_hidden": pspec.mlp_hidden, **shapes, **t})
    if pspec.head_counts != (2,) * spec.depth or shapes != {"qkv_n": 384, "proj_k": 128}:
        raise SmokeFailure(f"vit_head_pruned: {pspec.head_counts} {shapes}")
    models = vit_int8_models(pspec, q, qvit.convert_dynamic_int8(pspec, qvit.fold(pspec, pp, {})))
    x = torch.from_numpy(chain_images(224, 32)).cuda()
    return check_vit_executors(dev, "vit_head_pruned_int8", "vit_tiny_head_pruned", models, x)


def run_vit_chain_int8(dev, gen: torch.Generator, quant_dir: str):
    """``vit_chain_int8`` and ``vit_float_serve``: the ViT chain's artifacts.
    Its INT8 model on the three executors through ``load_quantized`` ->
    ``Predictor.from_artifact`` (one 32-image forward each, launches counted:
    50 / 50 / 49), each against its own plain path (the static carriers
    within VIT_TAU_B, the dynamic one equal), timed at batch 1 and 256;
    kernel A at the pruned model's calls on both routes, timed (aside in the
    kernels line); then its fp32, fp16, bf16 and W8A16 artifacts through
    ``Predictor``, each equal to its own ``apply_folded`` on the same input.
    -> (rows, {path: launches})."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import qvit, wo8
    from inference_efficient_vision_models_tpu_torch.core import artifacts
    from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images
    from inference_efficient_vision_models_tpu_torch.serving import load_quantized

    per = {"static_int8": VIT_PER_FORWARD, "static_int8_bf16": VIT_PER_FORWARD,
           "dynamic_int8": VIT_DYN_PER_FORWARD}
    imgs = chain_images(224, 32)
    x = torch.from_numpy(imgs).cuda()
    pipe = "vit_tiny_pipeline"
    launches_by, fails, models = {}, [], {}
    with torch.inference_mode():
        for method in per:
            spec, _, model, _ = load_quantized(quant_dir, method, device="cuda")
            models[method] = model
            pred = Predictor.from_artifact(quant_dir, method, device="cuda", batch_size=len(imgs))
            pred.warmup(imgs.shape[1:])
            _lib.reset_launch_counts()
            served = pred.predict_logits(imgs)
            torch.cuda.synchronize()
            launches = dict(_lib.launches)
            launches_by[f"{pipe}_{method}"] = launches
            kern, plain = model(x).cpu().numpy(), model(x, impl="plain").cpu().numpy()
            if method == "dynamic_int8":
                ok, err = bool(np.array_equal(kern, plain)), float(np.abs(kern - plain).max())
            else:
                ok, err, _ = logits_close(kern, plain, VIT_TAU_B)
            s_ok, s_err, _ = logits_close(served, plain, VIT_TAU_B)
            fwd = {}
            for b in (1, BATCH):
                xb = torch.from_numpy(np.random.default_rng(2).integers(
                    0, 256, (b, 224, 224, 3), dtype=np.uint8)).cuda()
                fwd[f"forward_ms_b{b}"] = time_ms(lambda: model(xb))
            emit({"phase": "vit_chain_int8", **_stage_card(dev), "method": method,
                  "images": len(imgs), "launches_per_forward": launches,
                  "expected_launches": per[method], "kernel_vs_plain_max_abs_err": err,
                  "kernel_vs_plain_ok": ok, "served_vs_plain_max_abs_err": s_err,
                  "logit_scale": float(np.abs(plain).max()), **fwd,
                  "images_per_s_b256": BATCH / fwd[f"forward_ms_b{BATCH}"] * 1e3})
            if not (ok and s_ok and launches == per[method]):
                fails.append(f"{method}: kernel vs plain {ok} ({err}), served {s_ok} ({s_err}), "
                             f"launches {launches} (expected {per[method]})")
    if fails:
        raise SmokeFailure("vit_chain_int8:\n" + "\n".join(fails))

    # kernel A at the pruned model's calls, both routes, timed (aside)
    rows, fails = [], []
    for label, shape, dtype, leaf, kw, calls in vit_kernel_a_calls(models["static_int8"], BATCH):
        xx = (make_input(shape, dtype, kw["in_zp"], gen) if dtype == torch.int8 else
              (torch.randn(shape, generator=gen, device="cuda") * 1.5).to(dtype))
        row, f = kernel_a_row(pipe, label, xx, leaf, kw, calls=calls)
        rows.append(row)
        fails += f
        emit({"phase": "vit_chain_a_shapes", **row})
    for label, shape, leaf, calls in vit_dyn_calls(models["dynamic_int8"], BATCH):
        row, f = kernel_a_dyn_row(pipe, f"dynamic.{label}", dyn_input(label, shape, gen), leaf,
                                  calls=calls)
        rows.append(row)
        fails += f
        emit({"phase": "vit_chain_a_shapes", **row})
    if fails:
        raise SmokeFailure("kernel A disagrees at the ViT chain's shapes:\n" + "\n".join(fails))

    # the float artifacts: the CLI writes none for fp32, so the pruned model's
    # fold is written here as the fp32 artifact (a folded cast at fp32, which
    # either package's loader serves)
    pruned = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(quant_dir))),
                          "pruning", "smoke_vit", "fold_0")
    raw = artifacts.load_checkpoint_raw(pruned, artifacts.BEST)
    with open(os.path.join(quant_dir, "model_fp32.msgpack"), "wb") as f:
        f.write(artifacts.tree_bytes(qvit.fold(spec, raw["params"], {})))
    x8 = imgs[:8]
    for method, dtype in (("fp32", torch.float32), ("fp16", torch.float16),
                          ("bf16", torch.bfloat16), ("weight_only_int8", torch.bfloat16)):
        pred = Predictor.from_artifact(quant_dir, method, device="cuda", batch_size=len(x8))
        served = pred.predict_logits(x8)
        tree = artifacts.load_checkpoint_raw(quant_dir, method)
        if method == "weight_only_int8":
            tree = wo8.dequantize(tree, torch.bfloat16)
        folded = qvit.place_folded(tree, "cuda")
        with torch.inference_mode():
            own = qvit.apply_folded(spec, folded, normalize_images(
                torch.from_numpy(x8).cuda(), dtype)).float().cpu().numpy()
        equal = bool(np.array_equal(served, own))
        emit({"phase": "vit_float_serve", **_stage_card(dev), "method": method,
              "compute_dtype": str(dtype)[6:], "images": len(x8), "equal": equal,
              "max_abs_err": float(np.abs(served - own).max()),
              "finite": bool(np.isfinite(served).all())})
        if not equal or not np.isfinite(served).all():
            raise SmokeFailure(f"vit_float_serve: {method} through Predictor is not its "
                               f"apply_folded")
    return rows, launches_by


# --------------------------------------------------------------------------
# the ResNeXt path: kernel F (grouped conv) and kernel A, and W4A16
# --------------------------------------------------------------------------


def rx_calls(model, b: int):
    """Every kernel call of one forward of a bottleneck ResNet(Xt) at batch b:
    (kernel, label, x shape, x dtype, conv leaf, kwargs), as ``apply_int8``
    makes them: the stem, each block's 1x1 conv1 (+ ReLU, requant), its
    grouped 3x3 conv2 (kernel F), its 1x1 conv3 and strided 1x1 downsample
    (fp32 out), and the fc."""
    spec, q = model.spec, model.q
    if spec.block != "bottleneck" or spec.groups == 1:
        raise SmokeFailure("rx_calls walks a ResNeXt")
    st = q["stem"]
    h = st["e4"].shape[1]
    calls = [("int8_matmul_requant", "stem", (b * h * h, st["w"].k), torch.int8, st,
              dict(in_scale=1.0, in_zp=128))]
    h = (h - 1) // 2 + 1  # max pool
    cin, in_s, in_z = spec.stem_width, st["out_scale"], st["out_zp"]
    for s, depth in enumerate(spec.depths):
        for bi in range(depth):
            blk = q[f"layer{s + 1}"][str(bi)]
            stride = spec.block_stride(s, bi)
            ho = (h - 1) // stride + 1
            c1, c2, c3 = blk["conv1"], blk["conv2"], blk["conv3"]
            tag = f"layer{s + 1}.{bi}"
            calls.append(("int8_matmul_requant", f"{tag}.conv1", (b * h * h, cin), torch.int8, c1,
                          dict(in_scale=in_s, in_zp=in_z, relu=True, out_scale=c1["out_scale"],
                               out_zp=c1["out_zp"])))
            calls.append(("gconv_int8", f"{tag}.conv2", (b, h, h, c2["w"].n), torch.int8, c2,
                          dict(stride=stride, in_scale=c1["out_scale"], in_zp=c1["out_zp"],
                               out_scale=c2["out_scale"], out_zp=c2["out_zp"])))
            calls.append(("int8_matmul_requant", f"{tag}.conv3", (b * ho * ho, c2["w"].n),
                          torch.int8, c3, dict(in_scale=c2["out_scale"], in_zp=c2["out_zp"])))
            if "down" in blk:
                calls.append(("int8_matmul_requant", f"{tag}.down", (b * ho * ho, cin),
                              torch.int8, blk["down"], dict(in_scale=in_s, in_zp=in_z)))
            h, cin, in_s, in_z = ho, spec.stage_widths[s], blk["out_scale"], blk["out_zp"]
    fc = q["fc"]
    calls.append(("int8_matmul_requant", "fc", (b, fc["w"].k), torch.float32, fc,
                  dict(in_scale=fc["in_scale"], in_zp=fc["in_zp"])))
    return calls


def f_row(path: str, label: str, x: torch.Tensor, leaf, kw, *, timed: bool = True,
          calls: int = 1):
    """Kernel F at one call, bit for bit against its plain version, its bound
    (bytes: x, out, the (3, 3, Cg, C) weights and three C-vectors once; the
    int8 MACs at the tensor cores' rate) beside its design bound (the same
    bytes, and the operations its mma issue, K and N padded, at that rate)
    and, ``timed``, its time beside the plain version's, both bounds'
    shares of it, the first design's (``GC_OLD_MS``) and cuDNN's fp16
    grouped conv at the same shape (an aside: float inputs, no requant; not
    the same function, so not ``library_ms``)."""
    args = (x, leaf["w"], leaf["w_scale"], leaf["bias"], leaf["w_sum"])
    ok, err = compare_exact(grouped_conv_int8(*args, **kw), grouped_conv_int8_plain(*args, **kw))
    n, h, w, c = x.shape
    stride, cg, groups = kw["stride"], leaf["w"].cg, leaf["w"].groups
    g = gc_geom(c, groups)
    pix = n * ((h - 1) // stride + 1) * ((w - 1) // stride + 1)
    out = pix * c
    nbytes = x.numel() + out + 9 * cg * c + 12 * c
    macs, padded = out * 9 * cg, pix * g.nwin * 32 * g.ks * 8 * g.nt
    row = {"path": path, "kernel": "gconv_int8", "call": label, "batch": n, "x": list(x.shape),
           "n": c, "groups": groups, "cg": cg, "stride": stride,
           "in_zp": int(kw["in_zp"]), "out_zp": int(kw["out_zp"]), "max_abs_err": err,
           "bytes": nbytes, "ops": 2 * macs, "macs": macs, "padded_ops": 2 * padded,
           "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": 2 * macs / INT8_OPS_PER_S * 1e3,
           "padded_ops_ms": 2 * padded / INT8_OPS_PER_S * 1e3, "library_ms": None,
           "calls": calls, "in_forward": n == BATCH,
           "old_ms": GC_OLD_MS.get((path, n), {}).get(label)}
    if timed:
        row["ms"] = time_ms(lambda: grouped_conv_int8(*args, **kw), spin=True)
        row["plain_ms"] = time_ms(lambda: grouped_conv_int8_plain(*args, **kw), runs=5, warm=1,
                                  spin=True)
        row["bound_share"] = max(row["bytes_ms"], row["ops_ms"]) / row["ms"]
        row["design_bound_ms"] = max(row["bytes_ms"], row["padded_ops_ms"])
        row["design_bound_share"] = row["design_bound_ms"] / row["ms"]
        xh = x.permute(0, 3, 1, 2).half().contiguous(memory_format=torch.channels_last)
        wh = leaf["w"].hwio.permute(3, 2, 0, 1).half().contiguous(memory_format=torch.channels_last)
        row["cudnn_fp16_ms"] = time_ms(lambda: torch.nn.functional.conv2d(
            xh, wh, stride=stride, padding=1, groups=groups), spin=True)
        del xh, wh
    return row, [] if ok else [f"gconv_int8 {path} {label} {tuple(x.shape)} {kw}: "
                               f"max abs err {err}"]


def check_rx_calls(model, gen: torch.Generator, path: str, phases: tuple, *, time_a: bool = True,
                   batches=None):
    """Each kernel call of ``model``'s forward (``rx_calls``) at ``batches``
    against its plain version, bit for bit, kernel F's rows timed and (with
    ``time_a``) kernel A's at batch 256; ``phases``: (kernel F's phase,
    kernel A's), each with a ``_forward`` line of its batch-256 sums.
    -> (rows, failures)."""
    rows, fails = [], []
    phase = dict(zip(("gconv_int8", "int8_matmul_requant"), phases))
    for b in batches or (BATCH, 1):
        for kernel, label, shape, dtype, leaf, kw in rx_calls(model, b):
            x = make_input(shape, dtype, kw["in_zp"], gen)
            if kernel == "gconv_int8":
                row, f = f_row(path, label, x, leaf, kw)
            else:
                row, f = kernel_a_row(path, label, x, leaf, kw, batch=b,
                                      timed=time_a and b == BATCH, plain_runs=5)
            rows.append(row)
            fails += f
            emit({"phase": phase[kernel], **row})
            del x
    for k, ph in phase.items():
        mine = [r for r in rows if r["kernel"] == k and r["batch"] == BATCH and "ms" in r]
        if not mine:
            continue
        sums = {f: sum(r[f] for r in mine) for f in ("ms", "plain_ms", "bytes", "ops", "bytes_ms")}
        bound = sum(max(r["bytes_ms"], r["ops_ms"]) for r in mine)
        line = {"phase": ph.replace("_shapes", "_forward"), "path": path, "kernel": k,
                "batch": BATCH, "calls": len(mine), **sums, "bound_ms": bound,
                "bound_share": bound / sums["ms"]}
        if k == "gconv_int8":
            design = sum(r["design_bound_ms"] for r in mine)
            old = [r["old_ms"] for r in mine]
            line.update({"padded_ops": sum(r["padded_ops"] for r in mine),
                         "design_bound_ms": design, "design_bound_share": design / sums["ms"],
                         "old_ms": None if None in old else sum(old),
                         "cudnn_fp16_ms": sum(r["cudnn_fp16_ms"] for r in mine)})
        else:
            libs = [r["library_ms"] for r in mine]
            line["library_ms"] = None if None in libs else sum(libs)
        emit(line)
    return rows, fails


def gconv_odd_shapes(gen: torch.Generator):
    """Kernel F at ``GC_ODD_SHAPES`` x zero points 0, 128, 255, and its
    requant at rint's ties (zero weights: y is the bias, set on and beside
    half-integer quotients), bit for bit. -> failures."""
    from inference_efficient_vision_models_tpu_torch.ops.gconv_int8 import pack_grouped_weight

    def leaf(c, groups, zero=False):
        wq = torch.randint(-127, 128, (3, 3, c // groups, c), generator=gen, device="cuda",
                           dtype=torch.int8)
        if zero:
            wq.zero_()
        return {"w": pack_grouped_weight(wq, groups),
                "w_scale": torch.rand(c, generator=gen, device="cuda") * 0.0009 + 0.0001,
                "bias": torch.randn(c, generator=gen, device="cuda"),
                "w_sum": wq.int().sum((0, 1, 2), dtype=torch.int32)}

    rows, fails = [], []
    for n, h, w, c, groups, stride in GC_ODD_SHAPES:
        lf = leaf(c, groups)
        for in_zp, out_zp in E_ZPS:
            kw = dict(stride=stride, in_scale=0.03, in_zp=in_zp, out_scale=0.02, out_zp=out_zp)
            row, f = f_row("odd", f"{h}x{w}x{c}/{groups} s{stride}",
                           int8_around((n, h, w, c), in_zp, gen), lf, kw, timed=False)
            rows.append(row)
            fails += f
    for c, groups in ((24, 8), (32, 8)):  # Cg 3 (bytes) and 4 (words)
        for s_out in (0.05, 0.0123):
            lf = leaf(c, groups, zero=True)
            lf["bias"] = residual_ties(s_out, c)
            kw = dict(stride=1, in_scale=0.03, in_zp=150, out_scale=s_out, out_zp=3)
            row, f = f_row("odd", f"ties s_out {s_out} C {c}/{groups}",
                           int8_around((2, 5, 6, c), 150, gen), lf, kw, timed=False)
            rows.append(row)
            fails += f
    emit({"phase": "gconv_odd_shapes", "checks": len(rows),
          "max_abs_err": max(r["max_abs_err"] for r in rows), "failed": fails})
    return fails


def gconv_quotient(path: str, model, gen_np: np.random.Generator):
    """``gconv_quotient``: kernel F's fp32 quotient (``quot_rn``) against the
    division on the card (``quotient_check``) over every float32 y >= 0 at
    each output scale s of ``model``'s grouped convs and at 16 scales drawn
    log-uniform over 2^-14 .. 2: bit for bit from y = 2^-90 to 512 s, the
    rounded integer (the epilogue's byte) from 0 to 512 s, the clip above.
    -> failures."""
    spec = model.spec
    served = sorted({float(model.q[f"layer{si + 1}"][str(bi)]["conv2"]["out_scale"])
                     for si, depth in enumerate(spec.depths) for bi in range(depth)})
    drawn = [float(np.float32(v)) for v in np.exp2(gen_np.uniform(-14, 1, 16))]
    t = time.perf_counter()
    res = quotient_check(served + drawn)
    wall = time.perf_counter() - t
    bad = {k: v for k, v in res.items() if v["quotient"] or v["rint"] or v["clip"]}
    emit({"phase": "gconv_quotient", "path": path, "served_scales": served,
          "drawn_scales": drawn, "values_per_scale": 0x7F800000, "wall_s": wall,
          "largest_differing_y": max(v["largest_differing_y"] for v in res.values()),
          "failures": {str(k): v for k, v in bad.items()}})
    return [f"gconv_quotient {path}: quot_rn differs from the division at s = {k}: {v}"
            for k, v in bad.items()]


def rx_artifact(dir_: str, spec, q: dict) -> str:
    """A stage-4 artifact directory of a static-int8 ResNeXt tree: what
    ``Predictor.from_artifact`` serves."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import qresnet
    from inference_efficient_vision_models_tpu_torch.core import artifacts

    os.makedirs(dir_, exist_ok=True)
    with open(os.path.join(dir_, "spec.json"), "w") as f:
        json.dump(spec.to_dict(), f)
    with open(os.path.join(dir_, "model_static_int8.msgpack"), "wb") as f:
        f.write(artifacts.tree_bytes(qresnet.serializable(q)))
    return dir_


def run_resnext(dev, gen: torch.Generator, gen_np: np.random.Generator):
    """The ResNeXt phases on a seeded full-width resnext26_32x4d at 224x224:
    ``convert_resnext`` (calibration, with its time, and conversion on the
    card against the JAX CPU record: non-activation leaves by sha256, scales
    within ``RX_CONVERT_LIMITS``), then the JAX model exactly (the card's
    integer leaves with the record's activation qparams) served through
    ``Predictor`` (three requests, launches per forward ``RX_PER_FORWARD``),
    the kernel path equal to the plain path, the 8 golden images' logits
    within ``RX_TAU`` of the JAX golden, forwards timed; ``gconv_shapes``:
    kernel F at the model's 8 grouped calls (batch 256 and 1), bit for bit,
    timed beside its bound, its design bound and its plain version, and at
    odd shapes and requant ties; ``rx_a_shapes``: kernel A at the model's 22
    calls (batch 256 timed, batch 1 checked). resnext50_32x4d's 16 grouped
    calls take the same 7 shapes (3, 4, 6 and 3 blocks a stage):
    ``gconv_resnext50`` sums the rows by its call counts. -> (rows,
    {path: launches})."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import qresnet

    with open(RX_CONVERT_GOLDEN) as f:
        record = json.load(f)
    spec, p, s, imgs, labels = effnet_convert_inputs("resnext26_32x4d", RX_CONVERT)
    q, _, t = port_convert_effnet(spec, p, s, imgs, labels, "cuda", RX_CONVERT)
    report = compare_conversion(qresnet.serializable(q), record, RX_CONVERT_LIMITS, _tap_of)
    emit({"phase": "convert_resnext", **_stage_card(dev), "model": spec.name,
          "images": len(imgs), "size": RX_CONVERT["size"], **t, "limits": RX_CONVERT_LIMITS,
          **report})
    if not report["ok"]:
        raise SmokeFailure(f"convert_resnext: outside the limits: {report}")

    qj = with_record_qparams(q, record)
    model = qresnet.from_jax_qmodel(spec.to_dict(), qj, "cuda")
    golden = np.load(RX_GOLDEN)
    x_np = rx_golden_images()
    with tempfile.TemporaryDirectory() as d:
        requests, served, forwards, launches, wall = serve(rx_artifact(d, spec, qj), x_np, gen_np)
        export_check("export_families", "resnext26_32x4d", d, "static_int8", x_np,
                     RX_PER_FORWARD)
    counts_ok = all(launches.get(k, 0) == RX_PER_FORWARD.get(k, 0) * forwards
                    for k in set(RX_PER_FORWARD) | set(launches))
    big = requests[-1]
    with torch.inference_mode():
        plain = np.concatenate([
            model(torch.from_numpy(big[i : i + BATCH]).cuda(), impl="plain").cpu().numpy()
            for i in range(0, len(big), BATCH)])
    equal_b = bool(np.array_equal(served[-1], plain))
    ref = golden["int8"]
    ok_c, err_c, atol_c = logits_close(served[1], ref, RX_TAU)
    fwd = {}
    with torch.inference_mode():
        for b in (1, BATCH):
            xb = torch.from_numpy(np.random.default_rng(2).integers(
                0, 256, (b, 224, 224, 3), dtype=np.uint8)).cuda()
            fwd[f"forward_ms_b{b}"] = time_ms(lambda: model(xb))
        fwd["profile_b256"] = profile_forward(model, xb)
    emit({"phase": "resnext26_int8_serve", **_stage_card(dev),
          "requests": [len(r) for r in requests], "forwards": forwards, "launches": launches,
          "expected_per_forward": RX_PER_FORWARD, "wall_s": wall,
          "kernel_equals_plain": equal_b, "images_vs_plain": len(big),
          "vs_jax_max_abs_err": err_c, "vs_jax_atol": atol_c, "tau": RX_TAU,
          "logit_scale": float(np.abs(ref).max()),
          "argmax_identical": bool((served[1].argmax(1) == ref.argmax(1)).all()), **fwd,
          "images_per_s_b256": BATCH / fwd[f"forward_ms_b{BATCH}"] * 1e3})
    if not (counts_ok and equal_b and ok_c):
        raise SmokeFailure(f"resnext26_int8_serve: launches {launches} in {forwards} forwards, "
                           f"kernel equals plain {equal_b}, vs JAX {ok_c} ({err_c})")
    del xb

    rows, fails = check_rx_calls(model, gen, "resnext26_32x4d", ("gconv_shapes", "rx_a_shapes"))
    fails += gconv_odd_shapes(gen)
    fails += gconv_quotient("resnext26_32x4d", model, gen_np)
    f_rows = [r for r in rows if r["kernel"] == "gconv_int8"]
    # resnext50_32x4d: its 16 grouped calls by the shapes resnext26's rows timed
    blocks50 = (3, 4, 6, 3)
    by_key = {}
    for r in f_rows:
        if r["batch"] == BATCH:
            by_key.setdefault((r["x"][1], r["n"], r["stride"]), r)
    n50 = {}
    for si, depth in enumerate(blocks50):
        h = 56 >> si
        c = 128 << si
        for bi in range(depth):
            key = (h, c, 1) if (si == 0 or bi > 0) else (2 * h, c, 2)
            n50[key] = n50.get(key, 0) + 1
    emit({"phase": "gconv_resnext50", "batch": BATCH, "calls": sum(n50.values()),
          **{f: sum(n50[k] * by_key[k][f] for k in n50)
             for f in ("ms", "plain_ms", "bytes", "bytes_ms", "design_bound_ms",
                       "cudnn_fp16_ms")},
          "old_ms": GC_OLD_RESNEXT50_MS})
    if fails:
        raise SmokeFailure("kernels F and A disagree with their plain versions at the ResNeXt "
                           "calls:\n" + "\n".join(fails))
    return rows, {"resnext26_32x4d": launches}


def run_rx_chain_int8(dev, gen: torch.Generator, quant_dir: str):
    """``rx_chain_int8``: the ResNeXt chain's static-INT8 resnext26 (pruned
    lanes) served through ``load_quantized`` -> ``Predictor.from_artifact``
    (one 32-image forward, launches counted: ``RX_PER_FORWARD``), its kernel
    path equal to its plain path bit for bit on 32 images, the forwards
    timed at batch 1 and 256 beside the chain's W8A16 and W4A16 forwards;
    then each kernel call at the chain model's shapes against its plain
    version (kernel F timed, aside in the kernels line) and kernel F's
    quotient at its output scales (``gconv_quotient``). -> (rows, {path:
    launches})."""
    from inference_efficient_vision_models_tpu_torch.serving import load_quantized

    pipe = "resnext26_pipeline"
    _, model, _, _ = load_quantized(quant_dir, "static_int8", device="cuda")
    hw = 2 * model.q["stem"]["e4"].shape[1]  # the size it was converted for
    imgs = chain_images(hw, 32)
    x = torch.from_numpy(imgs).cuda()
    pred = Predictor.from_artifact(quant_dir, "static_int8", device="cuda", batch_size=len(imgs))
    pred.warmup(imgs.shape[1:])
    _lib.reset_launch_counts()
    served = pred.predict_logits(imgs)
    torch.cuda.synchronize()
    launches = dict(_lib.launches)
    with torch.inference_mode():
        kern, plain = model(x).cpu().numpy(), model(x, impl="plain").cpu().numpy()
    equal = bool(np.array_equal(kern, plain)) and bool(np.array_equal(served, plain))
    fwd = {}
    for method in ("static_int8", "weight_only_int8", "weight_only_int4"):
        fn = model if method == "static_int8" else load_quantized(quant_dir, method,
                                                                  device="cuda")[2]
        with torch.inference_mode():
            for b in (1, BATCH):
                xb = torch.from_numpy(np.random.default_rng(2).integers(
                    0, 256, (b, hw, hw, 3), dtype=np.uint8)).cuda()
                fwd[f"{method}_forward_ms_b{b}"] = time_ms(lambda: fn(xb))
    spec = model.spec
    emit({"phase": "rx_chain_int8", **_stage_card(dev), "images": len(imgs),
          "inner_widths": spec.inner_widths, "cg": [blk[1] // spec.groups
                                                     for st in spec.inner_widths for blk in st],
          "launches_per_forward": launches, "expected_launches": RX_PER_FORWARD,
          "kernel_equals_plain": equal, "max_abs_err": float(np.abs(kern - plain).max()),
          "logit_scale": float(np.abs(plain).max()), **fwd,
          "images_per_s_b256": BATCH / fwd[f"static_int8_forward_ms_b{BATCH}"] * 1e3})
    if not (equal and launches == RX_PER_FORWARD):
        raise SmokeFailure(f"rx_chain_int8: kernel path equal to plain {equal}, launches "
                           f"{launches} (expected {RX_PER_FORWARD})")
    rows, fails = check_rx_calls(model, gen, pipe, ("rx_chain_f_shapes", "rx_chain_a_shapes"),
                                 time_a=False, batches=(BATCH,))
    fails += gconv_quotient(pipe, model, np.random.default_rng(15))
    if fails:
        raise SmokeFailure("kernels disagree at the ResNeXt chain's shapes:\n" + "\n".join(fails))
    return rows, {f"{pipe}_static_int8": launches}


def run_w4a16_serve(dev, quant_dirs: dict):
    """``w4a16_serve``: each chain's ``weight_only_int4`` artifact through
    ``Predictor`` (8 images) equal to its own ``apply_folded`` on the tree
    ``wo4.dequantize`` gives (bf16), the W8A16 forward's limit; its size in
    MB beside W8A16's (the stage-4 writer's ``size_mb``)."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import engine, wo4
    from inference_efficient_vision_models_tpu_torch.core import artifacts
    from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images
    from inference_efficient_vision_models_tpu_torch.metrics.profile import model_size_bytes
    from inference_efficient_vision_models_tpu_torch.models.registry import spec_from_dict

    out = []
    for name, d in quant_dirs.items():
        with open(os.path.join(d, "spec.json")) as f:
            spec = spec_from_dict(json.load(f))
        x8 = chain_images(spec.image_size if hasattr(spec, "patch") else 224, 8)
        pred = Predictor.from_artifact(d, "weight_only_int4", device="cuda", batch_size=len(x8))
        served = pred.predict_logits(x8)
        tree = artifacts.load_checkpoint_raw(d, "weight_only_int4")
        qmod = engine.quant_module(spec)
        folded = engine.place_folded(spec, wo4.dequantize(tree, torch.bfloat16), "cuda")
        with torch.inference_mode():
            own = qmod.apply_folded(spec, folded, normalize_images(
                torch.from_numpy(x8).cuda(), torch.bfloat16)).float().cpu().numpy()
        mb = {m: model_size_bytes(qmod.serializable(artifacts.load_checkpoint_raw(d, m))) / 1e6
              for m in ("weight_only_int4", "weight_only_int8")}
        rec = {"model": name, "images": len(x8), "equal": bool(np.array_equal(served, own)),
               "max_abs_err": float(np.abs(served - own).max()),
               "finite": bool(np.isfinite(served).all()), "w4a16_mb": mb["weight_only_int4"],
               "w8a16_mb": mb["weight_only_int8"]}
        out.append(rec)
    emit({"phase": "w4a16_serve", **_stage_card(dev), "models": out})
    if not all(r["equal"] and r["finite"] for r in out):
        raise SmokeFailure(f"w4a16_serve: a W4A16 artifact through Predictor is not its "
                           f"apply_folded: {out}")


def run_dynamic_fc_route(dev, gen: torch.Generator, quant_dirs: dict):
    """``dynamic_fc_route``: the CNN families' dynamic int8 fc on kernel A's
    dynamic route against the float64 formula it replaced, bit for bit: at
    the fc shapes of ResNet18 (K 512), EfficientNet-B0 (1280) and ResNet50
    (2048) on random non-negative features, and on each stage chain's
    dynamic artifact (its trunk's features, batch 256)."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import engine
    from inference_efficient_vision_models_tpu_torch.compress.quant.observers import (
        quantize_weight_per_channel)
    from inference_efficient_vision_models_tpu_torch.core import artifacts
    from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images
    from inference_efficient_vision_models_tpu_torch.models.registry import spec_from_dict

    cases = []
    for k in (512, 1280, 2048):
        feats = torch.randn((BATCH, k), generator=gen, device="cuda").abs() * 2
        w = np.random.default_rng(k).standard_normal((k, 6)).astype(np.float32) * 0.05
        w_q, w_scale = quantize_weight_per_channel(w, channel_axis=1)
        fcq = {"w_q": torch.from_numpy(w_q).cuda(), "w_scale": torch.from_numpy(w_scale).cuda(),
               "w_sum": torch.from_numpy(w_q.sum(axis=0, dtype=np.int32)).cuda(),
               "bias": torch.randn(6, generator=gen, device="cuda")}
        cases.append((f"random K {k}", feats, fcq))
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
    for name, d in quant_dirs.items():
        with open(os.path.join(d, "spec.json")) as f:
            spec = spec_from_dict(json.load(f))
        m = engine.place_folded(spec, artifacts.load_checkpoint_raw(d, "dynamic_int8"), "cuda")
        with torch.inference_mode():
            feats = engine.quant_module(spec).apply_folded(spec, m, normalize_images(x),
                                                           return_features=True)
        cases.append((f"{name} chain", feats, m["fc_q"]))
    out = []
    for name, feats, fcq in cases:
        with torch.inference_mode():
            got = engine._dynamic_fc(feats, {**fcq, "w": pack_weight(fcq["w_q"])})
            ref = dynamic_fc_float64(feats, fcq)
        out.append({"case": name, "k": int(feats.shape[1]), "equal": bool(torch.equal(got, ref)),
                    "max_abs_err": float((got - ref).abs().max())})
    emit({"phase": "dynamic_fc_route", **_stage_card(dev), "cases": out})
    if not all(c["equal"] for c in out):
        raise SmokeFailure(f"dynamic_fc_route: the kernel route is not the float64 formula: "
                           f"{out}")


# --------------------------------------------------------------------------
# stages 1-2: the float ResNet, a training step against the JAX golden, and
# the teacher and KD stage CLIs (cuDNN convs and cuBLAS GEMMs: no custom kernel)
# --------------------------------------------------------------------------


def train_step_batch(cfg=TRAIN_STEP):
    """The train-step golden's batch: uint8 images from a seed, labels 0..5."""
    rng = np.random.default_rng(cfg["image_seed"])
    b, size = cfg["batch"], cfg["size"]
    return (rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
            (np.arange(b) % 6).astype(np.int32), np.ones(b, np.float32))


def _flat_sorted(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_sorted(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float64)}


def train_step_metrics(role: str, loss, logits, grads, new_state, before, after, mu,
                       nu, lr: float = TRAIN_STEP["lr"]) -> dict:
    """What the train-step golden keeps of one step (trees in the JAX layout):
    the loss, the logits, each gradient leaf's L2 norm, each BatchNorm
    running statistic's sum beside its sum of magnitudes (the scale it is
    held to), each AdamW moment leaf's L2 norm, and the update
    ``(after - before) / lr`` of every leaf of at most ``UPDATE_LEAF_MAX``
    values, whole, beside the fp32 rounding of those parameters in units of
    lr; leaves in sorted-path order."""
    st = _flat_sorted(new_state)
    return {**tool_step_metrics(role, loss, logits, grads, before, after, lr),
            f"{role}_bn_names": np.array(list(st)),
            f"{role}_bn_sums": np.array([v.sum() for v in st.values()]),
            f"{role}_bn_abs_sums": np.array([np.abs(v).sum() for v in st.values()]),
            f"{role}_moment_names": np.array(list(_flat_sorted(mu))),
            f"{role}_mu_norms": np.array([np.linalg.norm(v) for v in _flat_sorted(mu).values()]),
            f"{role}_nu_norms": np.array([np.linalg.norm(v) for v in _flat_sorted(nu).values()])}


def port_train_step(weights: dict, batch, device, cfg=TRAIN_STEP) -> dict:
    """The port's fp32 CE step of the teacher, and KD step of the student
    against the (not updated) teacher in eval mode: the loss, logits,
    gradients and new BN state from ``*_loss_and_grads``, then the updated
    parameters and AdamW moments from one call of the trainer's own step
    (``make_train_step`` / ``make_kd_train_step``) on fresh copies of the
    weights. -> {role: the arguments of ``train_step_metrics`` after the
    role}, trees in the JAX layout."""
    from inference_efficient_vision_models_tpu_torch.models.registry import (
        make_spec, params_from_jax, params_to_jax)
    from inference_efficient_vision_models_tpu_torch.train.optim import adamw_init, tree_like
    from inference_efficient_vision_models_tpu_torch.train.steps import (
        ce_loss_and_grads, kd_loss_and_grads, make_kd_train_step, make_train_step)

    imgs, labels, mask = batch
    b = (torch.from_numpy(imgs).to(device), torch.from_numpy(labels.astype(np.int64)).to(device),
         torch.from_numpy(mask).to(device))
    specs = {r: make_spec(cfg[r], 6, image_size=cfg["size"]) for r in ("teacher", "student")}

    def model(r):
        return tuple(params_from_jax(specs[r], t, device) for t in weights[r])

    def to_jax(r, tree):
        return params_to_jax(specs[r], tree)

    kd = dict(alpha=cfg["alpha"], temperature=cfg["temperature"])
    step = {"teacher": make_train_step(specs["teacher"], learning_rate=cfg["lr"],
                                       compute_dtype="float32"),
            "student": make_kd_train_step(specs["student"], specs["teacher"],
                                          learning_rate=cfg["lr"],
                                          compute_dtype="float32", **kd)}
    teacher = model("teacher")
    out = {}
    for r in specs:
        p, s = model(r)
        if r == "teacher":
            loss, logits, ns, grads = ce_loss_and_grads(specs[r], p, s, b, compute_dtype="float32")
        else:
            loss, _, logits, ns, grads = kd_loss_and_grads(
                specs[r], specs["teacher"], p, s, *teacher, b, compute_dtype="float32", **kd)
        p1, s1 = model(r)
        extra = teacher if r == "student" else ()
        p1, _, opt, _ = step[r](p1, s1, adamw_init(p1), *extra, b)
        out[r] = (float(loss), logits.cpu().numpy(), to_jax(r, tree_like(p, grads)),
                  to_jax(r, ns), weights[r][0], to_jax(r, p1), to_jax(r, opt.mu),
                  to_jax(r, opt.nu))
    return out


def _rel(mine, ref, floor: float = 0.0) -> float:
    """Largest |mine - ref| / |ref|, each |ref| raised to at least ``floor``
    times the largest |ref| (0: plain relative deviations)."""
    scale = np.maximum(np.abs(ref), max(floor * float(np.abs(ref).max()), 1e-30))
    return float((np.abs(mine - ref) / scale).max())


def compare_train_step(role: str, got, golden, limits=None, cfg=TRAIN_STEP) -> dict:
    """One role's step against the golden: the loss's relative deviation, the
    logits' over the logit scale, the largest relative deviation of a
    gradient leaf's norm, of a BN statistic's sum (over its sum of
    magnitudes) and of a moment leaf's norm (each norm raised to at least
    ``cfg["norm_floor"]`` of the largest, squared for the second moment),
    and the largest deviation of a
    kept leaf's update in units of lr; with ``limits`` also whether each
    holds (the update's limit plus the parameters' rounding)."""
    mine = train_step_metrics(role, *got, lr=cfg["lr"])
    fl = cfg.get("norm_floor", 0.0)
    for k in ("grad_names", "bn_names", "moment_names", "update_names"):
        if list(mine[f"{role}_{k}"]) != list(golden[f"{role}_{k}"]):
            raise SmokeFailure(f"{role}: the {k} differ from the golden's")
    dev = {
        "loss_rel": _rel(mine[f"{role}_loss"], golden[f"{role}_loss"]),
        "logits_over_scale": float(np.abs(mine[f"{role}_logits"] - golden[f"{role}_logits"]).max()
                                   / np.abs(golden[f"{role}_logits"]).max()),
        "grad_norm_rel": _rel(mine[f"{role}_grad_norms"], golden[f"{role}_grad_norms"], fl),
        "bn_sum_over_abs_sum": float((np.abs(mine[f"{role}_bn_sums"] - golden[f"{role}_bn_sums"])
                                      / golden[f"{role}_bn_abs_sums"]).max(initial=0.0)),
        "mu_norm_rel": _rel(mine[f"{role}_mu_norms"], golden[f"{role}_mu_norms"], fl),
        "nu_norm_rel": _rel(mine[f"{role}_nu_norms"], golden[f"{role}_nu_norms"], fl * fl),
        "update_dev_over_lr": float(np.abs(mine[f"{role}_update_over_lr"]
                                           - golden[f"{role}_update_over_lr"]).max()),
    }
    if limits is not None:
        slack = {"update_dev_over_lr": float(golden[f"{role}_update_slack_over_lr"])}
        dev["ok"] = all(dev[k] <= limits[k] + slack.get(k, 0.0) for k in limits)
    return dev


def _stage_card(dev) -> dict:
    return {"card": dev["nvidia_smi"], "power_limit": dev["power_limit"]}


def r2_data():
    """The r2 data the port rebuilds from the artifact's data protocol:
    (the first 256 images of fold 0's train split, the held-out split), each
    (uint8 images, labels)."""
    from inference_efficient_vision_models_tpu_torch.core.config import TeacherConfig
    from inference_efficient_vision_models_tpu_torch.data.neudet import load_dataset
    from inference_efficient_vision_models_tpu_torch.data.splits import create_fold_split_idx

    with open(os.path.join(ARTIFACT, "provenance.json")) as f:
        data = json.load(f)["data"]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TeacherConfig(artifacts_root=tmp, **{
            k: tuple(v) if k == "image_size" else v for k, v in data.items()})
        d = load_dataset(cfg)
    imgs, labels = d["train"]
    tr = np.asarray(create_fold_split_idx(data["num_folds"], labels, data["seed"])[0]["train"])
    return (imgs[tr][:256], labels[tr][:256]), d["test"]


def run_float_r2_eval(dev, test):
    """The committed pruned fp32 ResNet18 through ``load_stage_model`` on the
    r2 held-out split ``test``: fp32 (TF32 off) and bf16 logits against the
    JAX goldens, the forward times, and the int8 path's argmax agreement
    with fp32."""
    import hashlib

    from inference_efficient_vision_models_tpu_torch.cli.teacher import load_stage_model
    from inference_efficient_vision_models_tpu_torch.compress.quant.qresnet import (
        load_static_int8)
    from inference_efficient_vision_models_tpu_torch.data.pipeline import normalize_images
    from inference_efficient_vision_models_tpu_torch.models import resnet

    imgs, labels = test
    sha = hashlib.sha256(np.ascontiguousarray(imgs).tobytes()
                         + np.asarray(labels, np.int32).tobytes()).hexdigest()
    with open(SPLIT_SHA) as f:
        if sha != f.read().split()[0]:
            raise SmokeFailure(f"float_r2_eval: the rebuilt r2 split hashes to {sha}")
    golden = np.load(FLOAT_GOLDEN)
    spec, params, state = load_stage_model(PRUNED, "best", "cuda")
    x = torch.from_numpy(imgs).cuda()

    def forward(dtype):
        return lambda u8: resnet.apply(spec, params, state, normalize_images(u8, dtype),
                                       compute_dtype=dtype)[0]

    out = {"phase": "float_r2_eval", **_stage_card(dev), "images": len(labels),
           "split_sha256": sha, "batch": BATCH}
    logits = {}
    with torch.no_grad():
        for key, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            fwd = forward(dtype)
            got = torch.cat([fwd(x[i : i + BATCH]) for i in range(0, len(x), BATCH)]).cpu().numpy()
            logits[key] = got
            ok, err, atol = logits_close(got, golden[key], R2_TAU[key])
            acc = float((got.argmax(1) == labels).mean())
            out[key] = {"max_abs_err": err, "atol": atol, "tau": R2_TAU[key],
                        "max_abs_err_over_scale": err / float(np.abs(golden[key]).max()),
                        "argmax_identical": bool((got.argmax(1) == golden[key].argmax(1)).all()),
                        "acc": acc, "golden_acc": float(golden[f"{key}_acc"]),
                        "ms_b256": time_ms(lambda: fwd(x[:BATCH]))}
            if not ok or (key == "fp32" and (acc != float(golden["fp32_acc"])
                                             or not out[key]["argmax_identical"])):
                emit(out)
                raise SmokeFailure(f"float_r2_eval {key}: {out[key]}")
            emit({"phase": "float_r2_profile_b256", **_stage_card(dev), "dtype": key,
                  **profile_forward(fwd, x[:BATCH], 2)})
        int8 = load_static_int8(ARTIFACT, device="cuda")
        q = torch.cat([int8(x[i : i + BATCH]) for i in range(0, len(x), BATCH)]).cpu().numpy()
    out["int8_vs_fp32_argmax_agreement"] = float((q.argmax(1) == logits["fp32"].argmax(1)).mean())
    out["int8_acc"] = float((q.argmax(1) == labels).mean())
    out["fp32_images_per_s"] = BATCH / out["fp32"]["ms_b256"] * 1e3
    out["bf16_images_per_s"] = BATCH / out["bf16"]["ms_b256"] * 1e3
    emit(out)


def step_weights(cfg) -> dict:
    """The train-step golden's seeded weights of each role (JAX layout)."""
    from inference_efficient_vision_models_tpu_torch.models.registry import make_spec

    return {r: params_from_seed(make_spec(cfg[r], 6, image_size=cfg["size"]),
                                cfg.get(f"{r}_seed", cfg["seed"]))
            for r in ("teacher", "student")}


def run_train_step_golden(dev, cfg=TRAIN_STEP, path=TRAIN_GOLDEN, limits=TRAIN_LIMITS,
                          phase="train_step_golden"):
    """One fp32 CE step of the teacher and one KD step of the student against
    it (TF32 off), from the seeded weights, against the JAX package's golden:
    ResNet50 and ResNet18 at batch 8, 224x224 (``TRAIN_STEP``), or
    EfficientNet-B0 for both roles at 64x64 (``EFF_TRAIN_STEP``)."""
    golden = np.load(path)
    weights = step_weights(cfg)
    for role in ("teacher", "student"):
        if not (np.array_equal(leaf_sums(weights[role][0]), golden[f"{role}_param_sums"])
                and np.array_equal(leaf_sums(weights[role][1]), golden[f"{role}_state_sums"])):
            raise SmokeFailure(f"{phase}: the seeded weights are no longer the golden's")
    got = port_train_step(weights, train_step_batch(cfg), "cuda", cfg)
    fails = []
    for role in ("teacher", "student"):
        d = compare_train_step(role, got[role], golden, limits, cfg)
        emit({"phase": phase, **_stage_card(dev), "role": role, "model": cfg[role],
              "batch": cfg["batch"], "size": cfg["size"], "loss": got[role][0],
              "limits": limits, **d})
        if not d["ok"]:
            fails.append(role)
    if fails:
        raise SmokeFailure(f"{phase}: {fails} outside the limits")


# --------------------------------------------------------------------------
# the stage-4 accuracy tools: QAT, weight-only QAT, AdaRound
# --------------------------------------------------------------------------

# One QAT step, one W4 QAT step and four AdaRound iterations of a seeded
# narrow ResNet (one basic block a stage, widths 16/32/48/64) at batch 8,
# 64x64, against the JAX package run op by op on the CPU
# (``JAX_PLATFORMS=cpu python tests/test_torch_port_accuracy_tools.py``
# rewrites the golden and prints the port's CPU deviation). Both sides take
# the golden's observers (the JAX calibration of the 16 images).
TOOLS_STEP = dict(spec=dict(name="resnet_narrow_tools", block="basic", depths=[1, 1, 1, 1],
                            stage_widths=[16, 32, 48, 64],
                            inner_widths=[[[16]], [[32]], [[48]], [[64]]], stem_width=16,
                            num_classes=6, groups=1),
                  seed=0, image_seed=4, batch=8, size=64, calib=16, qat_lr=1e-5,
                  ada_iters=4, ada_lr=1e-2)
TOOLS_GOLDEN = os.path.join(TESTDATA, "accuracy_tools_jax.npz")
# Per role, twice the CPU port's worst deviation from the golden over torch's
# two CPU conv implementations (oneDNN and the native one: two summation
# orders) and 1 to 8 threads, set before the card's first reading. The QAT
# role's are wide: a value within fp32 rounding of a fake-quant rounding edge
# moves one quantum (the CPU: one at l1b0o, 4e-5 of a quantum from the edge),
# and the layers after it carry the flip (83 flipped values by the fc); the
# W4 role has no activation grid, so summation order alone. The updates
# within 2 lr (one sign flip of a near-zero gradient) beyond the parameters'
# fp32 rounding; AdaRound's learned integers that differ from JAX's (an
# activation flip moves the reconstruction's gradient).
TOOLS_LIMITS = {"qat": {"loss_rel": 4.8e-4, "logits_over_scale": 0.0101, "grad_norm_rel": 0.015,
                        "update_dev_over_lr": 2.0},
                "w4": {"loss_rel": 2.2e-7, "logits_over_scale": 1.05e-6,
                       "grad_norm_rel": 7.9e-7, "update_dev_over_lr": 2.0},
                "ada_mismatch_share": 0.0025}


def tools_inputs(cfg=TOOLS_STEP):
    """(spec, the folded seeded model (JAX layout, numpy), the train batch
    (its ``batch`` first images and labels), the calibration split)."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import qresnet
    from inference_efficient_vision_models_tpu_torch.models.registry import spec_from_dict

    spec = spec_from_dict(cfg["spec"])
    folded = qresnet.fold(spec, *params_from_seed(spec, cfg["seed"]))
    rng = np.random.default_rng(cfg["image_seed"])
    imgs = rng.integers(0, 256, (cfg["calib"], cfg["size"], cfg["size"], 3), dtype=np.uint8)
    labels = (np.arange(cfg["calib"]) % 6).astype(np.int32)
    return spec, folded, (imgs[: cfg["batch"]], labels[: cfg["batch"]]), (imgs, labels)


def golden_observers(golden) -> dict:
    from inference_efficient_vision_models_tpu_torch.compress.quant.observers import (
        ObserverState)

    return {str(n): ObserverState(float(lo), float(hi), True)
            for n, lo, hi in zip(golden["obs_names"], golden["obs_min"], golden["obs_max"])}


def tool_step_metrics(role: str, loss, logits, grads, before, after, lr: float) -> dict:
    """What a golden keeps of one step (trees in the JAX layout): the loss, the
    logits, each gradient leaf's L2 norm, and the update ``(after - before) /
    lr`` of every leaf of at most ``UPDATE_LEAF_MAX`` values, beside the
    parameters' fp32 rounding in units of lr; leaves in sorted-path order."""
    g = _flat_sorted(grads)
    p0, p1 = _flat_sorted(before), _flat_sorted(after)
    kept = [k for k in p0 if p0[k].size <= UPDATE_LEAF_MAX]
    return {f"{role}_loss": np.float64(loss), f"{role}_logits": np.asarray(logits, np.float32),
            f"{role}_grad_names": np.array(list(g)),
            f"{role}_grad_norms": np.array([np.linalg.norm(v) for v in g.values()]),
            f"{role}_update_names": np.array(kept),
            f"{role}_update_slack_over_lr": np.float64(2 * np.spacing(np.float32(
                max(np.abs(p0[k]).max() for k in kept) + 4 * lr)) / lr),
            f"{role}_update_over_lr": np.concatenate(
                [((p1[k] - p0[k]) / lr).ravel() for k in kept]).astype(np.float32)}


def _w_leaf(tree, key: str):
    for k in key.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def learned_ints(before: dict, hardened: dict, keys) -> np.ndarray:
    """The integers a hardened tree holds, leaf by leaf in ``keys``' order:
    round(hardened / s) on the scale s of the leaf before hardening (int16:
    a channel's kept argmax element may round to 128)."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.adaround import (
        _channel_scale_np)

    out = []
    for k in keys:
        w0 = _w_leaf(before, k)
        out.append(np.round(_w_leaf(hardened, k) / _channel_scale_np(w0, w0.ndim - 1)).ravel())
    return np.concatenate(out).astype(np.int16)


def adaround_contract(before: dict, hardened: dict, rounding: dict, qmodel: dict) -> dict:
    """AdaRound's conversion contract, leaf by leaf: the conversion of the
    hardened tree has the learned integers as its ``w_q`` wherever hardening
    wrote the s-grid, and each channel's first argmax-|w| element keeps its
    value (so the conversion's scale is AdaRound's). -> {"leaves",
    "int_equal", "argmax_kept", "scale_equal", "moved_from_nearest"}."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.adaround import (
        _argmax_mask, _channel_scale_np)
    from inference_efficient_vision_models_tpu_torch.compress.quant.observers import (
        quantize_weight_per_channel)

    out = {"leaves": len(rounding), "int_equal": True, "argmax_kept": True, "scale_equal": True,
           "moved_from_nearest": 0}
    for key, q in rounding.items():
        w0, wh = _w_leaf(before, key), _w_leaf(hardened, key)
        node = qmodel
        for k in key.split("/")[:-1]:
            node = node[k]
        ax = w0.ndim - 1
        keep = _argmax_mask(w0, ax)
        out["int_equal"] &= bool(np.array_equal(np.asarray(node["w_q"])[~keep], q[~keep]))
        out["argmax_kept"] &= bool(np.array_equal(wh[keep], w0[keep]))
        out["scale_equal"] &= bool(np.array_equal(
            np.asarray(node["w_scale"]).ravel(), _channel_scale_np(w0, ax).ravel()))
        near, _ = quantize_weight_per_channel(w0, channel_axis=ax)
        out["moved_from_nearest"] += int((near[~keep] != q[~keep]).sum())
    return out


def port_tool_steps(device, golden, cfg=TOOLS_STEP) -> dict:
    """The port's QAT step, W4 QAT step (``bits=4``) and AdaRound iterations
    on ``device`` with the golden's observers -> the golden's keys (the
    metrics of each role, AdaRound's learned integers by leaf in sorted order)
    and ``contract`` (``adaround_contract`` of its own output)."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import qat, qresnet
    from inference_efficient_vision_models_tpu_torch.compress.quant.adaround import (
        adaround_refine)
    from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches
    from inference_efficient_vision_models_tpu_torch.train.optim import tree_like

    from inference_efficient_vision_models_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    spec, folded, train, calib = tools_inputs(cfg)
    obs = golden_observers(golden)
    b = cfg["batch"]
    batch = next(iter(Batches(*train, b, device, shuffle=True, seed=0)))
    out = {}
    roles = {"qat": (qat.fq_weights, qat.act_hook(obs, device),
                     lambda: qat.qat_finetune(spec, qresnet, folded, obs, train,
                                              lr=cfg["qat_lr"], batch_size=b, device=device)),
             "w4": (qat.fq_weights_w4, None,
                    lambda: qat.w4_qat_finetune(spec, qresnet, folded, train, lr=cfg["qat_lr"],
                                                batch_size=b, bits=4, device=device))}
    for role, (fq, hook, finetune) in roles.items():
        params = qat.tensor_tree(folded, device)
        loss, logits, grads = qat.fq_loss_and_grads(spec, qresnet, params, batch, fq, hook)
        grads = qat.numpy_tree(tree_like(params, grads))
        out.update(tool_step_metrics(role, loss.item(), logits.cpu().numpy(), grads, folded,
                                     finetune(), cfg["qat_lr"]))
    hardened, rounding = adaround_refine(spec, qresnet, folded, obs, calib,
                                         iters=cfg["ada_iters"], lr=cfg["ada_lr"], batch_size=b,
                                         device=device, return_rounding=True)
    names = sorted(rounding)
    out["ada_names"] = np.array(names)
    out["ada_q"] = learned_ints(folded, hardened, names)
    qmodel = qresnet.convert_static_int8(spec, hardened, obs, image_size=(cfg["size"],) * 2)
    out["contract"] = adaround_contract(folded, hardened, rounding, qmodel)
    return out


def compare_tool_steps(got: dict, golden, limits=None) -> dict:
    """Each role's deviation from the golden (``compare_train_step``'s
    measures; the updates' beyond the parameters' fp32 rounding) and
    AdaRound's share of learned integers that differ; with ``limits`` also
    whether each holds (``ok``)."""
    dev = {}
    for role in ("qat", "w4"):
        for k in ("grad_names", "update_names"):
            if list(got[f"{role}_{k}"]) != list(golden[f"{role}_{k}"]):
                raise SmokeFailure(f"{role}: the {k} differ from the golden's")
        dev[role] = {
            "loss_rel": _rel(got[f"{role}_loss"], golden[f"{role}_loss"]),
            "logits_over_scale": float(np.abs(got[f"{role}_logits"] - golden[f"{role}_logits"])
                                       .max() / np.abs(golden[f"{role}_logits"]).max()),
            "grad_norm_rel": _rel(got[f"{role}_grad_norms"], golden[f"{role}_grad_norms"]),
            "update_dev_over_lr": float(np.abs(got[f"{role}_update_over_lr"]
                                               - golden[f"{role}_update_over_lr"]).max())
                                  - float(golden[f"{role}_update_slack_over_lr"])}
    if list(got["ada_names"]) != list(golden["ada_names"]):
        raise SmokeFailure("adaround: the leaves differ from the golden's")
    dev["ada_mismatch_share"] = float(np.count_nonzero(got["ada_q"] != golden["ada_q"])
                                      / golden["ada_q"].size)
    if limits is not None:
        dev["ok"] = dev["ada_mismatch_share"] <= limits["ada_mismatch_share"] and all(
            dev[r][k] <= lim for r in ("qat", "w4") for k, lim in limits[r].items())
    return dev


def run_qat_step_golden(dev):
    """``qat_step_golden``: the port's QAT, W4 QAT and AdaRound on the card
    (TF32 off) against the JAX golden (``TOOLS_STEP``), within
    ``TOOLS_LIMITS``; AdaRound's contract on its own output exact."""
    golden = np.load(TOOLS_GOLDEN)
    spec, folded, _, _ = tools_inputs()
    if not np.array_equal(leaf_sums(folded), golden["folded_sums"]):
        raise SmokeFailure("qat_step_golden: the seeded model is no longer the golden's")
    got = port_tool_steps("cuda", golden)
    d = compare_tool_steps(got, golden, TOOLS_LIMITS)
    contract = got["contract"]
    emit({"phase": "qat_step_golden", **_stage_card(dev), "model": TOOLS_STEP["spec"]["name"],
          "batch": TOOLS_STEP["batch"], "size": TOOLS_STEP["size"], "limits": TOOLS_LIMITS,
          **d, "contract": contract})
    if not d["ok"]:
        raise SmokeFailure(f"qat_step_golden: outside the limits: {d}")
    if not (contract["int_equal"] and contract["argmax_kept"] and contract["scale_equal"]):
        raise SmokeFailure(f"qat_step_golden: AdaRound's contract broke: {contract}")


def run_convert_r2(dev, calib, test):
    """Stage 4 on the committed pruned r2 checkpoint, on the card: fold,
    calibrate (minmax, ``calib``: the first 256 images of fold 0's train
    split, batch 32) and convert, held to the JAX package's CPU conversion
    (``CONVERT_GOLDEN``, ``CONVERT_LIMITS``); then the fresh artifact, written
    and read back as stage 4 writes it, and the committed JAX artifact served
    through ``Predictor`` on the held-out split ``test``."""
    from inference_efficient_vision_models_tpu_torch.cli.quantize import _save_qmodel
    from inference_efficient_vision_models_tpu_torch.cli.teacher import load_stage_model
    from inference_efficient_vision_models_tpu_torch.compress.quant import qresnet
    from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches
    from inference_efficient_vision_models_tpu_torch.models.registry import params_to_jax

    with open(CONVERT_GOLDEN) as f:
        golden = json.load(f)
    spec, params, state = load_stage_model(PRUNED, "best", "cuda")
    t0 = time.perf_counter()
    folded = qresnet.fold(spec, params_to_jax(spec, params), params_to_jax(spec, state))
    t_fold = time.perf_counter() - t0
    t0 = time.perf_counter()
    obs = qresnet.calibrate(spec, qresnet.place_folded(folded, "cuda"),
                            Batches(*calib, 32, "cuda"), max_images=256)
    torch.cuda.synchronize()
    t_calib = time.perf_counter() - t0
    t0 = time.perf_counter()
    qmodel = qresnet.convert_static_int8(spec, folded, obs, image_size=(224, 224))
    t_convert = time.perf_counter() - t0
    report = compare_conversion(qresnet.serializable(qmodel), golden)
    out = {"phase": "convert_r2", **_stage_card(dev), "fold_s": t_fold, "calibrate_s": t_calib,
           "convert_s": t_convert, "calibration_images": 256, "batch": 32, **report}
    if not report["ok"]:
        emit(out)
        raise SmokeFailure(f"convert_r2: the port's conversion is outside the limits: {report}")
    imgs, labels = test
    logits = {}
    with tempfile.TemporaryDirectory() as tmp:
        _save_qmodel(tmp, "static_int8", qmodel, spec)
        for name, where in (("port", tmp), ("jax", ARTIFACT)):
            pred = Predictor.from_artifact(where, "static_int8", device="cuda", batch_size=BATCH)
            logits[name] = pred.predict_logits(imgs)
            if logits[name].shape != (len(labels), spec.num_classes) or \
                    not np.isfinite(logits[name]).all():
                raise SmokeFailure(f"convert_r2: {name} logits {logits[name].shape}")
            out[f"{name}_acc"] = float((logits[name].argmax(1) == labels).mean())
    out["images"] = len(labels)
    out["argmax_agreement"] = float((logits["port"].argmax(1) == logits["jax"].argmax(1)).mean())
    out["max_abs_logit_diff"] = float(np.abs(logits["port"] - logits["jax"]).max())
    emit(out)


def flat_state_npz(tree) -> dict:
    """A nested dict of arrays -> {"a/b": array} (npz keys)."""
    return {k.lstrip("/"): v for k, v in flat_raw(tree).items()}


def nested_from_npz(npz) -> dict:
    out: dict = {}
    for key in npz.files:
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(npz[key])
    return out


def effnet_convert_inputs(name="efficientnet_b0", cfg=EFF_CONVERT):
    """The spec of ``name`` (an MBConv network: EfficientNet-B0 by default,
    or MobileNetV2 with ``MBV2_CONVERT``), its seeded (params, BN state) and
    ``cfg``'s surrogate images."""
    from inference_efficient_vision_models_tpu_torch.data.synthetic import make_synthetic_neudet
    from inference_efficient_vision_models_tpu_torch.models.registry import make_spec

    spec = make_spec(name, 6)
    p, s = params_from_seed(spec, cfg["seed"])
    imgs, labels = make_synthetic_neudet(cfg["per_class"], image_size=cfg["size"],
                                         seed=cfg["image_seed"])
    return spec, p, s, imgs, labels


def port_recal_effnet(spec, p, s, imgs, device, cfg=EFF_CONVERT):
    """The port's BN recalibration of ``cfg`` -> the JAX-layout state."""
    from inference_efficient_vision_models_tpu_torch.models.registry import (
        params_from_jax, params_to_jax)
    from inference_efficient_vision_models_tpu_torch.train.bn_recal import recalibrate_bn

    b = cfg["batch"]
    st = recalibrate_bn(spec, params_from_jax(spec, p, device), params_from_jax(spec, s, device),
                        imgs, batch_size=b, num_batches=len(imgs) // b)
    return params_to_jax(spec, st)


def port_convert_effnet(spec, p, s, imgs, labels, device, cfg=EFF_CONVERT):
    """fold -> calibrate (minmax, every image, on ``device``) -> convert, by
    the spec's quantization module (an MBConv network's or the ViT's) ->
    (the converted tree, observers, {fold_s, calibrate_s, convert_s})."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import engine
    from inference_efficient_vision_models_tpu_torch.compress.quant.engine import quant_module
    from inference_efficient_vision_models_tpu_torch.data.pipeline import Batches

    def place_folded(tree, dev):
        return engine.place_folded(spec, tree, dev)

    qmod = quant_module(spec)
    t = {}
    t0 = time.perf_counter()
    folded = qmod.fold(spec, p, s)
    t["fold_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    obs = qmod.calibrate(spec, place_folded(folded, device),
                         Batches(imgs, labels, cfg["batch"], device), max_images=len(imgs))
    t["calibrate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = qmod.convert_static_int8(spec, folded, obs, image_size=(cfg["size"], cfg["size"]))
    t["convert_s"] = time.perf_counter() - t0
    return q, obs, t


def dynamic_fc_float64(feats: torch.Tensor, fcq: dict) -> torch.Tensor:
    """The CNN families' dynamic int8 fc as the port formed it before kernel
    A's dynamic route served it (the int32 sum as a float64 matmul): the
    reference ``dynamic_fc_route`` and the CPU tests hold the route to, bit
    for bit."""
    dev = feats.device
    zero = torch.zeros((), device=dev)
    lo = torch.minimum(feats.min(), zero)
    hi = torch.maximum(feats.max(), zero)
    scale = torch.clamp_min((hi - lo) / torch.full((), 255.0, device=dev), 1.2e-7)
    zp = torch.clamp(torch.round(-lo / scale), 0, 255)
    x_s = torch.clamp(torch.round(feats / scale) + zp, 0, 255) - 128
    acc = x_s.double() @ fcq["w_q"].double()
    acc = acc - (zp.double() - 128) * fcq["w_sum"].double()
    return acc.float() * (scale * fcq["w_scale"]) + fcq["bias"]


def vit_convert_inputs(cfg=VIT_CONVERT):
    """The ViT-Tiny/16 spec at ``cfg``'s size, its seeded params, an empty
    state and ``cfg``'s surrogate images."""
    from inference_efficient_vision_models_tpu_torch.data.synthetic import make_synthetic_neudet
    from inference_efficient_vision_models_tpu_torch.models.vit import vit_spec

    spec = vit_spec("vit_tiny_patch16_224", 6, image_size=cfg["size"])
    imgs, labels = make_synthetic_neudet(cfg["per_class"], image_size=cfg["size"],
                                         seed=cfg["image_seed"])
    return spec, vit_params_from_seed(spec, cfg["seed"]), {}, imgs, labels


def vit_dyn_images() -> np.ndarray:
    """The 8 seeded 224x224 uint8 images of ``VIT_DYN_GOLDEN``."""
    return np.random.default_rng(VIT_DYN_IMAGES["seed"]).integers(
        0, 256, (VIT_DYN_IMAGES["n"], 224, 224, 3), dtype=np.uint8)


def mbv2_golden_images() -> np.ndarray:
    """The 8 seeded 224x224 uint8 images of ``MBV2_GOLDEN``."""
    return np.random.default_rng(MBV2_GOLDEN_IMAGES["seed"]).integers(
        0, 256, (MBV2_GOLDEN_IMAGES["n"], 224, 224, 3), dtype=np.uint8)


def rx_golden_images() -> np.ndarray:
    """The 8 seeded 224x224 uint8 images of ``RX_GOLDEN``."""
    return np.random.default_rng(RX_GOLDEN_IMAGES["seed"]).integers(
        0, 256, (RX_GOLDEN_IMAGES["n"], 224, 224, 3), dtype=np.uint8)


def with_record_qparams(q: dict, rec: dict) -> dict:
    """A converted tree (numpy) with every activation qparam set to the
    conversion record's value (``rec["qparams"]``, by path): when the
    record's other leaves equal the tree's (sha256), this is the recorded
    model exactly."""
    out = _copy_tree(q)
    for path, v in rec["qparams"].items():
        *keys, leaf = path.strip("/").split("/")
        node = out
        for k in keys:
            node = node[k]
        node[leaf] = np.float32(v) if isinstance(v, float) else np.int32(v)
    return out


def _copy_tree(tree):
    return {k: _copy_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def state_deviation(got: dict, ref: dict) -> float:
    """Largest |got - ref| of a BN statistic over its leaf's largest |ref| (at least 1)."""
    g, r = flat_raw(got), flat_raw(ref)
    if g.keys() != r.keys():
        raise SmokeFailure("the recalibrated state's leaves differ from the record's")
    return max(float(np.abs(g[k] - r[k]).max()) / max(float(np.abs(r[k]).max()), 1.0)
               for k in r)


def run_convert_effnet(dev):
    """``EFF_CONVERT`` on the card: the port's BN recalibration held to the
    JAX package's (``recal_rtol``), then fold, calibration and conversion
    from the recorded statistics held to the JAX CPU conversion record:
    every non-activation leaf equal by sha256, every scale within
    ``scale_rtol``."""
    from inference_efficient_vision_models_tpu_torch.compress.quant import qeffnet

    with open(EFF_CONVERT_GOLDEN) as f:
        golden = json.load(f)
    spec, p, s, imgs, labels = effnet_convert_inputs()
    ref_state = nested_from_npz(np.load(EFF_CONVERT_STATE))
    t0 = time.perf_counter()
    recal = port_recal_effnet(spec, p, s, imgs, "cuda")
    torch.cuda.synchronize()
    recal_s = time.perf_counter() - t0
    recal_dev = state_deviation(recal, ref_state)
    q, _, t = port_convert_effnet(spec, p, ref_state, imgs, labels, "cuda")
    report = compare_conversion(qeffnet.serializable(q), golden, EFF_CONVERT_LIMITS, _eff_tap_of)
    ok = report["ok"] and recal_dev <= EFF_CONVERT_LIMITS["recal_rtol"]
    emit({"phase": "convert_effnet", **_stage_card(dev), "images": len(imgs),
          "size": EFF_CONVERT["size"], "recal_s": recal_s, "recal_dev": recal_dev, **t,
          "limits": EFF_CONVERT_LIMITS, **report, "ok": ok})
    if not ok:
        raise SmokeFailure(f"convert_effnet: outside the limits: recal {recal_dev}, {report}")


def bf16_train_steps():
    """The bf16 teacher step (ResNet50, batch 64) and KD step (ResNet18 from
    it, batch 32) as the stage CLIs run them (the train loop's steps, seeded
    weights, random images), and the teacher step with ``augment=True`` (the
    default options), each after 3 warm-up steps: [(name, step, batch)]."""
    from types import SimpleNamespace

    from inference_efficient_vision_models_tpu_torch.data.augment import make_augment_fn
    from inference_efficient_vision_models_tpu_torch.models.registry import (
        make_spec, params_from_jax)
    from inference_efficient_vision_models_tpu_torch.train.optim import adamw_init
    from inference_efficient_vision_models_tpu_torch.train.steps import (
        make_kd_train_step, make_train_step)

    specs = {r: make_spec(TRAIN_STEP[r], 6) for r in ("teacher", "student")}
    m = {}
    for r, spec in specs.items():
        p, s = (params_from_jax(spec, t, "cuda") for t in resnet_params_from_seed(spec, 0))
        m[r] = [p, s, adamw_init(p)]
    rng = np.random.default_rng(3)

    def batch(b):
        return (torch.from_numpy(rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8)).cuda(),
                torch.from_numpy(rng.integers(0, 6, b)).cuda(), torch.ones(b, device="cuda"))

    t_step = make_train_step(specs["teacher"], learning_rate=1e-4, compute_dtype="bfloat16")
    k_step = make_kd_train_step(specs["student"], specs["teacher"], alpha=TRAIN_STEP["alpha"],
                                temperature=TRAIN_STEP["temperature"], learning_rate=1e-4,
                                compute_dtype="bfloat16")

    t_aug_step = make_train_step(specs["teacher"], learning_rate=1e-4, compute_dtype="bfloat16",
                                 augment_fn=make_augment_fn(SimpleNamespace(augment=True)))

    def teacher_step(b):
        m["teacher"][:] = t_step(*m["teacher"], b)[:3]

    def teacher_augment_step(b):
        m["teacher"][:] = t_aug_step(*m["teacher"], b)[:3]

    def kd_step(b):
        m["student"][:] = k_step(*m["student"], *m["teacher"][:2], b)[:3]

    steps = [("teacher", teacher_step, batch(64)), ("kd", kd_step, batch(32)),
             ("teacher_augment", teacher_augment_step, batch(64))]
    for _, fn, b in steps:
        for _ in range(3):
            fn(b)
    return steps


def time_train_steps(dev, steps):
    """``STEP_RUNS`` consecutive steps of each, CUDA events around each step
    as the train loop brackets them (a host-bound step is timed with its
    host enqueue): the median and the spread."""
    for name, fn, b in steps:
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(STEP_RUNS)]
        for start, end in ev:
            start.record()
            fn(b)
            end.record()
        torch.cuda.synchronize()
        ms = np.array([start.elapsed_time(end) for start, end in ev])
        med = float(np.median(ms))
        emit({"phase": f"{name}_step_time", **_stage_card(dev), "batch": len(b[1]),
              "compute_dtype": "bfloat16", "steps": STEP_RUNS, "ms_median": med,
              "ms_p10": float(np.percentile(ms, 10)), "ms_p90": float(np.percentile(ms, 90)),
              "ms_min": float(ms.min()), "ms_max": float(ms.max()),
              "images_per_s": len(b[1]) / med * 1e3, "step_ms": ms.tolist()})


def profile_train_steps(dev, steps):
    """torch.profiler over 3 steps of each: device busy time and idle share,
    launches per step, the top kernels."""
    for name, fn, b in steps:
        prof = profile_forward(fn, b, 3)
        emit({"phase": f"{name}_step_profile", **_stage_card(dev), "batch": len(b[1]),
              "compute_dtype": "bfloat16", "steps": prof["forwards"],
              "wall_ms": prof["wall_ms"], "device_busy_ms": prof["device_busy_ms"],
              "idle_share": prof["idle_share"],
              "launches_per_step": prof["launches_per_forward"],
              "top": [{"kernel": t["kernel"], "ms_per_step": t["ms_per_forward"],
                       "calls_per_step": t["calls_per_forward"]} for t in prof["top"]]})


def run_training(dev, root=None):
    """The training phases and the stage chain in a process of their own, as
    a user runs the stage CLIs: their steps are bound by the host's
    launches, so this process's state after the earlier phases (their
    profiles, allocations, objects) would be timed with them. The chain
    writes under ``root`` (a temporary directory if None) -> the kernel
    launches of the chain's stage 4 and the quantize stage's fold dir."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        proc = ctx.Process(target=training, args=(dev, root or tmp, q))
        proc.start()
        result = None
        while True:  # a child that dies without a word must not leave this waiting
            try:
                result = q.get(timeout=5)
                break
            except queue.Empty:
                if not proc.is_alive():
                    break
        proc.join()
    if proc.exitcode != 0 or result is None:
        raise SmokeFailure(f"the training phases failed (exit code {proc.exitcode})")
    return result


def training(dev, root, q):
    """The bf16 steps timed, the stage chain, then the steps profiled: the
    profiler's window comes after everything this process times. Puts the
    chain's result on ``q`` (None if anything failed)."""
    result = None
    try:
        steps = bf16_train_steps()
        time_train_steps(dev, steps)
        chain = stage_clis(dev, root)
        chain["eff"] = effnet_stage_clis(dev, root)
        chain["mbv2"] = mbv2_stage_clis(dev, root)
        chain["vit"] = vit_stage_clis(dev, root)
        chain["rx"] = rx_stage_clis(dev, root)
        rx_w4_qat(dev, root, chain["rx"])
        result = chain
        profile_train_steps(dev, steps)
    finally:
        q.put(result)


def stage_clis(dev, root):
    """Stages 1-4 through the port's CLIs on the card, into ``root``:
    ResNet50 teacher (bf16, batch 64, fold 0, one epoch), ResNet18 student
    distilled from it (batch 32, alpha 0.5, T 4), the student pruned (l2,
    ratio 0.11, round_to 8, one fine-tune epoch) and quantized (the default
    four methods and W4A16, 256 calibration images), ``choice=2`` after each. The
    kernel launch counts are set to 0 before the chain and read after stage
    4's ``choice=2``; then the fresh INT8 model's kernel path is held to its
    plain path, bit for bit, on 32 images. Stage logs go to stderr.
    -> {"launches", "quant_dir"}."""
    import contextlib

    from inference_efficient_vision_models_tpu_torch.cli import kd, prune, quantize, teacher
    from inference_efficient_vision_models_tpu_torch.core import artifacts

    common = [f"artifacts_root={root!r}", "experiment_name='smoke'", "folds=(0,)",
              "synthetic_size=600", "pretrained=False"]
    train_args = common + ["epochs=1", "compute_dtype='bfloat16'"]
    stages = [("teacher_cli", teacher, "teacher_training", "resnet50", 64,
               ["model_name='resnet50'"]),
              ("kd_cli", kd, "knowledge_distillation", "resnet18", 32,
               ["student_model='resnet18'", "teacher_exp_name='smoke'", "alpha=0.5",
                "temperature=4.0"])]
    _lib.reset_launch_counts()
    for phase, mod, stage, model, bs, args in stages:
        argv = train_args + args + [f"batch_size={bs}"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            first = mod.main(argv)
            wall = time.perf_counter() - t0
            second = mod.main(argv + ["choice=2"])
        fold_dir = os.path.join(root, stage, "smoke", "fold_0")
        hist = artifacts.load_training_log(fold_dir)
        step_ms = hist["step_ms"][0]
        steady = step_ms[2:]
        losses = hist["train_loss"] + hist["val_loss"] + [r["test_loss"] for r in first + second]
        best = artifacts.load_checkpoint_raw(fold_dir, artifacts.BEST)
        last = artifacts.load_checkpoint_raw(fold_dir, artifacts.LAST)
        ref_p, ref_s = _seeded_shapes(fold_dir)
        checks = {
            "losses_finite": bool(np.isfinite(losses).all()),
            # one epoch: model_best and model_last hold the same weights
            "best_equals_last": all(_same_values(best[k], last[k]) for k in ("params", "state")),
            "jax_layout": _same_shapes(best["params"], ref_p)
                          and _same_shapes(best["state"], ref_s)
                          and _same_shapes(last["opt"]["mu"], ref_p),
            "bytes_round_trip": _reserializes(fold_dir),
            "opt_step": int(last["opt"]["step"]) == len(step_ms),
            "choice2_test_acc_equal": [r["test_acc"] for r in second]
                                      == [r["test_acc"] for r in first],
        }
        med = float(np.median(steady))
        emit({"phase": phase, **_stage_card(dev), "model": model, "batch": bs,
              "compute_dtype": "bfloat16", "train_steps": len(step_ms),
              "step_ms": step_ms, "step_ms_median_steady": med,
              "images_per_s": bs / med * 1e3, "train_wall_s": wall,
              "epoch_time_s": hist["epoch_time"][0], "train_loss": hist["train_loss"][0],
              "val_acc": hist["val_acc"][0], "test_acc": first[0]["test_acc"],
              "test_acc_choice2": second[0]["test_acc"], "checks": checks})
        if not all(checks.values()):
            raise SmokeFailure(f"{phase}: {checks}")
    prune_cli(dev, root, common)
    q = quantize_cli(dev, root, common)
    q["tools_launches"] = accuracy_tools_cli(dev, root, common, q["rows"])
    return q


EFF_CHAIN_METHODS = ("static_int8", "static_int8_mixed", "dynamic_int8", "fp16", "bf16",
                     "weight_only_int8", "weight_only_int4")


def effnet_stage_clis(dev, root):
    """``effnet_chain``: EfficientNet-B0 through the port's four stage CLIs
    (``chain_stage_clis``)."""
    return chain_stage_clis(dev, root, "efficientnet_b0", "smoke_eff", "effnet_chain",
                            "efficientnet", (16, 24, 40, 80, 112, 192, 320))


def mbv2_stage_clis(dev, root):
    """``mbv2_chain``: MobileNetV2 through the port's four stage CLIs
    (``chain_stage_clis``); the fused executor's artifact is the shared
    static-int8 file, which ``load_quantized`` restores for it, as the JAX
    package's loader falls back (neither stage-4 CLI writes a fused file)."""
    return chain_stage_clis(dev, root, "mobilenet_v2", "smoke_mbv2", "mbv2_chain",
                            "mobilenet_v2", (16, 24, 32, 64, 96, 160, 320),
                            extra_restored=("static_int8_fused",))


VIT_CHAIN_METHODS = ("static_int8", "static_int8_bf16", "dynamic_int8", "fp16", "bf16",
                     "weight_only_int8", "weight_only_int4")


def vit_stage_clis(dev, root):
    """``vit_chain``: REPORT.md's ``vt2`` through the port's four stage CLIs
    (``chain_stage_clis``): a ViT-S/16 teacher, KD into ViT-Tiny/16, MLP
    units and heads pruned (l2, ratio 0.1, round_to 8), the six methods the
    port serves for a ViT; checkpoints also byte-round-trip."""
    return chain_stage_clis(dev, root, "vit_small_patch16_224", "smoke_vit", "vit_chain", "vit",
                            (768,) * 12, student="vit_tiny_patch16_224",
                            methods=VIT_CHAIN_METHODS, ratio=0.1,
                            must_launch=("int8_matmul_requant",))


RX_CHAIN_METHODS = ("static_int8", "dynamic_int8", "fp16", "weight_only_int8",
                    "weight_only_int4")


def rx_stage_clis(dev, root):
    """``rx_chain``: REPORT.md's ``rx1`` (``scripts/round4_rx1.sh``) through
    the port's four stage CLIs (``chain_stage_clis``): a resnext50_32x4d
    teacher, KD into resnext26_32x4d, pruned (l2, ratio 0.11, round_to 8:
    whole lanes of the 32 groups), quantized by five methods; kernels A and
    F must run. A ResNet spec carries no ``__kind__``."""
    return chain_stage_clis(dev, root, "resnext50_32x4d", "smoke_rx", "rx_chain", None,
                            (256, 512, 1024, 2048), student="resnext26_32x4d",
                            methods=RX_CHAIN_METHODS, ratio=0.11,
                            must_launch=("int8_matmul_requant", "gconv_int8"))


def _pruned_widths(spec, stock_widths):
    """(the pruned widths, their checks): every conv width, or a ViT's MLP
    widths, a multiple of 8 (an SE squeeze width below 8 is kept whole; a
    ResNeXt's inner widths whole lanes: multiples of its groups), and
    something pruned."""
    from inference_efficient_vision_models_tpu_torch.models.vit import ViTSpec
    from inference_efficient_vision_models_tpu_torch.models.widths import ResNetSpec

    if isinstance(spec, ResNetSpec):
        inner = [w for st in spec.inner_widths for blk in st for w in blk]
        return ({"stem_width": spec.stem_width, "stage_widths": spec.stage_widths,
                 "inner_widths": spec.inner_widths, "groups": spec.groups},
                {"prune_widths_multiple_of_8": all(
                    w % 8 == 0 for w in (spec.stem_width, *spec.stage_widths, *inner)),
                 "prune_whole_lanes": all(w % spec.groups == 0 for w in inner),
                 "prune_pruned": spec.stage_widths != tuple(stock_widths)})
    if isinstance(spec, ViTSpec):
        return ({"head_counts": spec.head_counts, "mlp_hidden": spec.mlp_hidden},
                {"prune_widths_multiple_of_8": all(w % 8 == 0 for w in spec.mlp_hidden),
                 "prune_pruned": spec.mlp_hidden != tuple(stock_widths)})
    widths = [spec.stem_width, spec.last_width, *spec.stage_widths,
              *(h for r in spec.hidden_widths for h in r)]
    se_widths = getattr(spec, "se_widths", ())
    return ({"stem_width": spec.stem_width, "stage_widths": spec.stage_widths,
             "hidden_widths": spec.hidden_widths, "se_widths": se_widths,
             "last_width": spec.last_width},
            {"prune_widths_multiple_of_8": all(w % 8 == 0 for w in widths) and all(
                w % 8 == 0 or w < 8 for r in se_widths for w in r),
             "prune_pruned": spec.stage_widths != tuple(stock_widths)})


def chain_stage_clis(dev, root, model: str, exp: str, phase: str, kind: str, stock_widths,
                     extra_restored=(), *, student=None, methods=EFF_CHAIN_METHODS,
                     ratio: float = 0.2, must_launch=("int8_matmul_requant", "dwconv_int8")):
    """A network (EfficientNet-B0, MobileNetV2, or a ViT pair) through the
    port's four stage CLIs at 224x224 and full width, fold 0, one epoch, the
    synthetic surrogate (480 images a split), ``choice=2`` after each: the
    teacher ``model`` (bf16, batch 32), KD into ``student`` (the model
    itself by default; alpha 0.5, T 4), prune (l2, ``ratio``, round_to 8,
    one fine-tune epoch) and quantize (minmax, 256 calibration images,
    ``methods``). Checks: finite losses, checkpoints in the JAX layout with
    ``__kind__ == kind`` (a ViT's also byte-round-trip), pruned widths
    multiples of 8, ``choice=2`` accuracy equal to ``choice=1``'s, every
    method's summary row and an artifact that ``load_quantized`` restores
    (and the methods of ``extra_restored``, from the files there). The
    kernel launch counts are set to 0 before the chain and read after it;
    each kernel of ``must_launch`` must have run. -> {"launches",
    "quant_dir"}."""
    import contextlib

    from inference_efficient_vision_models_tpu_torch.cli import kd, prune, quantize, teacher
    from inference_efficient_vision_models_tpu_torch.core import artifacts
    from inference_efficient_vision_models_tpu_torch.models.registry import spec_from_dict
    from inference_efficient_vision_models_tpu_torch.serving import load_quantized

    common = [f"artifacts_root={root!r}", f"experiment_name={exp!r}", "folds=(0,)",
              "synthetic_size=480", "pretrained=False", "batch_size=32"]
    train_args = common + ["epochs=1", "compute_dtype='bfloat16'"]
    student = student or model
    stages = [
        ("teacher", teacher, "teacher_training", train_args + [f"model_name={model!r}"]),
        ("kd", kd, "knowledge_distillation", train_args + [
            f"teacher_model={model!r}", f"student_model={student!r}",
            f"teacher_exp_name={exp!r}", "alpha=0.5", "temperature=4.0"]),
        ("prune", prune, "pruning", common + [
            f"source_exp_name={exp!r}", "pruning_method='l2'", f"pruning_ratio={ratio!r}",
            "round_to=8", "finetune_epochs=1", "compute_dtype='bfloat16'"]),
        ("quantize", quantize, "quantization", common + [
            "model_type='pruned'", f"pruning_exp_name={exp!r}", "calibration_images=256",
            "observer='minmax'", f"methods={tuple(methods)!r}"]),
    ]
    _lib.reset_launch_counts()
    out = {"phase": phase, **_stage_card(dev), "model": model, "student": student,
           "image_size": 224, "stages": {}}
    checks = {}
    for name, mod, stage, argv in stages:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            first = mod.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            second = mod.main(argv + ["choice=2"])
        fold_dir = os.path.join(root, stage, exp, "fold_0")
        rec = {"wall_s": wall, "rows": first, "choice2": second}
        if name != "quantize":
            hist = artifacts.load_training_log(fold_dir)
            spec_d = artifacts.load_spec_dict(fold_dir)
            best = artifacts.load_checkpoint_raw(fold_dir, artifacts.BEST)
            ref_p, ref_s = _seeded_shapes(fold_dir)
            step_ms = hist["step_ms"][0]
            losses = hist["train_loss"] + hist["val_loss"] + [
                r["test_loss"] for r in first + second if "test_loss" in r]
            rec.update({"train_steps": len(step_ms), "step_ms": step_ms,
                        "step_ms_median_steady": float(np.median(step_ms[2:])),
                        "epoch_s": hist["epoch_time"][0]})
            checks[f"{name}_losses_finite"] = bool(np.isfinite(losses).all())
            checks[f"{name}_kind"] = spec_d.get("__kind__") == kind
            checks[f"{name}_jax_layout"] = (_same_shapes(best["params"], ref_p)
                                            and _same_shapes(best["state"], ref_s))
            if kind == "vit":
                checks[f"{name}_bytes_round_trip"] = _reserializes(fold_dir)
            acc = "Accuracy" if name == "prune" else "test_acc"
            last = first[-1] if name == "prune" else first[0]
            checks[f"{name}_choice2_acc_equal"] = second[0][acc] == last[acc]
        if name == "prune":
            spec = spec_from_dict(artifacts.load_spec_dict(fold_dir))
            rec["spec"], width_checks = _pruned_widths(spec, stock_widths)
            checks.update(width_checks)
        if name == "quantize":
            rows = {r["method"]: r for r in first}
            reload = {r["method"]: r for r in second}
            for m in tuple(methods) + tuple(extra_restored):
                restored = True
                try:
                    load_quantized(fold_dir, m, device="cuda")
                except Exception as e:  # the check reports which method failed, and fails
                    restored = f"{type(e).__name__}: {e}"
                checks[f"quantize_{m}"] = restored is True and (m in extra_restored or (
                    m in rows and os.path.exists(os.path.join(fold_dir, f"model_{m}.msgpack"))
                    and m in reload and reload[m]["Accuracy"] == rows[m]["Accuracy"]))
            quant_dir = fold_dir
            from inference_efficient_vision_models_tpu_torch.core.provenance import (
                read_provenance)
            rec.update((read_provenance(fold_dir) or {}).get("static_int8_timings", {}))
        out["stages"][name] = rec
    torch.cuda.synchronize()
    launches = dict(_lib.launches)
    out.update({"launches": launches, "checks": checks})
    emit(out)
    if not all(v is True for v in checks.values()):
        raise SmokeFailure(f"{phase}: {checks}")
    for k in must_launch:
        if not launches.get(k):
            raise SmokeFailure(f"{phase}: {k} was not launched by the stage chain")
    return {"launches": launches, "quant_dir": quant_dir,
            "quant_rows": out["stages"]["quantize"]["rows"]}


def _seeded_shapes(fold_dir: str):
    """Seeded weights of the checkpoint's own spec: the JAX layout's shapes."""
    from inference_efficient_vision_models_tpu_torch.core import artifacts
    from inference_efficient_vision_models_tpu_torch.models.registry import spec_from_dict

    return params_from_seed(spec_from_dict(artifacts.load_spec_dict(fold_dir)), 0)


def prune_cli(dev, root, common):
    """Stage 3 through ``cli/prune.py`` (l2, ratio 0.11, round_to 8, one
    fine-tune epoch; batch 64 and bf16, the stage's defaults) and its
    ``choice=2``."""
    import contextlib

    from inference_efficient_vision_models_tpu_torch.cli import prune
    from inference_efficient_vision_models_tpu_torch.core import artifacts
    from inference_efficient_vision_models_tpu_torch.models.registry import spec_from_dict

    argv = common + ["source_exp_name='smoke'", "pruning_method='l2'", "pruning_ratio=0.11",
                     "round_to=8", "finetune_epochs=1", "compute_dtype='bfloat16'"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        first = prune.main(argv)
        wall = time.perf_counter() - t0
        second = prune.main(argv + ["choice=2"])
    fold_dir = os.path.join(root, "pruning", "smoke", "fold_0")
    hist = artifacts.load_training_log(fold_dir)
    spec = spec_from_dict(artifacts.load_spec_dict(fold_dir))
    best = artifacts.load_checkpoint_raw(fold_dir, artifacts.BEST)
    ref_p, ref_s = _seeded_shapes(fold_dir)
    rows = {r["phase"]: r for r in first}
    checks = {
        "losses_finite": bool(np.isfinite(hist["train_loss"] + hist["val_loss"]).all()),
        "phases": list(rows) == ["baseline", "pruned", "pruned+ft"],
        "jax_layout_at_spec_widths": _same_shapes(best["params"], ref_p)
                                     and _same_shapes(best["state"], ref_s),
        "pruned": spec.stage_widths != (64, 128, 256, 512)
                  and all(w % 8 == 0 for w in spec.stage_widths),
        "bytes_round_trip": _reserializes(fold_dir),
        "choice2_acc_equal": second[0]["Accuracy"] == rows["pruned+ft"]["Accuracy"],
    }
    step_ms = hist["step_ms"][0]
    emit({"phase": "prune_cli", **_stage_card(dev), "model": "resnet18", "batch": 64,
          "stem_width": spec.stem_width, "stage_widths": list(spec.stage_widths),
          "prune_wall_s": wall, "finetune_steps": len(step_ms), "finetune_step_ms": step_ms,
          "finetune_step_ms_median_steady": float(np.median(step_ms[2:])),
          "finetune_epoch_s": hist["epoch_time"][0], "rows": first, "choice2": second,
          "checks": checks})
    if not all(checks.values()):
        raise SmokeFailure(f"prune_cli: {checks}")


def quantize_cli(dev, root, common):
    """Stage 4 through ``cli/quantize.py`` on the pruned model (the default
    methods and W4A16, 256 calibration images, batch 32) and its ``choice=2``; the
    calibration and conversion times are the engine's, from the fold's
    provenance record. Fails when a requested method has no summary row or
    no artifact, its ``choice=2`` accuracy differs, or the times are
    missing."""
    import contextlib

    from inference_efficient_vision_models_tpu_torch.cli import quantize
    from inference_efficient_vision_models_tpu_torch.compress.quant.qresnet import (
        load_static_int8)
    from inference_efficient_vision_models_tpu_torch.core.config import QuantConfig
    from inference_efficient_vision_models_tpu_torch.core.provenance import read_provenance

    methods = QuantConfig(artifacts_root=root).methods + ("weight_only_int4",)
    argv = common + ["model_type='pruned'", "pruning_exp_name='smoke'",
                     "calibration_images=256", f"methods={methods!r}"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        first = quantize.main(argv)
        wall = time.perf_counter() - t0
        second = quantize.main(argv + ["choice=2"])
    torch.cuda.synchronize()
    launches = dict(_lib.launches)
    fold_dir = os.path.join(root, "quantization", "smoke", "fold_0")
    rows = {r["method"]: r for r in first}
    reload = {r["method"]: r for r in second}
    checks = {m: {"row": m in rows, "artifact": os.path.exists(
                      os.path.join(fold_dir, f"model_{m}.msgpack")),
                  "restored": m in reload,
                  "choice2_acc_equal": m in reload and m in rows
                                       and reload[m]["Accuracy"] == rows[m]["Accuracy"]}
              for m in methods}
    checks["fp32"] = {"row": "fp32" in rows}
    timed = (read_provenance(fold_dir) or {}).get("static_int8_timings", {})
    checks["static_int8_timings"] = {k: k in timed for k in ("calibrate_s", "convert_s")}
    model = load_static_int8(fold_dir, "cuda")
    hw = 2 * model.q["stem"]["e4"].shape[1]  # the image size it was converted for
    x = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (32, hw, hw, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        kernel, plain = model(x), model(x, impl="plain")
    exact = bool(torch.equal(kernel, plain))
    emit({"phase": "quantize_cli", **_stage_card(dev), "model": "resnet18 (pruned)",
          "methods": list(methods), "quantize_wall_s": wall, **timed, "rows": first,
          "choice2": second, "launches": launches,
          "int8_kernel_vs_plain": {"images": 32, "equal": exact,
                                   "max_abs_err": float((kernel - plain).abs().max())},
          "checks": checks})
    bad = {m: c for m, c in checks.items() if not all(c.values())}
    if bad or not exact:
        raise SmokeFailure(f"quantize_cli: {bad}, kernel path equal to plain: {exact}")
    for k in ("int8_matmul_requant", "conv3x3_s1_int8"):
        if not launches.get(k):
            raise SmokeFailure(f"quantize_cli: {k} was not launched by the stage chain")
    return {"launches": launches, "quant_dir": fold_dir, "rows": first}


TOOLS_METHODS = ("static_int8", "weight_only_int8", "weight_only_int4")
TOOLS_ADA_ITERS = 50


def _steady_median(ms) -> float:
    """The median of a loop's per-step device ms past its first two steps."""
    return float(np.median(ms[2:] if len(ms) > 2 else ms)) if ms else float("nan")


def _tool_times(rec: dict) -> dict:
    """The accuracy tools' times from a fold's provenance record: each
    method's QAT step and AdaRound iteration (device ms, CUDA events, median
    of the steady steps), the sweeps' wall seconds."""
    out = {}
    for method, t in (rec or {}).get("accuracy_tool_timings", {}).items():
        for k, v in t.items():
            out[f"{method}_{k}"] = v if k == "wall_s" else {
                "steps": len(v), "median_steady": _steady_median(v)}
    return out


def accuracy_tools_cli(dev, root, common, plain_rows):
    """``accuracy_tools``: stage 4 through ``cli/quantize.py`` on the chain's
    pruned ResNet18 (experiment ``smoke``) under the experiment
    ``smoke_tools``, with ``qat_epochs=1 adaround_iters=50 sensitivity=True
    automix=True`` and the methods ``TOOLS_METHODS``, and its ``choice=2``.
    The kernel launch counts are set to 0 just before the CLI and read just
    after it. Fails unless every method has a row, an artifact that
    ``load_quantized`` restores and an equal ``choice=2`` accuracy; both CSVs
    exist with the JAX CLI's columns (one sensitivity row a tap but the
    input, then ``__weights__`` and ``__all__``); the provenance records the
    tools' knobs and times; the QAT + AdaRound static-INT8 model's kernel
    path equals its plain path on 32 images, kernels A and B launched; and
    AdaRound's contract holds on the card (``adaround_contract``: the
    chain's model, 8 iterations on 64 surrogate images, converted again).
    Records each method's accuracy beside ``quantize_cli``'s without the
    tools (no limit: one epoch on the surrogate). -> the CLI's launches."""
    import contextlib
    import csv

    from inference_efficient_vision_models_tpu_torch.cli import quantize
    from inference_efficient_vision_models_tpu_torch.cli.teacher import load_stage_model
    from inference_efficient_vision_models_tpu_torch.compress.quant import qresnet
    from inference_efficient_vision_models_tpu_torch.compress.quant.adaround import (
        adaround_refine)
    from inference_efficient_vision_models_tpu_torch.compress.quant.engine import (
        QuantizationEngine)
    from inference_efficient_vision_models_tpu_torch.core.config import QuantConfig
    from inference_efficient_vision_models_tpu_torch.core.log import get_logger
    from inference_efficient_vision_models_tpu_torch.core.provenance import read_provenance
    from inference_efficient_vision_models_tpu_torch.serving import load_quantized

    argv = [a for a in common if not a.startswith("experiment_name=")] + [
        "experiment_name='smoke_tools'", "model_type='pruned'", "pruning_exp_name='smoke'",
        "calibration_images=256", f"methods={TOOLS_METHODS!r}", "qat_epochs=1",
        f"adaround_iters={TOOLS_ADA_ITERS}", "sensitivity=True", "automix=True"]
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        first = quantize.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_lib.launches)
        second = quantize.main(argv + ["choice=2"])
    out_dir = os.path.join(root, "quantization", "smoke_tools")
    fold_dir = os.path.join(out_dir, "fold_0")
    rows = {r["method"]: r for r in first}
    reload = {r["method"]: r for r in second}
    checks = {}
    for m in TOOLS_METHODS:
        try:
            load_quantized(fold_dir, m, device="cuda")
            restored = True
        except Exception as e:  # the check reports which method failed, and fails
            restored = f"{type(e).__name__}: {e}"
        checks[m] = restored is True and m in rows and m in reload and os.path.exists(
            os.path.join(fold_dir, f"model_{m}.msgpack")) and (
            reload[m]["Accuracy"] == rows[m]["Accuracy"])

    model = qresnet.load_static_int8(fold_dir, "cuda")
    hw = 2 * model.q["stem"]["e4"].shape[1]
    x = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (32, hw, hw, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        kernel, plain = model(x), model(x, impl="plain")
        _, taps = qresnet.apply_folded(model.spec, qresnet.place_folded(
            qresnet.fold(model.spec, *params_from_seed(model.spec, 0)), "cuda"),
            torch.zeros_like(x[:1], dtype=torch.float32), with_taps=True)
    exact = bool(torch.equal(kernel, plain))
    names = sorted(n for n in taps if n != "input")
    csvs = {}
    for kind, cols in (("sensitivity", ["tap", "logit_rmse", "top1_flips"]),
                       ("automix", ["k", "float_taps", "top1_flips", "logit_rmse", "acc"])):
        path = os.path.join(out_dir, f"{kind}_fold0.csv")
        if not os.path.exists(path):
            checks[f"{kind}_csv"] = False
            continue
        with open(path) as f:
            csvs[kind] = list(csv.DictReader(f))
        checks[f"{kind}_csv"] = bool(csvs[kind]) and list(csvs[kind][0]) == cols
    if "sensitivity" in csvs:
        taps_csv = [r["tap"] for r in csvs["sensitivity"]]
        checks["sensitivity_rows"] = (sorted(taps_csv[:-2]) == names
                                      and taps_csv[-2:] == ["__weights__", "__all__"])
    if "automix" in csvs:
        checks["automix_rungs"] = [int(r["k"]) for r in csvs["automix"]] == list(
            range(len(csvs["automix"])))
    rec = read_provenance(fold_dir) or {}
    times = _tool_times(rec)
    checks["provenance_knobs"] = (rec.get("qat_epochs"), rec.get("adaround_iters")) == (
        1, TOOLS_ADA_ITERS)
    checks["provenance_times"] = all(
        times.get(k, {}).get("steps") for k in ("static_int8_qat_step_ms",
                                                "static_int8_adaround_iter_ms",
                                                "weight_only_int8_qat_step_ms",
                                                "weight_only_int4_qat_step_ms")) and all(
        k in times for k in ("sensitivity_wall_s", "automix_wall_s"))
    checks["int8_kernel_vs_plain_equal"] = exact
    checks["kernels_launched"] = all(launches.get(k) for k in ("int8_matmul_requant",
                                                               "conv3x3_s1_int8"))

    # AdaRound's contract on the card, through the conversion's integer leaves
    spec, params, state = load_stage_model(os.path.join(root, "pruning", "smoke", "fold_0"),
                                           "best", "cuda")
    cfg = QuantConfig(artifacts_root=os.path.join(root, "contract"), batch_size=32,
                      calibration_images=64)
    engine = QuantizationEngine(cfg, spec, params, state, get_logger(name="contract"), "cuda")
    calib = (chain_images(hw, 64), np.zeros(64, np.int32))
    obs = engine.calibrate(calib)
    hardened, rounding = adaround_refine(spec, qresnet, engine.folded, obs, calib, iters=8,
                                         device="cuda", return_rounding=True)
    contract = adaround_contract(engine.folded, hardened, rounding, qresnet.convert_static_int8(
        spec, hardened, obs, image_size=(hw, hw)))
    checks["adaround_contract"] = (contract["int_equal"] and contract["argmax_kept"]
                                   and contract["scale_equal"])
    plain_acc = {r["method"]: r["Accuracy"] for r in plain_rows}
    emit({"phase": "accuracy_tools", **_stage_card(dev), "model": "resnet18 (pruned)",
          "methods": list(TOOLS_METHODS), "qat_epochs": 1, "adaround_iters": TOOLS_ADA_ITERS,
          "quantize_wall_s": wall,
          "accuracy": {m: {"with_tools": rows[m]["Accuracy"] if m in rows else None,
                           "without (quantize_cli)": plain_acc.get(m)} for m in TOOLS_METHODS},
          "times": times, "sensitivity": csvs.get("sensitivity"),
          "automix": csvs.get("automix"), "launches": launches,
          "int8_kernel_vs_plain": {"images": 32, "equal": exact,
                                   "max_abs_err": float((kernel - plain).abs().max())},
          "adaround_contract": contract, "rows": first, "choice2": second, "checks": checks})
    if not all(v is True for v in checks.values()):
        raise SmokeFailure(f"accuracy_tools: {checks}")
    return launches


def rx_w4_qat(dev, root, rx):
    """``rx_w4_qat``: one more stage-4 call on the ResNeXt chain's pruned
    resnext26 with ``qat_epochs=1 methods=('weight_only_int4',)`` (W4 QAT
    before the conversion), and its ``choice=2``; fails unless the row, the
    restored artifact, the equal ``choice=2`` accuracy and the provenance's
    QAT record are there. Records the W4A16 accuracy beside the chain's
    without QAT (no limit)."""
    import contextlib

    from inference_efficient_vision_models_tpu_torch.cli import quantize
    from inference_efficient_vision_models_tpu_torch.core.provenance import read_provenance
    from inference_efficient_vision_models_tpu_torch.serving import load_quantized

    argv = [f"artifacts_root={root!r}", "experiment_name='smoke_rx_w4qat'", "folds=(0,)",
            "synthetic_size=480", "pretrained=False", "batch_size=32", "model_type='pruned'",
            "pruning_exp_name='smoke_rx'", "calibration_images=256", "observer='minmax'",
            "methods=('weight_only_int4',)", "qat_epochs=1"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        first = quantize.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        second = quantize.main(argv + ["choice=2"])
    fold_dir = os.path.join(root, "quantization", "smoke_rx_w4qat", "fold_0")
    rows = {r["method"]: r for r in first}
    reload = {r["method"]: r for r in second}
    rec = read_provenance(fold_dir) or {}
    times = _tool_times(rec)
    load_quantized(fold_dir, "weight_only_int4", device="cuda")
    checks = {"row": "weight_only_int4" in rows,
              "choice2_acc_equal": "weight_only_int4" in reload and "weight_only_int4" in rows
                                   and reload["weight_only_int4"]["Accuracy"]
                                   == rows["weight_only_int4"]["Accuracy"],
              "provenance": rec.get("qat_epochs") == 1 and bool(
                  times.get("weight_only_int4_qat_step_ms", {}).get("steps"))}
    chain = {r["method"]: r["Accuracy"] for r in rx["quant_rows"]}
    emit({"phase": "rx_w4_qat", **_stage_card(dev), "model": "resnext26_32x4d (pruned)",
          "qat_epochs": 1, "wall_s": wall,
          "w4a16_accuracy": {"with_w4_qat": rows.get("weight_only_int4", {}).get("Accuracy"),
                             "without (rx_chain)": chain.get("weight_only_int4"),
                             "w8a16 (rx_chain)": chain.get("weight_only_int8"),
                             "fp32 (rx_chain)": chain.get("fp32")},
          "times": times, "rows": first, "choice2": second, "checks": checks})
    if not all(checks.values()):
        raise SmokeFailure(f"rx_w4_qat: {checks}")


def _same_shapes(tree, ref) -> bool:
    a, b = _flat_sorted(tree), _flat_sorted(ref)
    return a.keys() == b.keys() and all(a[k].shape == b[k].shape for k in a)


def _same_values(tree, ref) -> bool:
    a, b = _flat_sorted(tree), _flat_sorted(ref)
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _reserializes(fold_dir: str) -> bool:
    """Each checkpoint read by the port's reader and written again by its
    writer gives the file's bytes."""
    from inference_efficient_vision_models_tpu_torch.core import artifacts

    for which in (artifacts.BEST, artifacts.LAST):
        with open(os.path.join(fold_dir, f"model_{which}.msgpack"), "rb") as f:
            data = f.read()
        if artifacts.msgpack_serialize(artifacts.msgpack_restore(data)) != data:
            return False
    return True


# --------------------------------------------------------------------------
# the deployment entry points: served rates, the HTTP server, the predict CLI
# --------------------------------------------------------------------------

SERVE_IMAGES = 2048  # serve_rates: 8 batches of 256
SERVE_ROUNDS = 3  # serve_rates: each way timed this many times, in alternating order
SERVER_CLIENTS, SERVER_REQUESTS = 8, 40
SERVER_SIZES = (1, 1, 8, 32)  # request sizes, in a seeded order, cycled per client
R18_LIMIT = {"rtol": 0.02, "atol": 0.02}  # PERF.md §2: the ResNet18 served-logit limit
CLI_IMAGES = 300  # predict_cli: seeded 200x200 BMPs, half 8-bit paletted, half 24-bit


def bmp_bytes(img: np.ndarray) -> bytes:
    """An uncompressed BMP of (H, W) uint8 (8-bit, grey palette) or (H, W, 3)
    uint8 RGB (24-bit BGR): bottom-up rows padded to 4 bytes, NEU-DET's two
    kinds of file."""
    h, w = img.shape[:2]
    if img.ndim == 2:
        palette = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
        palette[:, 3] = 0
        rows, bpp, ncolors = img, 8, 256
    else:
        palette = np.zeros((0, 4), np.uint8)
        rows, bpp, ncolors = img[..., ::-1].reshape(h, w * 3), 24, 0
    pix = np.zeros((h, (rows.shape[1] + 3) & ~3), np.uint8)
    pix[:, : rows.shape[1]] = rows[::-1]
    off = 14 + 40 + palette.size
    return (struct.pack("<2sIHHI", b"BM", off + pix.size, 0, 0, off)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, 0, pix.size, 2835, 2835, ncolors, 0)
            + palette.tobytes() + pix.tobytes())


def png_bytes(img: np.ndarray) -> bytes:
    """A (H, W, 3) uint8 image as an 8-bit RGB PNG (written without PIL)."""
    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def http(port: int, method: str, path: str, body=None, headers=None, timeout: float = 300):
    """One request to the server on 127.0.0.1 -> (status, content type, body)."""
    conn = http_client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def post_npy(port: int, imgs: np.ndarray):
    """POST (n, H, W, 3) uint8 as npy, logits back as npy -> (status, logits or body)."""
    code, ctype, raw = http(port, "POST", "/v1/predict", npy_bytes(imgs),
                            {"Content-Type": "application/x-npy", "Accept": "application/x-npy"})
    return code, (np.load(io.BytesIO(raw)) if ctype == "application/x-npy" else raw)


def run_serve_rates(dev):
    """r2 through ``Predictor`` at batch 256 over 2,048 seeded images, three
    ways: host s2d by numpy (the plain version), host s2d by the native row
    interleave, and ``device_preprocess=True`` (no host preprocess); logits
    identical across the three and through ``predict_stream``."""
    from inference_efficient_vision_models_tpu_torch.ops.space_to_depth import (
        space_to_depth_u8, space_to_depth_u8_plain)
    from inference_efficient_vision_models_tpu_torch.serving import load_quantized

    imgs = np.random.default_rng(11).integers(0, 256, (SERVE_IMAGES, 224, 224, 3),
                                              dtype=np.uint8)
    _, _, fn, pre = load_quantized(ARTIFACT, device="cuda")
    _, _, fn_d, pre_d = load_quantized(ARTIFACT, device="cuda", device_preprocess=True)
    if pre is not space_to_depth_u8 or pre_d is not None:
        raise SmokeFailure(f"load_quantized gave host preprocesses {pre} / {pre_d}")
    ways = {"host_numpy": Predictor(fn, host_preprocess=space_to_depth_u8_plain,
                                    batch_size=BATCH, device="cuda"),
            "host_native": Predictor(fn, host_preprocess=pre, batch_size=BATCH, device="cuda"),
            "device_s2d": Predictor(fn_d, host_preprocess=None, batch_size=BATCH, device="cuda")}
    for pred in ways.values():
        pred.warmup()
    rates = {k: [] for k in ways}
    outs = {}
    for r in range(SERVE_ROUNDS):
        for k in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
            t0 = time.perf_counter()
            outs[k] = ways[k].predict_logits(imgs)
            rates[k].append(len(imgs) / (time.perf_counter() - t0))
    ref = outs["host_native"]
    identical = {k: bool(np.array_equal(v, ref)) for k, v in outs.items()}
    stream = np.concatenate(list(ways["host_native"].predict_stream(
        imgs[i : i + BATCH] for i in range(0, len(imgs), BATCH))))
    host_ms = {}
    for name, f in (("numpy", space_to_depth_u8_plain), ("native", space_to_depth_u8)):
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            f(imgs[:BATCH])
            t.append((time.perf_counter() - t0) * 1e3)
        host_ms[name] = float(np.median(t))
    emit({"phase": "serve_rates", **_stage_card(dev), "images": len(imgs), "batch": BATCH,
          "rounds": SERVE_ROUNDS, "images_per_s": {k: float(np.median(v)) for k, v in rates.items()},
          "images_per_s_runs": rates, "host_s2d_ms_per_batch": host_ms,
          "host_threads": os.cpu_count(), "logits_identical": identical,
          "predict_stream_identical": bool(np.array_equal(stream, ref))})
    if not all(identical.values()) or not np.array_equal(stream, ref):
        raise SmokeFailure(f"serve_rates: the three ways or predict_stream disagree: {identical}")


def _server(fold: str, method: str):
    """``InferenceServer.from_artifact`` at the JAX package's defaults (batch
    64, buckets 1 and 8, 2 ms wait) on a free port, warmed, and a
    ``Predictor`` of the same batching for reference answers."""
    from inference_efficient_vision_models_tpu_torch.server import InferenceServer

    t0 = time.perf_counter()
    srv = InferenceServer.from_artifact(fold, method, port=0).start()
    warm = time.perf_counter() - t0
    ref = Predictor.from_artifact(fold, method, device="cuda", batch_size=srv.pred.batch_size,
                                  bucket_sizes=srv.pred.bucket_sizes)
    return srv, ref, warm


@contextlib.contextmanager
def recorded_forwards(pred, keep_inputs: bool = True):
    """Wrap ``pred._run`` and ``pred.apply_fn``, which the server's
    dispatcher thread calls in turn once per coalesced and padded batch, to
    keep each batch's staged host input (``keep_inputs``: a copy, since the
    batcher stages every batch in one reused buffer), its logits and CUDA
    events around the forward; yields the list they go to and unwraps on
    exit."""
    log, run_staged, fn = [], pred._run, pred.apply_fn

    def run_host(host):
        log.append([host.clone() if keep_inputs else None])
        return run_staged(host)

    def run(x):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = fn(x)
        end.record()
        log[-1] += [y, start, end]
        return y

    pred._run, pred.apply_fn = run_host, run
    try:
        yield log
    finally:
        pred._run, pred.apply_fn = run_staged, fn


def forward_spans(log) -> dict:
    """Each recorded forward's device span (CUDA events: from the stream
    reaching its first launch to its last kernel's end), by batch rows."""
    torch.cuda.synchronize()
    spans = {}
    for _, y, start, end in log:
        spans.setdefault(len(y), []).append(start.elapsed_time(end))
    return {str(b): {"forwards": len(v), "median": float(np.median(v)), "mean": float(np.mean(v)),
                     "sum": float(np.sum(v))} for b, v in sorted(spans.items())}


def dispatched_vs_plain(model, log, tau=None):
    """Every batch the server dispatched, its staged host input held
    against ``model``'s plain version on it: bit for bit (``tau`` None),
    else ``logits_close`` at ``tau``. -> (summary, failures)."""
    rows = same = 0
    worst, fails, by_rows = 0.0, [], {}
    with torch.inference_mode():
        for i, (host, y, _, _) in enumerate(log):
            by_rows[str(len(y))] = by_rows.get(str(len(y)), 0) + 1
            plain = model(host.cuda(), impl="plain")
            got, ref = y.float().cpu().numpy(), plain.float().cpu().numpy()
            err = float(np.abs(got - ref).max())
            worst = max(worst, err)
            rows += len(got)
            same += int(sum(np.array_equal(g, r) for g, r in zip(got, ref)))
            ok = torch.equal(y, plain) if tau is None else logits_close(got, ref, tau)[0]
            if not ok:
                fails.append(f"dispatched batch {i} ({len(got)} rows): max abs err {err}")
    return {"forwards": len(log), "forwards_by_rows": by_rows, "rows": rows,
            "rows_bit_identical": same, "max_abs_err": worst,
            "check": "bit-exact" if tau is None else f"logits_close tau {tau}"}, fails


def stats_since(now: dict, before: dict) -> dict:
    """``MicroBatcher.stats()`` counters between two readings."""
    n = {k: now[k] - before[k] for k in ("requests", "batches", "images")}
    slots = round(now["mean_dispatch_slots"] * now["batches"]
                  - before["mean_dispatch_slots"] * before["batches"])
    b = max(n["batches"], 1)
    return {**n, "mean_batch": n["images"] / b, "mean_dispatch_slots": slots / b}


def _server_launches(srv, per_forward: dict, label: str):
    """Launches since the last reset, against ``per_forward`` x the batches
    the server's stats count; -> (launches, stats)."""
    launches = dict(_lib.launches)
    stats = srv.batcher.stats()
    for k in set(per_forward) | set(launches):
        if launches.get(k, 0) != per_forward.get(k, 0) * stats["batches"]:
            raise SmokeFailure(f"{label}: {k} launched {launches.get(k, 0)} times for "
                               f"{stats['batches']} batches, expected "
                               f"{per_forward.get(k, 0) * stats['batches']}")
    return launches, stats


def run_server_r2(dev):
    """r2 behind the HTTP server: 8 clients x 40 requests of seeded sizes,
    three times. Counted (plus one request alone per bucket): launches
    against the batches the server ran, and each batch it dispatched
    against the plain forward, bit for bit. Timed:
    latency, rate, forward spans, dispatcher busy time. Profiled: device
    busy time over the window. Every answer of the first two against
    ``Predictor.predict_logits`` of its images (the ResNet18 limit;
    bit-identical rows counted); then each payload kind and error status."""
    from concurrent.futures import ThreadPoolExecutor

    from inference_efficient_vision_models_tpu_torch.data.native_loader import (
        decode_batch_native)

    srv, ref_pred, warm = _server(ARTIFACT, "static_int8")
    try:
        rng = np.random.default_rng(12)
        sizes = rng.permutation(SERVER_SIZES)
        reqs = [[rng.integers(0, 256, (int(sizes[(c + i) % len(sizes)]), 224, 224, 3),
                              dtype=np.uint8) for i in range(SERVER_REQUESTS)]
                for c in range(SERVER_CLIENTS)]

        def client(c):
            out = []
            for imgs in reqs[c]:
                t0 = time.perf_counter()
                code, logits = post_npy(srv.port, imgs)
                out.append((code, logits, time.perf_counter() - t0))
            return out

        def load():
            t0 = time.perf_counter()
            with ThreadPoolExecutor(SERVER_CLIENTS) as pool:
                futs = [pool.submit(client, c) for c in range(SERVER_CLIENTS)]
                answers = [f.result() for f in futs]
            return answers, time.perf_counter() - t0

        n_images = sum(len(r) for rs in reqs for r in rs)
        model = srv.pred.apply_fn
        # pass 1, counted and checked: launches against the batches the
        # server ran; each batch as the server coalesced and padded it (its
        # host images kept) against the plain forward on the same input.
        # After the load, one request alone per bucket below the batch, so
        # that every bucket runs whatever the coalescing did
        solo_rng = np.random.default_rng(16)
        solo = [solo_rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8)
                for b in srv.pred.bucket_sizes]
        _lib.reset_launch_counts()
        with recorded_forwards(srv.pred) as log:
            answers, _ = load()
            solo_answers = [post_npy(srv.port, x) for x in solo]
        launches, stats = _server_launches(srv, PER_FORWARD, "server_r2")
        n_counted = n_images + sum(len(x) for x in solo)
        if (stats["requests"] != SERVER_CLIENTS * SERVER_REQUESTS + len(solo)
                or stats["images"] != n_counted):
            raise SmokeFailure(f"server_r2: stats {stats} for {n_counted} images")
        plain, plain_fails = dispatched_vs_plain(model, log)
        del log

        # pass 2, timed, keeping no inputs: each forward's device span, the
        # dispatcher's busy seconds and the host staging (s2d + pinned copy)
        # within them
        busy = {"dispatch_s": 0.0, "stage_host_s": 0.0}

        def timed(fn, key):
            def run(*a):
                t = time.perf_counter()
                try:
                    return fn(*a)
                finally:
                    busy[key] += time.perf_counter() - t
            return run

        srv.batcher._dispatch = timed(srv.batcher._dispatch, "dispatch_s")
        srv.pred._stage_host = timed(srv.pred._stage_host, "stage_host_s")
        with recorded_forwards(srv.pred, keep_inputs=False) as log:
            timed_answers, wall = load()
        del srv.batcher._dispatch, srv.pred._stage_host  # back to the methods
        spans = forward_spans(log)
        del log
        timed_stats = stats_since(srv.batcher.stats(), stats)

        # pass 3, the same load under torch.profiler: the device's busy time
        # over the window (the dispatcher thread's kernels), against its wall
        before = srv.batcher.stats()
        prof = profile_window(load, unit="window")
        prof["batches"] = srv.batcher.stats()["batches"] - before["batches"]

        # every answer of passes 1 and 2 against Predictor.predict_logits of
        # the request's images alone (another batch composition)
        flat = [(imgs, ans[i]) for rs, ans in [*zip(reqs, answers), *zip(reqs, timed_answers)]
                for i, imgs in enumerate(rs)]
        flat += [(x, (code, got, None)) for x, (code, got) in zip(solo, solo_answers)]
        rows = identical = 0
        worst = 0.0
        for imgs, (code, got, _) in flat:
            if code != 200:
                raise SmokeFailure(f"server_r2: status {code}: {got}")
            want = ref_pred.predict_logits(imgs)
            worst = max(worst, float(np.abs(got - want).max()))
            if not (np.allclose(got, want, **R18_LIMIT)
                    and (got.argmax(1) == want.argmax(1)).all()):
                raise SmokeFailure(f"server_r2: answer off its Predictor logits by {worst}")
            rows += len(imgs)
            identical += int(sum(np.array_equal(a, w) for a, w in zip(got, want)))
        lat = {}
        for rs, ans in zip(reqs, timed_answers):
            for imgs, (_, _, secs) in zip(rs, ans):
                lat.setdefault(len(imgs), []).append(secs * 1e3)

        # each payload kind and error status, one request at a time
        img = reqs[0][0][:1]
        _, want = post_npy(srv.port, img)
        code, _, raw = http(srv.port, "POST", "/v1/predict", json.dumps(
            {"images_b64": base64.b64encode(npy_bytes(img[0])).decode()}).encode(),
            {"Content-Type": "application/json"})
        js = json.loads(raw)
        json_ok = bool(code == 200 and js["classes"] == want.argmax(1).tolist()
                       and np.abs(np.array(js["logits"]) - want).max() <= 1e-4)
        code, _, raw = http(srv.port, "POST", "/v1/predict", bmp_bytes(img[0]),
                            {"Content-Type": "image/bmp", "Accept": "application/x-npy"})
        bmp224_ok = bool(code == 200 and np.array_equal(np.load(io.BytesIO(raw)), want))
        small = rng.integers(0, 256, (200, 200), dtype=np.uint8)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "neu.bmp")
            with open(path, "wb") as f:
                f.write(bmp_bytes(small))
            decoded, ok = decode_batch_native([path], (224, 224))
        code, _, raw = http(srv.port, "POST", "/v1/predict", bmp_bytes(small),
                            {"Content-Type": "image/bmp", "Accept": "application/x-npy"})
        bmp200_ok = bool(ok.all() and code == 200
                         and np.array_equal(np.load(io.BytesIO(raw)),
                                            post_npy(srv.port, decoded)[1]))
        # a PNG needs PIL: decoded where it is installed, else 415 naming it;
        # the second request hides PIL from this process to take that branch
        png = png_bytes(img[0])
        try:
            import PIL  # noqa: F401
            pil = True
        except ImportError:
            pil = False
        png_code = http(srv.port, "POST", "/v1/predict", png, {"Content-Type": "image/png"})[0]
        saved = sys.modules.get("PIL")
        sys.modules["PIL"] = None
        try:
            png_code_no_pil, _, png_raw = http(srv.port, "POST", "/v1/predict", png,
                                               {"Content-Type": "image/png"})
        finally:
            if saved is None:
                sys.modules.pop("PIL")
            else:
                sys.modules["PIL"] = saved
        errors = {
            404: http(srv.port, "GET", "/nope")[0],
            413: http(srv.port, "POST", "/v1/predict", b"",
                      {"Content-Type": "application/x-npy"})[0],
            415: http(srv.port, "POST", "/v1/predict", b"x", {"Content-Type": "text/plain"})[0],
            400: http(srv.port, "POST", "/v1/predict", b"not npy",
                      {"Content-Type": "application/x-npy"})[0],
        }
        health = http(srv.port, "GET", "/healthz")[0]
        meta = json.loads(http(srv.port, "GET", "/v1/metadata")[2])
    finally:
        srv.close()
    payloads = {"json_b64": json_ok, "bmp_224_equals_npy": bmp224_ok,
                "bmp_200_8bit_equals_file_decode": bmp200_ok, "pil_installed": pil,
                "png_status": png_code, "png_status_without_pil": png_code_no_pil,
                "png_error_without_pil": png_raw.decode(errors="replace")[:200],
                "errors": errors, "healthz": health}
    emit({"phase": "server_r2", **_stage_card(dev), "warmup_s": warm,
          "clients": SERVER_CLIENTS, "requests": SERVER_CLIENTS * SERVER_REQUESTS,
          "images": n_images, "wall_s": wall, "images_per_s": n_images / wall,
          "latency_ms": {str(n): {"requests": len(v), "p50": float(np.percentile(v, 50)),
                                  "p99": float(np.percentile(v, 99))}
                         for n, v in sorted(lat.items())},
          "stats": timed_stats,
          "dispatcher_busy": {**busy, "share_of_wall": busy["dispatch_s"] / wall},
          "device_span_ms": spans,
          "device_span_share_of_wall": sum(v["sum"] for v in spans.values()) / (wall * 1e3),
          "profiled_load": prof, "counted_stats": stats, "launches": launches,
          "dispatched_vs_plain": plain, "rows": rows, "rows_bit_identical_to_predictor": identical,
          "max_abs_err": worst, "limit": R18_LIMIT, "payloads": payloads,
          "metadata": {k: meta[k] for k in ("batch_size", "bucket_sizes", "max_batch")}})
    if plain_fails:
        raise SmokeFailure("server_r2: dispatched batches differ from the plain forward:\n"
                           + "\n".join(plain_fails))
    bad = [k for k in ("json_b64", "bmp_224_equals_npy", "bmp_200_8bit_equals_file_decode")
           if not payloads[k]]
    if (bad or png_code != (200 if pil else 415) or png_code_no_pil != 415
            or "PIL" not in payloads["png_error_without_pil"]
            or any(k != v for k, v in errors.items()) or health != 200):
        raise SmokeFailure(f"server_r2: payloads or statuses wrong: {bad} {payloads}")
    return launches


def run_server_one(dev, label: str, fold: str, method: str, per_forward: dict, tau: float):
    """One 8-image request to a server of ``fold``: the batch it dispatched
    against the plain forward on the same input and the answer against its
    ``Predictor`` (both ``logits_close`` at ``tau``), launches against the
    batches it ran."""
    srv, ref_pred, warm = _server(fold, method)
    try:
        imgs = np.random.default_rng(13).integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)
        model = srv.pred.apply_fn
        _lib.reset_launch_counts()
        with recorded_forwards(srv.pred) as log:
            t0 = time.perf_counter()
            code, got = post_npy(srv.port, imgs)
            secs = time.perf_counter() - t0
        launches, stats = _server_launches(srv, per_forward, label)
        plain, plain_fails = dispatched_vs_plain(model, log, tau)
        spans = forward_spans(log)
        del log
    finally:
        srv.close()
    if code != 200:
        raise SmokeFailure(f"{label}: status {code}: {got}")
    want = ref_pred.predict_logits(imgs)
    ok, err, atol = logits_close(got, want, tau)
    emit({"phase": label, **_stage_card(dev), "method": method, "warmup_s": warm,
          "request_ms": secs * 1e3, "stats": stats, "launches": launches,
          "max_abs_err": err, "atol": atol, "tau": tau, "dispatched_vs_plain": plain,
          "device_span_ms": spans,
          "rows_bit_identical_to_predictor": int(sum(np.array_equal(g, w)
                                                     for g, w in zip(got, want))),
          "rows": len(imgs)})
    if plain_fails:
        raise SmokeFailure(f"{label}: the dispatched batch differs from the plain forward: "
                           + "; ".join(plain_fails))
    if not ok:
        raise SmokeFailure(f"{label}: served logits off the Predictor's by {err} > {atol}")
    return launches


def run_predict_cli(dev):
    """``python -m …cli.predict`` in a subprocess over 300 seeded 200x200
    BMPs (8-bit paletted and 24-bit) and a 16-image .npy: its CSV against
    ``Predictor`` over ``load_images`` of the same files."""
    import re
    import subprocess

    from inference_efficient_vision_models_tpu_torch.data.neudet import load_images

    rng = np.random.default_rng(14)
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "bmps")
        os.makedirs(d)
        paths = []
        for i in range(CLI_IMAGES):
            shape = (200, 200) if i % 2 == 0 else (200, 200, 3)
            paths.append(os.path.join(d, f"img_{i:03d}.bmp"))
            with open(paths[-1], "wb") as f:
                f.write(bmp_bytes(rng.integers(0, 256, shape, dtype=np.uint8)))
        npy = os.path.join(tmp, "batch.npy")
        np.save(npy, rng.integers(0, 256, (16, 224, 224, 3), dtype=np.uint8))
        out = os.path.join(tmp, "preds.csv")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", f"{PKG}.cli.predict", f"artifact={ARTIFACT}",
                            f"inputs={npy},{d}", f"output={out}"], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise SmokeFailure(f"predict_cli exited {r.returncode}:\n{r.stderr[-3000:]}")
        with open(out) as f:
            lines = f.read().splitlines()
        imgs = np.concatenate([np.load(npy), load_images(paths, (224, 224))])
        logits = Predictor.from_artifact(ARTIFACT, device="cuda").predict_logits(imgs)
    z = logits - logits.max(1, keepdims=True)
    probs = np.exp(z) / np.exp(z).sum(1, keepdims=True)
    names = [f"{npy}[{i}]" for i in range(16)] + paths
    rows = [ln.split(",") for ln in lines[1:]]
    same = (lines[0] == "image,rank,class_id,class_name,prob" and len(rows) == len(names)
            and [r[0] for r in rows] == names
            and [int(r[2]) for r in rows] == probs.argmax(1).tolist())
    prob_err = float(np.abs(np.array([float(r[4]) for r in rows])
                            - probs.max(1)).max()) if same else None
    rate = re.search(r"([0-9.]+) img/s", r.stderr)
    emit({"phase": "predict_cli", **_stage_card(dev), "images": len(names),
          "bmps": {"8bit_paletted": (CLI_IMAGES + 1) // 2, "24bit": CLI_IMAGES // 2},
          "rows_and_classes_equal": same, "max_prob_err": prob_err,
          "cli_images_per_s": float(rate.group(1)) if rate else None,
          "subprocess_wall_s": wall})
    if not same or prob_err > 1.5e-4:
        raise SmokeFailure(f"predict_cli: CSV differs from Predictor over load_images "
                           f"(rows/classes equal: {same}, prob err {prob_err})")


def run_augment(dev):
    """``apply_augment`` on the card against its CPU evaluation at the same
    draws, every option on, 256x224x224."""
    from inference_efficient_vision_models_tpu_torch.data.augment import (
        DEFAULTS, apply_augment, draw_augment)

    n, h, w = BATCH, 224, 224
    opts = {**DEFAULTS, "illum_gradient": 0.5, "noise": 0.05}
    x = torch.from_numpy(np.random.default_rng(15).integers(0, 256, (n, h, w, 3), dtype=np.uint8))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    draws = draw_augment(gen, n, h, w, opts)
    cpu = {k: tuple(t.cpu() if torch.is_tensor(t) else t for t in v) if isinstance(v, tuple)
           else v.cpu() for k, v in draws.items()}
    xg = x.cuda()
    got = apply_augment(xg, draws).cpu()
    ref = apply_augment(x, cpu)
    diff = (got.int() - ref.int()).abs()
    ms = time_ms(lambda: apply_augment(xg, draws))
    bound = 2 * x.numel() / HBM_BYTES_PER_S * 1e3  # uint8 in, uint8 out
    emit({"phase": "augment", **_stage_card(dev), "shape": [n, h, w, 3], "options": opts,
          "values": x.numel(), "values_differing": int((diff > 0).sum()),
          "max_abs_diff": int(diff.max()), "ms": ms, "bound_ms": bound})
    if int(diff.max()) > 1:
        raise SmokeFailure(f"augment: card and CPU differ by {int(diff.max())} at the same draws")


# --------------------------------------------------------------------------
# deployment export, the mesh at world size 1, the device profile
# --------------------------------------------------------------------------

R2_EXPORT_PER_FORWARD = PER_FORWARD  # A 8 + B 13, in the exported program as in eager


def export_check(phase: str, label: str, fold_dir: str, method: str, imgs: np.ndarray,
                 per_forward: dict, device_preprocess: bool = False) -> dict:
    """Export ``fold_dir``'s ``method`` on the card at ``imgs``' batch, load
    the container back on the card, and hold its logits on ``imgs`` to the
    eager ``load_quantized`` forward's, bit for bit; one exported call's
    launches (set to 0 just before, read just after) must be
    ``per_forward``. -> the record, with the module, the eager forward and
    the input under "_run" for timing."""
    from inference_efficient_vision_models_tpu_torch.export import export_quantized, load_program
    from inference_efficient_vision_models_tpu_torch.serving import load_quantized

    t0 = time.perf_counter()
    blob = export_quantized(fold_dir, method, batch_size=len(imgs), image_size=imgs.shape[1:3],
                            device_preprocess=device_preprocess)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    module, header = load_program(blob, device="cuda")
    load_s = time.perf_counter() - t0
    _, _, fn, pre = load_quantized(fold_dir, method, device="cuda",
                                   device_preprocess=device_preprocess)
    x = torch.from_numpy(pre(imgs) if pre is not None else imgs).cuda()
    with torch.no_grad():
        eager = fn(x).float()
        module(x)  # the first call builds the tensor maps of its constants
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        got = module(x)
        torch.cuda.synchronize()
        launches = dict(_lib.launches)
    rec = {"phase": phase, "label": label, "method": method, "batch": len(imgs),
           "input_layout": header["input_layout"], "input_shape": header["input_shape"],
           "container_bytes": len(blob), "export_s": export_s, "load_s": load_s,
           "equal_to_eager": bool(torch.equal(got, eager)),
           "max_abs_err": float((got - eager).abs().max()), "launches": launches,
           "expected_launches": per_forward}
    emit(rec)
    if not rec["equal_to_eager"] or launches != per_forward:
        raise SmokeFailure(f"{phase} {label}: exported logits equal eager {rec['equal_to_eager']} "
                           f"({rec['max_abs_err']}), launches {launches} != {per_forward}")
    rec["_run"], rec["_blob"] = (module, fn, x), blob
    return rec


def _with_ops(flag: bool):
    """The ops' switch, forced: eager calls go through ``torch.ops.ievm``
    (True) or launch directly (False); for timing the two routes only."""
    _lib.via_op = (lambda: True) if flag else torch.compiler.is_compiling


def run_export_r2(dev, test_imgs: np.ndarray) -> dict:
    """``export_r2``: the committed pruned ResNet18 exported as static_int8 at
    batch 256 (s2d and ``device_preprocess``) and batch 1, each container's
    logits on the r2 held-out images equal to eager bit for bit, kernels A and
    B launched inside the exported call; exported against eager forward ms
    at batch 256 and 1 (CUDA events, as the caller sees it, and device busy
    ms from ``profile_device_ops``); and the eager forward with its kernels
    through the ``ievm`` ops against direct launches, in turns (direct, ops,
    ops, direct): the ops' dispatch cost beside the run-to-run spread.
    ``export_cpu_platform``: the batch-1 container loaded on the CPU equals
    the port's CPU plain path on 3 images. -> the batch-256 s2d record."""
    from inference_efficient_vision_models_tpu_torch.export import load_exported
    from inference_efficient_vision_models_tpu_torch.metrics.device_profile import (
        profile_device_ops,
    )
    from inference_efficient_vision_models_tpu_torch.serving import load_quantized

    recs = {
        "b256_s2d": export_check("export_r2", "b256_s2d", ARTIFACT, "static_int8",
                                 test_imgs[:BATCH], R2_EXPORT_PER_FORWARD),
        "b256_nhwc": export_check("export_r2", "b256_device_preprocess", ARTIFACT,
                                  "static_int8", test_imgs[:BATCH], R2_EXPORT_PER_FORWARD,
                                  device_preprocess=True),
        "b1_s2d": export_check("export_r2", "b1_s2d", ARTIFACT, "static_int8", test_imgs[:1],
                               R2_EXPORT_PER_FORWARD),
    }
    times = {}
    with torch.no_grad():
        for b, key in ((BATCH, "b256_s2d"), (1, "b1_s2d")):
            module, fn, x = recs[key]["_run"]
            times[f"exported_ms_b{b}"] = time_ms(lambda: module(x))
            times[f"eager_ms_b{b}"] = time_ms(lambda: fn(x))
            times[f"exported_device_ms_b{b}"] = sum(
                r["avg_self_us"] for r in profile_device_ops(lambda: module(x), iters=3)) / 1e3
            times[f"eager_device_ms_b{b}"] = sum(
                r["avg_self_us"] for r in profile_device_ops(lambda: fn(x), iters=3)) / 1e3
            turns = []
            try:
                for flag in (False, True, True, False):
                    _with_ops(flag)
                    turns.append(time_ms(lambda: fn(x)))
            finally:
                _with_ops(False)
            times[f"eager_direct_ms_b{b}"] = [turns[0], turns[3]]
            times[f"eager_via_ops_ms_b{b}"] = [turns[1], turns[2]]
            times[f"op_dispatch_ms_b{b}"] = (turns[1] + turns[2] - turns[0] - turns[3]) / 2
            times[f"direct_spread_ms_b{b}"] = abs(turns[3] - turns[0])
    emit({"phase": "export_r2_times", **_stage_card(dev), **times,
          "calls_per_forward": sum(R2_EXPORT_PER_FORWARD.values())})

    # one container, two platforms: the batch-1 program on the CPU
    blob = recs["b1_s2d"]["_blob"]
    call, header = load_exported(blob, device="cpu")
    _, _, fn_cpu, pre = load_quantized(ARTIFACT, "static_int8", device="cpu")
    errs = []
    with torch.no_grad():
        for img in test_imgs[:3]:
            x = pre(img[None])
            errs.append(float(np.abs(call(x) - fn_cpu(torch.from_numpy(x)).numpy()).max()))
    emit({"phase": "export_cpu_platform", "platforms": header["platforms"], "images": len(errs),
          "container_bytes": len(blob), "max_abs_err": max(errs)})
    if max(errs) != 0.0:
        raise SmokeFailure(f"export_cpu_platform: the container's CPU logits differ from the "
                           f"CPU plain path by {max(errs)}")
    return recs


def run_export_families(dev) -> None:
    """``export_families``: EfficientNet-B0 ``static_int8_fused`` (kernels A,
    C) and ``static_int8`` (A, E) from the committed artifact, ViT-Tiny
    ``static_int8``, ``static_int8_bf16`` (A) from the committed artifact and
    ``dynamic_int8`` (A's dynamic route) of the seeded ViT-Tiny, each
    exported at batch 8, equal to eager bit for bit with its launches (the
    resnext26 case runs inside ``run_resnext``, on its seeded artifact)."""
    from inference_efficient_vision_models_tpu_torch.cli.quantize import _save_qmodel
    from inference_efficient_vision_models_tpu_torch.compress.quant import qvit
    from inference_efficient_vision_models_tpu_torch.models.vit import vit_spec

    imgs = np.random.default_rng(17).integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)
    export_check("export_families", "efficientnet_b0_fused", EFF_ARTIFACT, "static_int8_fused",
                 imgs, EFF_PER_FORWARD)
    export_check("export_families", "efficientnet_b0_unfused", EFF_ARTIFACT, "static_int8", imgs,
                 EFF_UNFUSED_PER_FORWARD)
    for method in ("static_int8", "static_int8_bf16"):
        export_check("export_families", f"vit_tiny_{method}", VIT_ARTIFACT, method, imgs,
                     VIT_PER_FORWARD)
    spec = vit_spec("vit_tiny_patch16_224", 6)
    with tempfile.TemporaryDirectory() as d:
        _save_qmodel(d, "dynamic_int8", qvit.convert_dynamic_int8(
            spec, vit_params_from_seed(spec, VIT_SEED)), spec)
        export_check("export_families", "vit_tiny_dynamic_int8", d, "dynamic_int8", imgs,
                     VIT_DYN_PER_FORWARD)


MESH_STEP = dict(model="resnet18", batch=32, pad=5, size=224, seed=0)


def _mesh_step(spec, weights, batch, mesh):
    """One fp32 CE step of ``weights`` on ``batch``, over ``mesh`` or not ->
    the loss, updated params, BN statistics and first moments, flat."""
    from inference_efficient_vision_models_tpu_torch.models import resnet as tr
    from inference_efficient_vision_models_tpu_torch.train import optim as to
    from inference_efficient_vision_models_tpu_torch.train import steps as ts

    p, s = tr.params_from_jax(weights[0], "cuda"), tr.params_from_jax(weights[1], "cuda")
    step = ts.make_train_step(spec, learning_rate=1e-3, compute_dtype="float32", mesh=mesh)
    p2, s2, opt, m = step(p, s, to.adamw_init(p), batch)
    out = {"loss": m["loss"].reshape(1), "acc": m["acc"].reshape(1), "n": m["n"].reshape(1)}
    for name, tree in (("p", p2), ("s", s2), ("mu", opt.mu)):
        out.update({f"{name}/{i}": t.detach().reshape(-1)
                    for i, t in enumerate(to.tree_leaves(tree))})
    return out


def run_mesh_world1(dev, test_imgs: np.ndarray) -> None:
    """``mesh_world1``: a one-rank NCCL group through a FileStore in a
    temporary directory (no port), ``make_mesh()``, one full-width ResNet18
    fp32 train step on a padded batch of 32 with and without the mesh (cuDNN
    deterministic: equal bit for bit), and ``Predictor(mesh=)`` on r2 equal
    to ``Predictor``; then the group is destroyed."""
    import torch.distributed as dist

    from inference_efficient_vision_models_tpu_torch.models.widths import resnet_spec
    from inference_efficient_vision_models_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
    )

    cfg = MESH_STEP
    spec = resnet_spec(cfg["model"], 6)
    weights = resnet_params_from_seed(spec, cfg["seed"])
    rng = np.random.default_rng(cfg["seed"])
    mask = np.ones(cfg["batch"], np.float32)
    mask[cfg["batch"] - cfg["pad"]:] = 0.0
    batch = (torch.from_numpy(rng.integers(0, 256, (cfg["batch"], cfg["size"], cfg["size"], 3),
                                           dtype=np.uint8)).cuda(),
             torch.from_numpy(rng.integers(0, 6, cfg["batch"])).cuda(),
             torch.from_numpy(mask).cuda())
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                               world_size=1)
        try:
            mesh = make_mesh()
            plain = _mesh_step(spec, weights, batch, None)
            meshed = _mesh_step(spec, weights, batch, mesh)
            again = _mesh_step(spec, weights, batch, None)
            step_equal = all(torch.equal(plain[k], meshed[k]) for k in plain)
            repeat_equal = all(torch.equal(plain[k], again[k]) for k in plain)
            step_err = max(float((plain[k] - meshed[k]).abs().max()) for k in plain)
            imgs = test_imgs[:BATCH]
            one = Predictor.from_artifact(ARTIFACT, "static_int8", device="cuda",
                                          batch_size=BATCH).predict_logits(imgs)
            dp = Predictor.from_artifact(ARTIFACT, "static_int8", batch_size=BATCH,
                                         mesh=mesh).predict_logits(imgs)
            rec = {"phase": "mesh_world1", **_stage_card(dev), "backend": dist.get_backend(),
                   "world_size": dist.get_world_size(),
                   "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), **cfg,
                   "train_step_equal": step_equal, "train_step_max_abs_err": step_err,
                   "no_mesh_repeat_equal": repeat_equal, "loss": float(plain["loss"]),
                   "predictor_equal": bool(np.array_equal(one, dp)), "images": len(imgs)}
        finally:
            dist.destroy_process_group()
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    emit(rec)
    if not (step_equal and rec["predictor_equal"]):
        raise SmokeFailure(f"mesh_world1: results differ with the mesh: {rec}")


def run_device_profile(dev, r2_rec: dict) -> None:
    """``device_profile``: ``profile_device_ops`` over the r2 batch-256 forward:
    its rows name the kernels' symbols, and their sum agrees with
    ``profile_window``'s busy ms of the same forward (two profiler runs:
    within 5%)."""
    from inference_efficient_vision_models_tpu_torch.metrics.device_profile import (
        profile_device_ops,
        profile_hlo_ops,
    )

    _, fn, x = r2_rec["_run"]
    iters = 3
    with torch.no_grad():
        rows = profile_device_ops(lambda: fn(x), iters=iters)
        window = profile_window(lambda: [fn(x) for _ in range(iters)], iters)
        ops = profile_hlo_ops(lambda: fn(x), iters=1)
    names = [r["name"] for r in rows]
    symbols = {k: any(sym in n for n in names)
               for k, sym in (("int8_matmul_requant", "matmul"), ("conv3x3_s1_int8", "conv3x3"))}
    busy = sum(r["avg_self_us"] for r in rows) / 1e3
    rec = {"phase": "device_profile", **_stage_card(dev), "iters": iters, "rows": len(rows),
           "device_ms_per_forward": busy,
           "profile_window_busy_ms_per_forward": window["device_busy_ms"] / iters,
           "kernel_symbols_found": symbols,
           "top": [{k: r[k] for k in ("name", "category", "occurrences", "avg_self_us",
                                      "self_percent")} for r in rows[:8]],
           "top_ops": [{k: r[k] for k in ("name", "expression", "avg_self_us")}
                       for r in ops[:5]]}
    emit(rec)
    ref = rec["profile_window_busy_ms_per_forward"]
    if not (all(symbols.values()) and abs(busy - ref) <= 0.05 * ref):
        raise SmokeFailure(f"device_profile: kernels {symbols}, {busy} ms against {ref}")


def kernels_line(rows, launches_by_path, aside=()):
    """One entry per kernel: time, plain time, bound and library time summed
    over its calls in one batch-256 forward of every path that runs it (a row
    stands for ``calls`` identical calls; rows off that forward are left
    out); launches summed over the counted runs of those paths. The paths in
    ``aside`` (a second model at the same shapes) add their launches, their
    largest error and an entry under ``paths``, and nothing to the sums; so
    do paths with launches and no rows (the HTTP server's, whose calls have
    the shapes of the served paths' rows), without an error of their own."""
    notes = {
        "fused_mbconv_block": "no PyTorch call computes a fused int8 MBConv block, and PyTorch "
                              "has no int8 convolution on CUDA",
        "conv3x3_s1_int8": "torch._int_mm at each call's (M, 9C, O): the GEMM only, the patch "
                           "matrix neither built nor timed (PyTorch has no int8 convolution on "
                           "CUDA)",
        "dense_gelu": "torch.addmm + F.gelu(approximate='none') in bf16 (two launches)",
        "dwconv_int8": "no PyTorch call computes an int8 depthwise convolution (PyTorch has no "
                       "int8 convolution on CUDA)",
        "gconv_int8": "no PyTorch call computes an int8 grouped convolution (PyTorch has no "
                      "int8 convolution on CUDA)",
    }
    kernels = []
    for k, (src, replaces) in KERNEL_INFO.items():
        every = [r for r in rows if r["kernel"] == k and r.get("in_forward", True)]
        mine = [r for r in every if r["path"] not in aside]
        n = [r.get("calls", 1) for r in mine]
        parts = [max(r["bytes_ms"], r["ops_ms"], r.get("dw_ms", 0.0)) for r in mine]
        by = {"bytes": sum(c * p for c, p, r in zip(n, parts, mine) if p == r["bytes_ms"]),
              "operations": sum(c * p for c, p, r in zip(n, parts, mine) if p != r["bytes_ms"])}
        libs = [r["library_ms"] for r in mine]
        summed = sorted({r["path"] for r in mine})
        # a path with no rows (the server's) runs shapes another path's rows time
        paths = sorted({r["path"] for r in every}
                       | {p for p, c in launches_by_path.items() if c.get(k)})

        def path_entry(p):
            its = [r for r in every if r["path"] == p]
            timed = [r for r in its if "ms" in r]
            return {"calls": sum(r.get("calls", 1) for r in its),
                    "timed_calls": sum(r.get("calls", 1) for r in timed),
                    "ms": sum(r.get("calls", 1) * r["ms"] for r in timed),
                    "launches": launches_by_path[p].get(k, 0),
                    **({"in_sums": False} if p in aside or not its else {})}

        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(launches_by_path[p].get(k, 0) for p in paths),
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": sum(c * r["ms"] for c, r in zip(n, mine)),
            "plain_ms": sum(c * r["plain_ms"] for c, r in zip(n, mine)),
            "bound_ms": sum(c * p for c, p in zip(n, parts)),
            "bound_by": max(by, key=by.get),
            "library_ms": None if None in libs else sum(c * v for c, v in zip(n, libs)),
            **({"library_note": notes[k]} if k in notes else {}),
            "per": f"one batch-{BATCH} forward of {' and '.join(summed)}: sum over its "
                   f"{sum(n)} calls",
            "paths": {p: path_entry(p) for p in paths},
        })
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = describe_device()
    if not dev["nvidia_smi"]:
        raise SmokeFailure("nvidia-smi did not report the card's name and power limit")
    t0 = time.perf_counter()
    _lib.build_all()
    emit({"phase": "build", "s": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                    for k, v in _lib.build_logs.items()}})
    emit({"phase": "device", **dev, "torch": torch.__version__, "cuda": torch.version.cuda})

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fails = check_odd_shapes(gen)

    from inference_efficient_vision_models_tpu_torch.compress.quant.qresnet import (
        load_static_int8,
    )

    model = load_static_int8(ARTIFACT, device="cuda")
    rows, f = check_and_time_main_shapes(model, gen)
    fails += f
    if fails:
        raise SmokeFailure("(a) kernels disagree with their plain versions:\n" + "\n".join(fails))

    golden = np.load(GOLDEN)
    golden_imgs = np.random.default_rng(int(golden["seed"])).integers(
        0, 256, tuple(golden["shape"]), dtype=np.uint8)
    requests, served, forwards, launches, wall = serve(
        ARTIFACT, golden_imgs, np.random.default_rng(1))
    emit({"phase": "serve", "requests": [len(r) for r in requests], "forwards": forwards,
          "launches": launches, "wall_s": wall})
    for r, out in zip(requests, served):
        if out.shape != (len(r), model.spec.num_classes) or not np.isfinite(out).all():
            raise SmokeFailure(f"served logits have shape {out.shape} or are not finite")
    for k in set(PER_FORWARD) | set(launches):  # (d)
        if launches.get(k, 0) != PER_FORWARD.get(k, 0) * forwards:
            raise SmokeFailure(f"(d) {k} launched {launches.get(k, 0)} times in {forwards} "
                               f"forwards, expected {PER_FORWARD.get(k, 0) * forwards}")

    # (b) kernel path (served) against the plain path on the card
    big = requests[-1]
    with torch.inference_mode():
        plain = np.concatenate([
            model(torch.from_numpy(big[i : i + BATCH]).cuda(), impl="plain").cpu().numpy()
            for i in range(0, len(big), BATCH)])
    d_b = float(np.abs(served[-1] - plain).max())
    agree_b = bool((served[-1].argmax(1) == plain.argmax(1)).all())
    emit({"phase": "b_kernel_vs_plain_forward", "images": len(big), "max_abs_err": d_b,
          "argmax_identical": agree_b})
    if not agree_b or not np.allclose(served[-1], plain, rtol=0.02, atol=0.02):
        raise SmokeFailure(f"(b) kernel-path logits differ from the plain path: {d_b}")

    # (c) served logits against the JAX package's golden logits
    ref = golden["logits"]
    errs_c = []
    for r, out in zip(requests, served):
        k = min(len(r), len(ref))
        errs_c.append(float(np.abs(out[:k] - ref[:k]).max()))
        if not ((out[:k].argmax(1) == ref[:k].argmax(1)).all()
                and np.allclose(out[:k], ref[:k], rtol=0.02, atol=0.02)):
            raise SmokeFailure(f"(c) served logits differ from the JAX golden logits: {errs_c}")
    emit({"phase": "c_served_vs_jax_golden", "images": len(ref), "max_abs_err": max(errs_c),
          "argmax_identical": True})

    # whole forward, device-resident raw uint8 input
    fwd = {}
    with torch.inference_mode():
        for b in (1, BATCH):
            x = torch.from_numpy(np.random.default_rng(2).integers(
                0, 256, (b, *golden_imgs.shape[1:]), dtype=np.uint8)).cuda()
            fwd[f"forward_ms_b{b}"] = time_ms(lambda: model(x))
            fwd[f"plain_forward_ms_b{b}"] = time_ms(lambda: model(x, impl="plain"))
        torch.cuda.synchronize()
        fwd["images_per_s_b256"] = BATCH / fwd[f"forward_ms_b{BATCH}"] * 1e3
        fwd["served_images_per_s"] = sum(len(r) for r in requests) / wall
        emit({"phase": "forward", **fwd})
        emit({"phase": "profile_b256", **profile_forward(model, x)})
    del model, x

    eff_rows, eff_launches = run_efficientnet(gen)
    e_rows, e_launches = run_effnet_e_shapes(gen, np.random.default_rng(5))
    vit_rows, vit_launches = run_vit(gen)
    run_serve_rates(dev)
    server_launches = {
        "server_resnet18": run_server_r2(dev),
        "server_efficientnet_b0": run_server_one(dev, "server_eff", EFF_ARTIFACT,
                                                 "static_int8_fused", EFF_PER_FORWARD, TAU_B),
        "server_vit_tiny_int8_bf16": run_server_one(dev, "server_vit", VIT_ARTIFACT,
                                                    "static_int8_bf16", VIT_PER_FORWARD,
                                                    VIT_TAU_B),
    }
    run_predict_cli(dev)
    run_augment(dev)
    calib, test = r2_data()
    r2_exports = run_export_r2(dev, test[0])
    run_export_families(dev)
    run_mesh_world1(dev, test[0])
    run_device_profile(dev, r2_exports["b256_s2d"])
    del r2_exports
    run_float_r2_eval(dev, test)
    run_convert_r2(dev, calib, test)
    run_train_step_golden(dev)
    run_train_step_golden(dev, EFF_TRAIN_STEP, EFF_TRAIN_GOLDEN, EFF_TRAIN_LIMITS,
                          "effnet_train_step_golden")
    run_convert_effnet(dev)
    mbv2_rows, mbv2_launches = run_mbv2(dev, gen, np.random.default_rng(7))
    run_train_step_golden(dev, VIT_TRAIN_STEP, VIT_TRAIN_GOLDEN, VIT_TRAIN_LIMITS,
                          "vit_train_step_golden")
    run_qat_step_golden(dev)
    run_convert_vit(dev)
    vit_dyn_rows, vit_dyn_launches = run_vit_dynamic(dev, gen)
    vit_dyn_launches.update(run_vit_head_pruned(dev))
    rx_rows, rx_launches = run_resnext(dev, gen, np.random.default_rng(11))
    with tempfile.TemporaryDirectory() as root:
        chain = run_training(dev, root)
        # the INT8 ResNet18 the chain made: each kernel call of its forward
        # against the plain version, bit for bit; timed where r2's calls
        # have not the same shapes
        fresh = load_static_int8(chain["quant_dir"], device="cuda")
        pipe_rows, fails = check_and_time_main_shapes(fresh, gen, "resnet18_pipeline",
                                                      timed_rows=rows)
        if fails:
            raise SmokeFailure("(a) kernels disagree with their plain versions on the stage "
                               "chain's model:\n" + "\n".join(fails))
        del fresh
        eff_pipe_rows, eff_pipe_launches = run_effnet_chain_int8(dev, gen,
                                                                 chain["eff"]["quant_dir"])
        mbv2_pipe_rows, mbv2_pipe_launches = run_mbconv_chain_int8(
            dev, gen, chain["mbv2"]["quant_dir"], "mobilenet_v2", "mbv2", {
                "static_int8": MBV2_UNFUSED_PER_FORWARD,
                "static_int8_fused": MBV2_FUSED_PER_FORWARD,
                "static_int8_mixed": MBV2_MIXED_PER_FORWARD})
        vit_pipe_rows, vit_pipe_launches = run_vit_chain_int8(dev, gen, chain["vit"]["quant_dir"])
        rx_pipe_rows, rx_pipe_launches = run_rx_chain_int8(dev, gen, chain["rx"]["quant_dir"])
        run_dynamic_fc_route(dev, gen, {"resnet18": chain["quant_dir"],
                                        "efficientnet_b0": chain["eff"]["quant_dir"],
                                        "mobilenet_v2": chain["mbv2"]["quant_dir"],
                                        "resnext26_32x4d": chain["rx"]["quant_dir"]})
        run_w4a16_serve(dev, {"resnet18": chain["quant_dir"],
                              "efficientnet_b0": chain["eff"]["quant_dir"],
                              "mobilenet_v2": chain["mbv2"]["quant_dir"],
                              "vit_tiny": chain["vit"]["quant_dir"],
                              "resnext26_32x4d": chain["rx"]["quant_dir"]})
    emit({"kernels": kernels_line(rows + eff_rows + e_rows + vit_rows + pipe_rows + eff_pipe_rows
                                  + mbv2_rows + mbv2_pipe_rows + vit_dyn_rows + vit_pipe_rows
                                  + rx_rows + rx_pipe_rows,
                                  {"resnet18": launches, "efficientnet_b0": eff_launches,
                                   "efficientnet_b0_unfused": e_launches,
                                   "resnet18_pipeline": chain["launches"],
                                   "efficientnet_b0_pipeline": chain["eff"]["launches"],
                                   "mobilenet_v2_pipeline": chain["mbv2"]["launches"],
                                   "vit_tiny_pipeline": chain["vit"]["launches"],
                                   "resnext26_pipeline": chain["rx"]["launches"],
                                   "resnet18_accuracy_tools": chain["tools_launches"],
                                   **eff_pipe_launches, **mbv2_pipe_launches, **mbv2_launches,
                                   **vit_launches, **vit_dyn_launches, **vit_pipe_launches,
                                   **rx_launches, **rx_pipe_launches, **server_launches},
                                  aside={"resnet18_pipeline", "efficientnet_b0_pipeline",
                                         "mobilenet_v2_pipeline", "vit_tiny_pipeline",
                                         "resnext26_pipeline", "resnet18_accuracy_tools"})})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"], "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
