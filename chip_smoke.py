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
   for bit, at the 16 block shapes (batch 256) and at odd shapes, with each
   block's three launches timed apart (``port_block_launches.launch_ms``),
   kernel A at its 3 shapes (batch 256 and 1);
   (a') every block's int8 output on 8 golden images with teacher forcing
   (kernel and plain fed the same plain-path input), the check that decides
   correctness; (c') every block against the JAX package's own block outputs
   (``testdata``); serving as above with (d) 16 fused-block calls and 3
   int8-matmul launches per forward, (b) and (c) with logit tolerances
   relative to the logit scale;
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
   default four methods, 256 calibration images) through the port's stage
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
   a batch-256 forward of each path with ``torch.profiler``.

Results go to stdout as JSON lines; the line before the last gives the card
as nvidia-smi reports it and the last is ``{"ok": true, "device": ...}``.
Any failed check exits non-zero without that line; so does a machine with no
GPU. Needs one card.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import tempfile
import time

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
    int8_matmul_requant,
    int8_matmul_requant_plain,
    pack_weight,
    to_device_packed,
)
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
}
PLAIN = {"int8_matmul_requant": int8_matmul_requant_plain,
         "conv3x3_s1_int8": conv3x3_s1_int8_plain}
KERNEL = {"int8_matmul_requant": int8_matmul_requant, "conv3x3_s1_int8": conv3x3_s1_int8}
PER_FORWARD = {"int8_matmul_requant": 8, "conv3x3_s1_int8": 13}
# EfficientNet-B0: stem, head conv and fc on kernel A; 16 fused blocks with SE,
# each three launches (expand+depthwise, SE gate, project)
EFF_PER_FORWARD = {"int8_matmul_requant": 3, "fused_mbconv_block": 16 * 3}
# ViT-Tiny int8 (either carrier): patch embed, 12 x (qkv, proj, mlp1, mlp2), head
VIT_PER_FORWARD = {"int8_matmul_requant": 50}
# float ViT-Tiny with fused_mlp: one mlp1 + GELU per block
VIT_FLOAT_PER_FORWARD = {"dense_gelu": 12}
BATCH = 256
RUNS = 25
STEP_RUNS = 50  # timed train steps of each model, in a row
SPIN_CYCLES = 2_000_000  # about 1 ms of GPU clock: longer than the host takes to enqueue a call
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
FP32_FMA_PER_S = 33.5e12    # H100 SXM: 67 TFLOP/s fp32 outside the tensor cores, 2 per FMA
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


def leaf_sums(tree) -> np.ndarray:
    """float64 sum of every leaf, in the tree's order: a fingerprint that makes
    a drifting copy of the parameters fail loudly."""
    if isinstance(tree, dict):
        return np.concatenate([leaf_sums(v) for v in tree.values()])
    return np.array([np.sum(np.asarray(tree), dtype=np.float64)])


def flat_raw(tree, prefix=""):
    """A nested dict of arrays -> {"/a/b": numpy array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_raw(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


_ACT_QPARAMS = ("out_scale", "out_zp", "in_scale", "in_zp")


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


def compare_conversion(qmodel, ref: dict, limits=CONVERT_LIMITS) -> dict:
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
            lo = min(ref["observers"][_tap_of(k)][0], 0.0)
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
                 calls: int = 1, timed: bool = True):
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
            "plain_ms": time_ms(lambda: int8_matmul_requant_plain(*args, **kw), spin=True),
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


def profile_forward(model, x: torch.Tensor, iters: int = 3):
    """Device time by kernel over ``iters`` forwards (torch.profiler), and the
    device's idle share of that window's host wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "forwards": iters, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "launches_per_forward": sum(e.count for e in kernels) / iters,
        "idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
        "top": [{"kernel": e.key[:100], "ms_per_forward": e.self_device_time_total / 1e3 / iters,
                 "calls_per_forward": e.count / iters} for e in top],
    }


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


def eff_block_inputs(model, b: int, gen: torch.Generator):
    """(name, x, kernel, stride, residual) at every block of the served model,
    batch b, int8 inputs spread around each block's input zero point."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.fusedpath import block_plan

    h = model.q["stem"]["e"].shape[1]
    out = []
    for name, k, stride, residual in block_plan(model.spec):
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
    and 96, Cin of 16, k5 at stride 2."""
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
    emit({"phase": "eff_a_odd_shapes", "checks": len(cases), "max_abs_err": err_max,
          "failed": fails})
    return fails


def eff_kernel_a_calls(model, b: int):
    """Kernel A's three calls of one forward at batch b: stem (im2col patches,
    K = 27), the head conv (K = 320) and the fc (float input)."""
    from inference_efficient_vision_models_tpu_torch.compress.quant.fusedpath import block_plan

    q = model.q
    st, last, fc = q["stem"], q["last"], q["fc"]
    hs = hl = st["e"].shape[1]
    for _, _, stride, _ in block_plan(model.spec):
        hl = (hl - 1) // stride + 1
    return [
        ("int8_matmul_requant", "stem", (b * hs * hs, st["w"].k), torch.int8, st,
         dict(in_scale=1.0, in_zp=128)),
        ("int8_matmul_requant", "last", (b * hl * hl, last["w"].k), torch.int8, last,
         dict(in_scale=last["in_scale"], in_zp=last["in_zp"])),
        ("int8_matmul_requant", "fc", (b, fc["w"].k), torch.float32, fc,
         dict(in_scale=fc["in_scale"], in_zp=fc["in_zp"])),
    ]


def eff_check_and_time_main_shapes(model, gen: torch.Generator):
    """(a) kernel C at the 16 block shapes, bit for bit, and kernel A at its
    3, batch 256, then the timings: each block's three launches apart
    (device time, torch.profiler) beside the whole call and its bound."""
    rows, fails = [], []
    for name, x, k, stride, residual in eff_block_inputs(model, BATCH, gen):
        packed = model.qf[name]
        kw = dict(kernel=k, stride=stride, act="silu", x_res=x if residual else None)
        ok, err, exact = compare_block(fused_mbconv_block(x, packed, **kw),
                                       fused_mbconv_block_plain(x, packed, **kw), 1.0)
        if not ok:
            fails.append(f"fused_mbconv_block {name} {tuple(x.shape)}: max abs err {err}, "
                         f"exact {exact}")
        nbytes, ops, dw = block_cost(x, packed, k, stride, residual)
        rows.append({
            "path": "efficientnet_b0", "kernel": "fused_mbconv_block", "call": name,
            "x": list(x.shape), "ce": packed["wdw"].shape[-1], "n": packed["wp"].n,
            "k": k, "stride": stride, "max_abs_err": err, "exact": exact,
            "ms": time_ms(lambda: fused_mbconv_block(x, packed, **kw), spin=True),
            "plain_ms": time_ms(lambda: fused_mbconv_block_plain(x, packed, **kw), spin=True),
            "bytes": nbytes, "ops": ops, "dw_macs": dw,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / INT8_OPS_PER_S * 1e3,
            "dw_ms": dw / FP32_FMA_PER_S * 1e3, "library_ms": None,
            "launch_ms": launch_ms(lambda: fused_mbconv_block(x, packed, **kw)),
        })
        emit({"phase": "eff_a_main_shape", **rows[-1]})
        del x
    mine = [r for r in rows if r["kernel"] == "fused_mbconv_block"]
    emit({"phase": "eff_c_launches", "batch": BATCH,
          "blocks": [{"block": r["call"], **r["launch_ms"], "ms": r["ms"],
                      "bound_ms": max(r["bytes_ms"], r["ops_ms"], r["dw_ms"])} for r in mine],
          "total": {k: sum(r["launch_ms"][k] for r in mine) for k in LAUNCHES},
          "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"], r["dw_ms"]) for r in mine)})
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
    from inference_efficient_vision_models_tpu_torch.compress.quant.fusedpath import (
        block_plan,
        stem_int8,
    )

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
    from inference_efficient_vision_models_tpu_torch.compress.quant.fusedpath import block_plan

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
        return lambda u8: vit.apply(spec, params, normalize_images(u8), compute_dtype=dtype,
                                    fused_mlp=True, impl=impl)

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
# stages 1-2: the float ResNet, a training step against the JAX golden, and
# the teacher and KD stage CLIs (cuDNN convs and cuBLAS GEMMs: no custom kernel)
# --------------------------------------------------------------------------


def train_step_batch():
    """The train-step golden's batch: uint8 images from a seed, labels 0..5."""
    rng = np.random.default_rng(TRAIN_STEP["image_seed"])
    b, size = TRAIN_STEP["batch"], TRAIN_STEP["size"]
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
                       nu) -> dict:
    """What the train-step golden keeps of one step (trees in the JAX layout):
    the loss, the logits, each gradient leaf's L2 norm, each BatchNorm
    running statistic's sum beside its sum of magnitudes (the scale it is
    held to), each AdamW moment leaf's L2 norm, and the update
    ``(after - before) / lr`` of every leaf of at most ``UPDATE_LEAF_MAX``
    values, whole, beside the fp32 rounding of those parameters in units of
    lr; leaves in sorted-path order."""
    g, st = _flat_sorted(grads), _flat_sorted(new_state)
    p0, p1 = _flat_sorted(before), _flat_sorted(after)
    kept = [k for k in p0 if p0[k].size <= UPDATE_LEAF_MAX]
    return {f"{role}_loss": np.float64(loss), f"{role}_logits": np.asarray(logits, np.float32),
            f"{role}_grad_names": np.array(list(g)),
            f"{role}_grad_norms": np.array([np.linalg.norm(v) for v in g.values()]),
            f"{role}_bn_names": np.array(list(st)),
            f"{role}_bn_sums": np.array([v.sum() for v in st.values()]),
            f"{role}_bn_abs_sums": np.array([np.abs(v).sum() for v in st.values()]),
            f"{role}_moment_names": np.array(list(_flat_sorted(mu))),
            f"{role}_mu_norms": np.array([np.linalg.norm(v) for v in _flat_sorted(mu).values()]),
            f"{role}_nu_norms": np.array([np.linalg.norm(v) for v in _flat_sorted(nu).values()]),
            f"{role}_update_names": np.array(kept),
            f"{role}_update_slack_over_lr": np.float64(2 * np.spacing(np.float32(
                max(np.abs(p0[k]).max() for k in kept) + 4 * TRAIN_STEP["lr"]))
                / TRAIN_STEP["lr"]),
            f"{role}_update_over_lr": np.concatenate(
                [((p1[k] - p0[k]) / TRAIN_STEP["lr"]).ravel() for k in kept]).astype(np.float32)}


def port_train_step(weights: dict, batch, device) -> dict:
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
    specs = {r: make_spec(TRAIN_STEP[r], 6) for r in ("teacher", "student")}

    def model(r):
        return tuple(params_from_jax(specs[r], t, device) for t in weights[r])

    def to_jax(r, tree):
        return params_to_jax(specs[r], tree)

    kd = dict(alpha=TRAIN_STEP["alpha"], temperature=TRAIN_STEP["temperature"])
    step = {"teacher": make_train_step(specs["teacher"], learning_rate=TRAIN_STEP["lr"],
                                       compute_dtype="float32"),
            "student": make_kd_train_step(specs["student"], specs["teacher"],
                                          learning_rate=TRAIN_STEP["lr"],
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


def _rel(mine, ref) -> float:
    return float((np.abs(mine - ref) / np.maximum(np.abs(ref), 1e-30)).max())


def compare_train_step(role: str, got, golden, limits=None) -> dict:
    """One role's step against the golden: the loss's relative deviation, the
    logits' over the logit scale, the largest relative deviation of a
    gradient leaf's norm, of a BN statistic's sum (over its sum of
    magnitudes) and of a moment leaf's norm, and the largest deviation of a
    kept leaf's update in units of lr; with ``limits`` also whether each
    holds (the update's limit plus the parameters' rounding)."""
    mine = train_step_metrics(role, *got)
    for k in ("grad_names", "bn_names", "moment_names", "update_names"):
        if list(mine[f"{role}_{k}"]) != list(golden[f"{role}_{k}"]):
            raise SmokeFailure(f"{role}: the {k} differ from the golden's")
    dev = {
        "loss_rel": _rel(mine[f"{role}_loss"], golden[f"{role}_loss"]),
        "logits_over_scale": float(np.abs(mine[f"{role}_logits"] - golden[f"{role}_logits"]).max()
                                   / np.abs(golden[f"{role}_logits"]).max()),
        "grad_norm_rel": _rel(mine[f"{role}_grad_norms"], golden[f"{role}_grad_norms"]),
        "bn_sum_over_abs_sum": float((np.abs(mine[f"{role}_bn_sums"] - golden[f"{role}_bn_sums"])
                                      / golden[f"{role}_bn_abs_sums"]).max()),
        "mu_norm_rel": _rel(mine[f"{role}_mu_norms"], golden[f"{role}_mu_norms"]),
        "nu_norm_rel": _rel(mine[f"{role}_nu_norms"], golden[f"{role}_nu_norms"]),
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


def run_train_step_golden(dev):
    """One fp32 CE step of ResNet50 and one KD step of ResNet18 against it
    (batch 8 at 224, TF32 off), from the seeded weights, against the JAX
    package's golden."""
    from inference_efficient_vision_models_tpu_torch.models.registry import make_spec

    golden = np.load(TRAIN_GOLDEN)
    weights = {}
    for role in ("teacher", "student"):
        weights[role] = resnet_params_from_seed(make_spec(TRAIN_STEP[role], 6), TRAIN_STEP["seed"])
        if not (np.array_equal(leaf_sums(weights[role][0]), golden[f"{role}_param_sums"])
                and np.array_equal(leaf_sums(weights[role][1]), golden[f"{role}_state_sums"])):
            raise SmokeFailure("resnet_params_from_seed no longer gives the golden's weights")
    got = port_train_step(weights, train_step_batch(), "cuda")
    fails = []
    for role in ("teacher", "student"):
        d = compare_train_step(role, got[role], golden, TRAIN_LIMITS)
        emit({"phase": "train_step_golden", **_stage_card(dev), "role": role,
              "model": TRAIN_STEP[role], "loss": got[role][0], "limits": TRAIN_LIMITS, **d})
        if not d["ok"]:
            fails.append(role)
    if fails:
        raise SmokeFailure(f"train_step_golden: {fails} outside the limits")


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


def bf16_train_steps():
    """The bf16 teacher step (ResNet50, batch 64) and KD step (ResNet18 from
    it, batch 32) as the stage CLIs run them (the train loop's steps, seeded
    weights, random images), each after 3 warm-up steps: [(name, step, batch)]."""
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

    def teacher_step(b):
        m["teacher"][:] = t_step(*m["teacher"], b)[:3]

    def kd_step(b):
        m["student"][:] = k_step(*m["student"], *m["teacher"][:2], b)[:3]

    steps = [("teacher", teacher_step, batch(64)), ("kd", kd_step, batch(32))]
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
        result = stage_clis(dev, root)
        profile_train_steps(dev, steps)
    finally:
        q.put(result)


def stage_clis(dev, root):
    """Stages 1-4 through the port's CLIs on the card, into ``root``:
    ResNet50 teacher (bf16, batch 64, fold 0, one epoch), ResNet18 student
    distilled from it (batch 32, alpha 0.5, T 4), the student pruned (l2,
    ratio 0.11, round_to 8, one fine-tune epoch) and quantized (the default
    four methods, 256 calibration images), ``choice=2`` after each. The
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
    return quantize_cli(dev, root, common)


def _seeded_shapes(fold_dir: str):
    """Seeded weights of the checkpoint's own spec: the JAX layout's shapes."""
    from inference_efficient_vision_models_tpu_torch.core import artifacts
    from inference_efficient_vision_models_tpu_torch.models.registry import spec_from_dict

    return resnet_params_from_seed(spec_from_dict(artifacts.load_spec_dict(fold_dir)), 0)


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
    methods, 256 calibration images, batch 32) and its ``choice=2``; the
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

    methods = QuantConfig(artifacts_root=root).methods
    argv = common + ["model_type='pruned'", "pruning_exp_name='smoke'",
                     "calibration_images=256"]
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
    return {"launches": launches, "quant_dir": fold_dir}


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


def kernels_line(rows, launches_by_path, aside=()):
    """One entry per kernel: time, plain time, bound and library time summed
    over its calls in one batch-256 forward of every path that runs it (a row
    stands for ``calls`` identical calls; rows off that forward are left
    out); launches summed over the counted runs of those paths. The paths in
    ``aside`` (a second model at the same shapes) add their launches, their
    largest error and an entry under ``paths``, and nothing to the sums."""
    notes = {
        "fused_mbconv_block": "no PyTorch call computes a fused int8 MBConv block, and PyTorch "
                              "has no int8 convolution on CUDA",
        "conv3x3_s1_int8": "torch._int_mm at each call's (M, 9C, O): the GEMM only, the patch "
                           "matrix neither built nor timed (PyTorch has no int8 convolution on "
                           "CUDA)",
        "dense_gelu": "torch.addmm + F.gelu(approximate='none') in bf16 (two launches)",
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
        paths = sorted({r["path"] for r in every})

        def path_entry(p):
            its = [r for r in every if r["path"] == p]
            timed = [r for r in its if "ms" in r]
            return {"calls": sum(r.get("calls", 1) for r in its),
                    "timed_calls": sum(r.get("calls", 1) for r in timed),
                    "ms": sum(r.get("calls", 1) * r["ms"] for r in timed),
                    "launches": launches_by_path[p].get(k, 0),
                    **({"in_sums": False} if p in aside else {})}

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
    vit_rows, vit_launches = run_vit(gen)
    calib, test = r2_data()
    run_float_r2_eval(dev, test)
    run_convert_r2(dev, calib, test)
    run_train_step_golden(dev)
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
    emit({"kernels": kernels_line(rows + eff_rows + vit_rows + pipe_rows,
                                  {"resnet18": launches, "efficientnet_b0": eff_launches,
                                   "resnet18_pipeline": chain["launches"], **vit_launches},
                                  aside={"resnet18_pipeline"})})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"], "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
