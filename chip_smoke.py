#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU, end to end, on both served paths.

Run from the repository root: ``python3 chip_smoke.py``. It

1. builds the CUDA kernels from ``inference_efficient_vision_models_tpu_torch/csrc``
   (nvcc for sm_90a, one process per source, all at once, at first use) and
   prints the card's name and power limit;
2. ResNet18 path (the committed static-INT8 pruned ResNet18):
   (a) holds each kernel against its plain PyTorch version on the card, at
   every shape the served model gives it (batch 256) and at odd shapes;
   serves the artifact through ``Predictor.from_artifact`` (requests of 1, 8
   and 2x256 images) with the launch counters set to 0 just before and read
   just after, and checks (d) 13 direct-3x3 and 8 int8-matmul launches per
   forward, (b) the logits against the plain path on the card and (c) the
   JAX package's golden logits committed in ``testdata/``;
3. EfficientNet-B0 path (the committed static-INT8 EfficientNet-B0, served by
   the fused-MBConv executor): (a) kernel C against its plain version at the
   16 block shapes (batch 256) and at odd shapes, kernel A at its 3 shapes;
   (a') every block's int8 output on 8 golden images with teacher forcing
   (kernel and plain fed the same plain-path input), the check that decides
   correctness; (c') every block against the JAX package's own block outputs
   (``testdata``); serving as above with (d) 16 fused-block calls and 3
   int8-matmul launches per forward, (b) and (c) with logit tolerances
   relative to the logit scale;
4. times each kernel at its serving shapes beside its plain version, its
   bound and a library call where one exists, and each forward at batch 1
   and 256 with CUDA events (median of 25 runs after warm-up), and profiles
   a batch-256 forward with ``torch.profiler``.

Results go to stdout as JSON lines; the line before the last gives the card
as nvidia-smi reports it and the last is ``{"ok": true, "device": ...}``.
Any failed check exits non-zero without that line; so does a machine with no
GPU. Needs one card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from inference_efficient_vision_models_tpu_torch.ops import (
    _lib,
    conv3x3_s1_int8,
    conv3x3_s1_int8_plain,
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

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(ROOT, "artifacts", "bench", "quantization", "r2", "fold_0")
TESTDATA = os.path.join(ROOT, "inference_efficient_vision_models_tpu_torch", "testdata")
GOLDEN = os.path.join(TESTDATA, "r2_fold0_jax_logits.npz")
EFF_ARTIFACT = os.path.join(TESTDATA, "effnet_b0_int8")
EFF_GOLDEN = os.path.join(TESTDATA, "effnet_b0_jax_logits.npz")
PKG = "inference_efficient_vision_models_tpu_torch"
KERNEL_INFO = {
    "int8_matmul_requant": (f"{PKG}/csrc/int8_matmul.cu",
                            "inference_efficient_vision_models_tpu/ops/int8_matmul.py:87"),
    "conv3x3_s1_int8": (f"{PKG}/csrc/conv3x3.cu",
                        "inference_efficient_vision_models_tpu/ops/conv3x3.py:67"),
    "fused_mbconv_block": (f"{PKG}/csrc/fused_mbconv.cu",
                           "inference_efficient_vision_models_tpu/ops/fused_mbconv.py:222"),
}
PLAIN = {"int8_matmul_requant": int8_matmul_requant_plain,
         "conv3x3_s1_int8": conv3x3_s1_int8_plain}
KERNEL = {"int8_matmul_requant": int8_matmul_requant, "conv3x3_s1_int8": conv3x3_s1_int8}
PER_FORWARD = {"int8_matmul_requant": 8, "conv3x3_s1_int8": 13}
# EfficientNet-B0: stem, head conv and fc on kernel A; 16 fused blocks with SE,
# each three launches (expand+depthwise, SE gate, project)
EFF_PER_FORWARD = {"int8_matmul_requant": 3, "fused_mbconv_block": 16 * 3}
BATCH = 256
RUNS = 25
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
FP32_FMA_PER_S = 33.5e12    # H100 SXM: 67 TFLOP/s fp32 outside the tensor cores, 2 per FMA
# EfficientNet logits: |served - reference| <= TAU * max|reference|, and the
# same argmax where the reference's top-2 margin exceeds twice that (PERF.md
# gives the measured values these were set from)
TAU_B = 0.05
TAU_C = 0.26


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, runs: int = RUNS, warm: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(runs)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def compare(got: torch.Tensor, ref: torch.Tensor):
    """-> (ok, max_abs_err) at the port's kernel tolerances: int8 within one
    quantum and >= 99% exact; fp32 rtol 1e-5 / atol 1e-3; bf16 within one
    bf16 ulp or that atol, whichever is larger."""
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
        return bool((d <= ulp.clamp_min(1e-3)).all()), err
    return bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-3)), err


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
            if stride == 1:
                calls.append(("conv3x3_s1_int8", f"{tag}.conv1", (b, h, h, cin), torch.int8, c1,
                              dict(in_scale=in_s, in_zp=in_z, **rq)))
            else:
                calls.append(("int8_matmul_requant", f"{tag}.conv1", (b * ho * ho, 9 * cin),
                              torch.int8, c1, dict(in_scale=in_s, in_zp=in_z, **rq)))
            calls.append(("conv3x3_s1_int8", f"{tag}.conv2", (b, ho, ho, inner), torch.int8, c2,
                          dict(in_scale=c1["out_scale"], in_zp=c1["out_zp"])))
            if "down" in blk:
                calls.append(("int8_matmul_requant", f"{tag}.down", (b * ho * ho, cin),
                              torch.int8, blk["down"], dict(in_scale=in_s, in_zp=in_z)))
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


def cost(kernel: str, x: torch.Tensor, leaf, kw):
    """(bytes, int8 ops) the call must move and do: each input read once,
    each output written once; 2 ops per multiply-add of the GEMM."""
    n = leaf["w"].n
    if kernel == "conv3x3_s1_int8":
        m, k = x.numel() // x.shape[-1], 9 * x.shape[-1]
    else:
        m, k = x.shape
    out_bytes = 1 if kw.get("out_scale") is not None else 4
    nbytes = x.numel() * x.element_size() + k * n + 3 * 4 * n + m * n * out_bytes
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
    return time_ms(lambda: torch._int_mm(x8, w8)), None


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def check_odd_shapes(gen: torch.Generator):
    """(a) at shapes off the served path: ragged M/K/N, C not a multiple of 4,
    float inputs, GELU variants, bf16 output."""
    errs, fails = {k: 0.0 for k in KERNEL}, []

    def leaf(shape):
        wq = torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        n = shape[-1]
        return {"w": pack_weight(wq),
                "w_scale": torch.rand(n, generator=gen, device="cuda") * 0.009 + 0.001,
                "bias": torch.randn(n, generator=gen, device="cuda"),
                "w_sum": wq.reshape(-1, n).int().sum(0, dtype=torch.int32)}

    cases = []
    for (m, k, n) in [(77, 56, 6), (300, 72, 160), (1000, 504, 112), (333, 13, 37)]:
        lf = leaf((k, n))
        xi = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        xf = torch.randn((m, k), generator=gen, device="cuda") * 3
        for x, kw in [(xi, dict(relu=True, out_scale=0.07, out_zp=122)),
                      (xi, dict(act="gelu")),
                      (xi, dict(act="gelu_tanh", out_dtype=torch.bfloat16)),
                      (xf, dict(act="gelu")),
                      (xf.bfloat16(), dict(act="relu", out_scale=0.05, out_zp=3)),
                      (xf, dict(out_dtype=torch.bfloat16))]:
            cases.append(("int8_matmul_requant", f"{m}x{k}x{n}", x, lf,
                          dict(in_scale=0.05, in_zp=113, **kw)))
    for (n, h, w, c, o) in [(2, 12, 14, 8, 72), (3, 7, 9, 72, 56), (2, 5, 6, 3, 8)]:
        lf = leaf((3, 3, c, o))
        x = torch.randint(-128, 128, (n, h, w, c), generator=gen, device="cuda",
                          dtype=torch.int8)
        for kw in [dict(), dict(relu=True, out_scale=0.05, out_zp=110)]:
            cases.append(("conv3x3_s1_int8", f"{n}x{h}x{w}x{c}->{o}", x, lf,
                          dict(in_scale=0.03, in_zp=150, **kw)))
    for kernel, label, x, lf, kw in cases:
        args = (x, lf["w"], lf["w_scale"], lf["bias"], lf["w_sum"])
        ok, err = compare(KERNEL[kernel](*args, **kw), PLAIN[kernel](*args, **kw))
        errs[kernel] = max(errs[kernel], err)
        if not ok:
            fails.append(f"{kernel} {label} {kw}: max abs err {err}")
    emit({"phase": "a_odd_shapes", "checks": len(cases), "max_abs_err": errs, "failed": fails})
    return fails


def check_and_time_main_shapes(model, gen: torch.Generator):
    """(a) at every served shape (batch 256), then the timings."""
    rows, fails = [], []
    for kernel, label, shape, dtype, leaf, kw in main_path_calls(model, BATCH):
        x = make_input(shape, dtype, kw["in_zp"], gen)
        args = (x, leaf["w"], leaf["w_scale"], leaf["bias"], leaf["w_sum"])
        ok, err = compare(KERNEL[kernel](*args, **kw), PLAIN[kernel](*args, **kw))
        if not ok:
            fails.append(f"{kernel} {label} {tuple(shape)}: max abs err {err}")
        nbytes, ops = cost(kernel, x, leaf, kw)
        lib, lib_note = int_mm_ms(x, leaf) if kernel == "int8_matmul_requant" else (None, None)
        rows.append({
            "path": "resnet18", "kernel": kernel, "call": label, "x": list(shape), "n": leaf["w"].n,
            "max_abs_err": err,
            "ms": time_ms(lambda: KERNEL[kernel](*args, **kw)),
            "plain_ms": time_ms(lambda: PLAIN[kernel](*args, **kw)),
            "bytes": nbytes, "ops": ops,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / INT8_OPS_PER_S * 1e3,
            "library_ms": lib, **({"library_note": lib_note} if lib_note else {}),
        })
        emit({"phase": "a_main_shape", **rows[-1]})
        del x, args
    # the stem's patch matrix, built outside the kernel (plain data movement)
    st = model.q["stem"]
    h = st["e4"].shape[1]
    xp = torch.zeros((BATCH, h + 3, h + 3, st["w"].shape[2]), dtype=torch.int8, device="cuda")
    emit({"phase": "stem_im2col", "ms": time_ms(lambda: extract_patches_nhwc(xp, 4, 4, 1, 0, 0))})
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
    err, exact = float(d.max()), float((d == 0).double().mean())
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
    """(a) kernel C at shapes off the served path: relu6 without SE, without
    expand, no residual, ragged H/W, Ce not a multiple of 8 or 64 (and not of
    4), stride 2 on odd H, k = 1/3/5."""
    cases = [  # (n, h, w, cin, ce, co, se, k, stride, expand, act, residual)
        (3, 12, 12, 24, 36, 20, 0, 3, 1, True, "relu6", False),
        (2, 10, 10, 40, 40, 40, 0, 3, 1, False, "relu6", True),
        (2, 7, 9, 24, 36, 24, 6, 5, 1, True, "silu", True),
        (2, 15, 15, 16, 100, 24, 4, 3, 2, True, "silu", False),
        (3, 13, 11, 22, 38, 30, 5, 5, 2, True, "silu", False),
        (2, 20, 20, 72, 72, 72, 18, 5, 1, False, "silu", True),
        (2, 9, 9, 32, 200, 48, 8, 1, 1, True, "silu", False),
        (1, 33, 31, 8, 8, 16, 2, 3, 2, False, "silu", False),
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
                                       fused_mbconv_block_plain(x, packed, **kw), 0.99)
        err_max = max(err_max, err)
        if not ok:
            fails.append(f"fused_mbconv_block {(n, h, w, cin, ce, co, se, k, stride, expand, act, residual)}:"
                         f" max abs err {err}, exact {exact}")
    emit({"phase": "eff_a_odd_shapes", "checks": len(cases), "max_abs_err": err_max,
          "failed": fails})
    return fails


def eff_kernel_a_calls(model, b: int, gen: torch.Generator):
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
    """(a) kernel C at the 16 block shapes and kernel A at its 3, batch 256,
    then the timings."""
    rows, fails = [], []
    for name, x, k, stride, residual in eff_block_inputs(model, BATCH, gen):
        packed = model.qf[name]
        kw = dict(kernel=k, stride=stride, act="silu", x_res=x if residual else None)
        ok, err, exact = compare_block(fused_mbconv_block(x, packed, **kw),
                                       fused_mbconv_block_plain(x, packed, **kw), 0.99)
        if not ok:
            fails.append(f"fused_mbconv_block {name} {tuple(x.shape)}: max abs err {err}, "
                         f"exact {exact}")
        nbytes, ops, dw = block_cost(x, packed, k, stride, residual)
        rows.append({
            "path": "efficientnet_b0", "kernel": "fused_mbconv_block", "call": name,
            "x": list(x.shape), "ce": packed["wdw"].shape[-1], "n": packed["wp"].n,
            "k": k, "stride": stride, "max_abs_err": err, "exact": exact,
            "ms": time_ms(lambda: fused_mbconv_block(x, packed, **kw)),
            "plain_ms": time_ms(lambda: fused_mbconv_block_plain(x, packed, **kw)),
            "bytes": nbytes, "ops": ops, "dw_macs": dw,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / INT8_OPS_PER_S * 1e3,
            "dw_ms": dw / FP32_FMA_PER_S * 1e3, "library_ms": None,
        })
        emit({"phase": "eff_a_main_shape", **rows[-1]})
        del x
    for kernel, label, shape, dtype, leaf, kw in eff_kernel_a_calls(model, BATCH, gen):
        x = make_input(shape, dtype, kw["in_zp"], gen)
        args = (x, leaf["w"], leaf["w_scale"], leaf["bias"], leaf["w_sum"])
        ok, err = compare(KERNEL[kernel](*args, **kw), PLAIN[kernel](*args, **kw))
        if not ok:
            fails.append(f"{kernel} {label} {tuple(shape)}: max abs err {err}")
        nbytes, ops = cost(kernel, x, leaf, kw)
        lib, lib_note = int_mm_ms(x, leaf)
        rows.append({
            "path": "efficientnet_b0", "kernel": kernel, "call": label, "x": list(shape),
            "n": leaf["w"].n, "max_abs_err": err,
            "ms": time_ms(lambda: KERNEL[kernel](*args, **kw)),
            "plain_ms": time_ms(lambda: PLAIN[kernel](*args, **kw)),
            "bytes": nbytes, "ops": ops,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / INT8_OPS_PER_S * 1e3,
            "library_ms": lib, **({"library_note": lib_note} if lib_note else {}),
        })
        emit({"phase": "eff_a_main_shape", **rows[-1]})
        del x, args
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


def kernels_line(rows, launches_by_path):
    """One entry per kernel: time, plain time, bound and library time summed
    over its calls in one batch-256 forward of every path that runs it;
    launches summed over the served runs of those paths."""
    kernels = []
    for k, (src, replaces) in KERNEL_INFO.items():
        mine = [r for r in rows if r["kernel"] == k]
        parts = [max(r["bytes_ms"], r["ops_ms"], r.get("dw_ms", 0.0)) for r in mine]
        by = {"bytes": sum(p for p, r in zip(parts, mine) if p == r["bytes_ms"]),
              "operations": sum(p for p, r in zip(parts, mine) if p != r["bytes_ms"])}
        libs = [r["library_ms"] for r in mine]
        paths = sorted({r["path"] for r in mine})
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(launches_by_path[p].get(k, 0) for p in paths),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(parts),
            "bound_by": max(by, key=by.get),
            "library_ms": None if None in libs else sum(libs),
            **({"library_note": "no PyTorch call computes a fused int8 MBConv block, and "
                                "PyTorch has no int8 convolution on CUDA"}
               if k == "fused_mbconv_block" else {}),
            **({"library_note": "PyTorch has no int8 convolution on CUDA"}
               if k == "conv3x3_s1_int8" else {}),
            "per": f"one batch-{BATCH} forward of {' and '.join(paths)}: sum over its "
                   f"{len(mine)} calls",
            "paths": {p: {"calls": sum(r["path"] == p for r in mine),
                          "ms": sum(r["ms"] for r in mine if r["path"] == p),
                          "launches": launches_by_path[p].get(k, 0)} for p in paths},
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
    for k, per in PER_FORWARD.items():  # (d)
        if launches.get(k, 0) != per * forwards:
            raise SmokeFailure(f"(d) {k} launched {launches.get(k, 0)} times in {forwards} "
                               f"forwards, expected {per * forwards}")

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
    emit({"kernels": kernels_line(rows + eff_rows,
                                  {"resnet18": launches, "efficientnet_b0": eff_launches})})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"], "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
