#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU, end to end.

Run from the repository root: ``python3 chip_smoke.py``. It

1. builds the CUDA kernels from ``inference_efficient_vision_models_tpu_torch/csrc``
   (nvcc for sm_90a, at first use) and prints the card's name and power limit;
2. (a) holds each kernel against its plain PyTorch version on the card, at
   every shape the served ResNet18 gives it (batch 256) and at odd shapes,
   including the int8 matmul's float-input and GELU variants;
3. serves the committed static-INT8 pruned ResNet18 through
   ``Predictor.from_artifact`` (requests of 1, 8 and 2x256 images) with the
   launch counters set to 0 just before and read just after, and checks
   (d) 13 direct-3x3 and 8 int8-matmul launches per forward;
4. holds the served logits against (b) the plain-path forward on the card
   and (c) the JAX package's golden logits committed in ``testdata/``;
5. times each kernel at its serving shapes (batch 256) beside its plain
   version, its bound and ``torch._int_mm``, and the whole forward at
   batch 1 and 256, with CUDA events (median of 25 runs after warm-up).

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
    int8_matmul_requant,
    int8_matmul_requant_plain,
    pack_weight,
)
from inference_efficient_vision_models_tpu_torch.ops.im2col import extract_patches_nhwc
from inference_efficient_vision_models_tpu_torch.serving import Predictor
from inference_efficient_vision_models_tpu_torch.utils.device import describe_device

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(ROOT, "artifacts", "bench", "quantization", "r2", "fold_0")
GOLDEN = os.path.join(ROOT, "inference_efficient_vision_models_tpu_torch", "testdata",
                      "r2_fold0_jax_logits.npz")
PKG = "inference_efficient_vision_models_tpu_torch"
KERNEL_INFO = {
    "int8_matmul_requant": (f"{PKG}/csrc/int8_matmul.cu",
                            "inference_efficient_vision_models_tpu/ops/int8_matmul.py:87"),
    "conv3x3_s1_int8": (f"{PKG}/csrc/conv3x3.cu",
                        "inference_efficient_vision_models_tpu/ops/conv3x3.py:67"),
}
PLAIN = {"int8_matmul_requant": int8_matmul_requant_plain,
         "conv3x3_s1_int8": conv3x3_s1_int8_plain}
KERNEL = {"int8_matmul_requant": int8_matmul_requant, "conv3x3_s1_int8": conv3x3_s1_int8}
PER_FORWARD = {"int8_matmul_requant": 8, "conv3x3_s1_int8": 13}
BATCH = 256
RUNS = 25
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak


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
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return False, float("inf")
    d = (got.float() - ref.float()).abs()
    err = float(d.max()) if d.numel() else 0.0
    if got.dtype == torch.int8:
        return err <= 1 and float((d == 0).double().mean()) >= 0.99, err
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
    only; the port never calls it). N is padded to a multiple of 8."""
    w = leaf["w"].kn()
    if x.dtype != torch.int8:
        x = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
    n8 = (w.shape[1] + 7) // 8 * 8
    w8 = torch.zeros((w.shape[0], n8), dtype=torch.int8, device=x.device)
    w8[:, : w.shape[1]] = w
    try:
        torch._int_mm(x, w8)
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return time_ms(lambda: torch._int_mm(x, w8)), None


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
            "kernel": kernel, "call": label, "x": list(shape), "n": leaf["w"].n,
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


def serve(model_dir: str, golden_imgs: np.ndarray, gen_np: np.random.Generator):
    """The main path: Predictor on cuda, three requests, launches counted."""
    pred = Predictor.from_artifact(model_dir, device="cuda", batch_size=BATCH,
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

    kernels = []
    for k, (src, replaces) in KERNEL_INFO.items():
        mine = [r for r in rows if r["kernel"] == k]
        bytes_part = sum(r["bytes_ms"] for r in mine if r["bytes_ms"] >= r["ops_ms"])
        ops_part = sum(r["ops_ms"] for r in mine if r["bytes_ms"] < r["ops_ms"])
        libs = [r["library_ms"] for r in mine]
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches.get(k, 0),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": bytes_part + ops_part,
            "bound_by": "bytes" if bytes_part >= ops_part else "operations",
            "library_ms": None if k != "int8_matmul_requant" or None in libs else sum(libs),
            "per": f"one batch-{BATCH} forward: sum over its {len(mine)} calls",
        })
    emit({"kernels": kernels})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"], "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
