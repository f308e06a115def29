#!/usr/bin/env python3
"""Device time of kernel C's three launches at every EfficientNet-B0 block
(``--mbv2``: MobileNetV2's 17), or (``--resnet``) of kernel B's calls and the whole ResNet18 forward by kernel,
or (``--dwconv``) of kernel E's calls, or (``--gconv``) of kernel F's, or
(``--forward``) the ResNet18 INT8 forward as its caller sees it.

Run from the repository root: ``python3 port_block_launches.py [--root DIR]
[[--mbv2] [--ablate] [--sweep] | --resnet | --dwconv [--ablate] | --gconv [--ablate] [--sweep]]``.
It serves nothing. By default it loads the committed
static-INT8 EfficientNet-B0 (``testdata/effnet_b0_int8``) on the GPU, feeds
each fused MBConv block int8 activations at batch 256 spread around the
block's input zero point (from a seed), and times each of its launches
(expand + depthwise, SE gate, project) alone on the block's own
intermediates: CUDA events, the device alone (``launch_ms``, which
``chip_smoke.py`` uses for its per-block rows too). With ``--mbv2`` it does
the same at MobileNetV2's 17
block shapes (``MBV2_BLOCKS``: ReLU6, no SE), on blocks of seeded random
weights (``chip_smoke.random_block``). ``--ablate`` adds, for either net,
the project launch (launch 3) on copies of this checkout's kernel C with a
part taken out (``C_ABLATIONS``: the transform, the MMA, the epilogue, the
output stores or the copies in), and for B0 the SE-gate
launch (launch 2) on copies without its FC1 or FC2 multiply-adds, its
weight copies or its sigmoid (``SE_ABLATIONS``); ``--sweep`` adds the
project launch under every tile plan (``c_sweep``). With ``--resnet`` it loads the committed pruned ResNet18
(``artifacts/bench/quantization/r2/fold_0``), times every
``conv3x3_s1_int8`` call of a batch-256 forward as that checkout's
``chip_smoke.py`` makes it (CUDA events, the device alone), and profiles
three forwards: device ms and calls per forward of every kernel by name.
With ``--dwconv`` it loads the committed EfficientNet-B0 on the unfused
executor and times every ``depthwise_conv_int8`` call of a batch-256
forward as that checkout's ``chip_smoke.py`` makes it (CUDA events, the
device alone); ``--ablate`` adds the same calls on copies of this
checkout's kernel E with its epilogue, its taps or its staging taken out,
the shares of its time no profiler on the card can break down. With
``--gconv`` it times kernel F alone at resnext26_32x4d's 8 grouped calls and
at the ResNeXt chain's pruned lanes (Cg 4, 7, 14, 28 by stage), batch 256,
on seeded int8 activations and weights drawn as a quantized Gaussian (CUDA
events, the device alone), each call first held equal to its plain
version; ``--ablate`` adds the same calls on copies of this checkout's
kernel F with a part taken out (``GC_ABLATIONS``: the mma loop and
epilogue, the epilogue, the mma, the staging, the output copy, the k loop)
or its fp32 quotient replaced by ``div_rn_by``; ``--sweep`` times each call
under every tile plan (the check of ``gconv_plan``'s cost model).
With ``--forward`` it times the committed pruned ResNet18's eager INT8
forward (``load_static_int8``, device-resident uint8 images from a seed) at
batch 1 and at ``--batch``: CUDA events around each call, host launch
overhead included, median of 25 after 3 warm-up calls (``chip_smoke.time_ms``).
``--root`` takes the port
package and its ``chip_smoke.py`` from another checkout (for example the
parent commit unpacked with ``git archive``), so two versions can be timed
in one run on one card. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

LAUNCHES = ("expand_dw", "se_gate", "project")


def launch_args(x, packed, kernel: int, stride: int, act: str, x_res):
    """The arguments of kernel C's three launch ops at one block call, on the
    block's own intermediates (launch 1's yq and pool sums, launch 2's gate):
    (expand_dw, se_gate or None, project)."""
    from inference_efficient_vision_models_tpu_torch.ops import fused_mbconv as fm

    sc, we, se = list(packed["scal"]), packed.get("we"), "srw" in packed
    a1 = (x, we.wt if we else None, list(we.shape) if we else [], packed.get("ve"),
          packed["wdw"], packed["vdw"], sc, kernel, stride, act, se)
    yq, pool = fm._expand_dw_cuda(*a1)
    a2 = g = None
    if se:
        a2 = (pool, packed["srw"], packed["srb"], packed["sew"], packed["seb"],
              sc[fm.D_SCALE] / (yq.shape[1] * yq.shape[2]))
        g = fm._se_gate_cuda(*a2)
    wp = packed["wp"]
    return a1, a2, (yq, g, wp.wt, list(wp.shape), packed["vp"], x_res, sc)


def launch_ms(x, packed, kernel: int, stride: int, act: str, x_res) -> dict:
    """Device ms of each of kernel C's launches at one block call, apart:
    each launch's op called alone on the block's own intermediates
    (``launch_args``), CUDA events around each call with the device alone
    (``chip_smoke.time_ms(spin=True)``, median of 25). ``chip_smoke.py``
    times its per-block rows with it too."""
    import chip_smoke as cs
    from inference_efficient_vision_models_tpu_torch.ops import fused_mbconv as fm

    a1, a2, a3 = launch_args(x, packed, kernel, stride, act, x_res)
    return {"expand_dw": cs.time_ms(lambda: fm._expand_dw_cuda(*a1), spin=True),
            "se_gate": cs.time_ms(lambda: fm._se_gate_cuda(*a2), spin=True) if a2 else 0.0,
            "project": cs.time_ms(lambda: fm._project_cuda(*a3), spin=True)}


def kernels_by_name(fn, iters: int = 3) -> dict:
    """Device ms and calls per call of ``fn`` of every kernel it launches, by
    name (``torch.profiler``, ``iters`` calls after one warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    by = {e.key: {"ms": e.self_device_time_total / 1e3 / iters, "calls": e.count / iters}
          for e in sorted(ks, key=lambda e: -e.self_device_time_total)}
    return {"device_ms": sum(v["ms"] for v in by.values()),
            "launches": sum(v["calls"] for v in by.values()), "kernels": by}


def resnet(root: str, batch: int) -> dict:
    """Kernel B per call and the forward by kernel, for the checkout at ``root``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from inference_efficient_vision_models_tpu_torch.compress.quant.qresnet import (
        load_static_int8,
    )
    from inference_efficient_vision_models_tpu_torch.ops import conv3x3_s1_int8

    model = load_static_int8(os.path.join(root, "artifacts", "bench", "quantization", "r2",
                                          "fold_0"), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    calls = {}
    for kernel, label, shape, dtype, leaf, kw in cs.main_path_calls(model, batch):
        if kernel != "conv3x3_s1_int8":
            continue
        x = cs.make_input(shape, dtype, kw["in_zp"], gen)
        if hasattr(cs, "with_residual"):
            kw = cs.with_residual(kw, shape, leaf["w"].n, gen)
        args = (x, leaf["w"], leaf["w_scale"], leaf["bias"], leaf["w_sum"])
        calls[label] = cs.time_ms(lambda: conv3x3_s1_int8(*args, **kw), spin=True)
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (batch, 224, 224, 3), dtype=np.uint8)).cuda()
    with torch.inference_mode():
        forward_ms = cs.time_ms(lambda: model(x))
        prof = kernels_by_name(lambda: model(x))
    return {"conv3x3_ms": calls, "conv3x3_total_ms": sum(calls.values()),
            "forward_ms": forward_ms, "profile": prof}


# Kernel E with one part taken out (a text edit of csrc/dwconv_int8.cu; the
# outputs are then wrong): the time it saves is that part's share, where
# ncu cannot run. --ablate times each beside the kernel as it is.
DW_ABLATIONS = {
    "no_epilogue": ("        act_requant<ACT>(y, a.rs_out, zpm, q);",
                    "        for (int u = 0; u < 8; ++u) q[u] = __float_as_uint(y[u]);"),
    "no_taps": ("    for (int sr = 0; sr < NR; ++sr) {", "    for (int sr = 0; sr < 0; ++sr) {"),
    "no_staging": ("  for (int r = 0; r < a.rh; ++r) {", "  for (int r = 0; r < 0; ++r) {"),
}


# Kernel F with one part taken out (a text edit of csrc/gconv_int8.cu; the
# outputs are then wrong, but for div_rn_by's): --gconv --ablate times each.
GC_ABLATIONS = {
    "staging_and_stores": ("    if (w < wsl) {", "    if (w < wsl && a.N < 0) {"),
    "no_epilogue": ("__device__ __forceinline__ uint32_t out_q(int acc, const int4& c, float s, "
                    "float r, int zpk) {",
                    "__device__ __forceinline__ uint32_t out_q(int acc, const int4& c, float s, "
                    "float r, int zpk) {\n  return (uint32_t)acc & 0xffu;"),
    "no_mma": ("          for (int j = 0; j < NTW; ++j) mma_f(acc[m][j], af[m], bf[j]);",
               "          for (int j = 0; j < NTW; ++j)\n"
               "            acc[m][j][0] ^= af[m][0] ^ af[m][1] ^ af[m][2] ^ af[m][3] ^ bf[j][0] ^ "
               "bf[j][1];"),
    "no_staging": ("  if (pl >= lanes) return;", "  if (pl >= lanes || a.N > 0) return;"),
    "no_copy_out": ("  for (; r < rows;) {", "  for (; r < rows && a.N < 0;) {"),
    "no_kloop": ("      for (int s = 0; s < g.ks; ++s) {", "      for (int s = 0; s < 0; ++s) {"),
    "div_rn_by": ("  const float q = __fmul_rn(y, r);\n  return __fmaf_rn(__fmaf_rn(-q, s, y), r, q);",
                  "  return div_rn_by(y, 1.0 / (double)s);"),
}


def ablated_kernels(stem: str, symbol: str, kernel: str, edits: dict) -> dict:
    """name -> the ctypes entry ``symbol`` of kernel ``kernel`` built from
    this checkout's ``csrc/<stem>.cu`` with that ablation's edit (one nvcc
    per variant, all at once)."""
    import ctypes
    import shutil
    import subprocess

    from inference_efficient_vision_models_tpu_torch.ops import _lib

    src = open(os.path.join(_lib.CSRC, f"{stem}.cu")).read()
    procs = {}
    for name, (old, new) in edits.items():
        if old not in src:
            raise RuntimeError(f"ablation {name}: its edit does not apply to {_lib.CSRC}")
        d = os.path.join(_lib.BUILD_DIR, f"ablate_{stem}_{name}")
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(_lib.CSRC):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(_lib.CSRC, f), d)
        with open(os.path.join(d, f"{stem}.cu"), "w") as f:
            f.write(src.replace(old, new))
        so = os.path.join(d, f"lib{stem}.so")
        procs[name] = (subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-o", so,
             os.path.join(d, f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {name} failed to build:\n{out}")
        fn = getattr(ctypes.CDLL(so), symbol)
        fn.argtypes = _lib.KERNELS[kernel][1][symbol]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def dwconv(root: str, batch: int, ablate: bool = False) -> dict:
    """Kernel E per call at the committed B0's 16 depthwise calls, for the
    checkout at ``root``; with ``ablate``, also each of DW_ABLATIONS."""
    import torch

    import chip_smoke as cs
    from inference_efficient_vision_models_tpu_torch.compress.quant.qeffnet import (
        load_static_int8,
    )
    from inference_efficient_vision_models_tpu_torch.ops import _lib, depthwise_conv_int8

    model = load_static_int8(os.path.join(root, "inference_efficient_vision_models_tpu_torch",
                                          "testdata", "effnet_b0_int8"), "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    inputs = []
    for name, shape, leaf, stride, in_s, in_z in cs.dw_calls(model, batch):
        kw = dict(stride=stride, in_scale=in_s, in_zp=in_z, out_scale=leaf["out_scale"],
                  out_zp=leaf["out_zp"])
        inputs.append((name, (cs.int8_around(shape, in_z, gen), leaf["w_q"], leaf["w_scale"],
                              leaf["bias"]), kw))

    def timed():
        return {name: cs.time_ms(lambda: depthwise_conv_int8(*args, **kw), spin=True)
                for name, args, kw in inputs}

    calls = timed()
    out = {"dwconv_ms": calls, "dwconv_total_ms": sum(calls.values())}
    if ablate:
        kernel = _lib.kernel_fn("dwconv_int8")  # built and bound by the timed calls
        out["ablations"] = {}
        for name, fn in ablated_kernels("dwconv_int8", "ievm_dwconv_int8", "dwconv_int8",
                                        DW_ABLATIONS).items():
            _lib._fns["ievm_dwconv_int8"] = fn
            per = timed()
            out["ablations"][name] = {"total_ms": sum(per.values()), "ms": per}
        _lib._fns["ievm_dwconv_int8"] = kernel
    return out


# kernel F's calls (label, H, C, stride) at 224x224: resnext26_32x4d's 8
# grouped convs and the ResNeXt chain's (Cg 4, 7, 14, 28 by stage), 32 groups
GC_CALLS = {
    "resnext26_32x4d": [("layer1.0", 56, 128, 1), ("layer1.1", 56, 128, 1),
                        ("layer2.0", 56, 256, 2), ("layer2.1", 28, 256, 1),
                        ("layer3.0", 28, 512, 2), ("layer3.1", 14, 512, 1),
                        ("layer4.0", 14, 1024, 2), ("layer4.1", 7, 1024, 1)],
    "resnext26_pipeline": [("layer1.0", 56, 128, 1), ("layer1.1", 56, 128, 1),
                           ("layer2.0", 56, 224, 2), ("layer2.1", 28, 224, 1),
                           ("layer3.0", 28, 448, 2), ("layer3.1", 14, 448, 1),
                           ("layer4.0", 14, 896, 2), ("layer4.1", 7, 896, 1)],
}


def sweep_plans(inputs) -> dict:
    """Each call timed under every tile plan the kernel takes (band heights,
    tiles per block, copy widths), the plan gconv_plan chooses marked: the
    check of its cost model. -> {call: {"chosen": ms, "best": [ms, plan],
    "plans": n}}."""
    import chip_smoke as cs
    from inference_efficient_vision_models_tpu_torch.ops import grouped_conv_int8
    from inference_efficient_vision_models_tpu_torch.ops import gconv_int8 as tg

    chosen_fn, res = tg.gconv_plan, {}
    for name, args, kw in inputs:
        x = args[0]
        n, h, w, c = x.shape
        g, s = tg.gc_geom(c, 32), kw["stride"]
        ho = (h - 1) // s + 1
        chosen = chosen_fn(n, h, w, c, 32, s, 16)
        times = []
        for vec in tg._vecs(c, g, 16):
            for bh in sorted({2, 4, 6, 8, 12, 16, 28, (ho + 1) // 2 * 2} & set(range(2, ho + 2))):
                for nb in (1, 2, 4, 8):
                    p = tg.make_gconv_plan(n, h, w, c, 32, s, bh=bh, nb=nb, vec=vec)
                    if p.smem > tg.GC_SMEM_LIMIT or nb > n * p.bands:
                        continue
                    tg.gconv_plan = lambda *a_, p=p: p
                    try:
                        times.append((cs.time_ms(lambda: grouped_conv_int8(*args, **kw), spin=True),
                                      dict(bh=bh, nb=nb, vec=vec, ps=p.ps, smem=p.smem,
                                           chosen=p == chosen)))
                    finally:
                        tg.gconv_plan = chosen_fn
        best = min(times, key=lambda t: t[0])
        res[name] = {"chosen": next((t for t, pl in times if pl["chosen"]), None),
                     "best": best, "plans": len(times), "all": times}
    return res


def gconv(batch: int, ablate: bool = False, sweep: bool = False) -> dict:
    """Kernel F per call at ``GC_CALLS`` for the imported checkout, each call
    held equal to its plain version first; with ``ablate``, also each of
    GC_ABLATIONS; with ``sweep``, each call under every tile plan
    (``sweep_plans``)."""
    import torch

    import chip_smoke as cs
    from inference_efficient_vision_models_tpu_torch.ops import (
        _lib, grouped_conv_int8, grouped_conv_int8_plain, pack_grouped_weight)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    inputs, errs = [], {}
    for path, calls in GC_CALLS.items():
        for label, h, c, stride in calls:
            wq = (torch.randn((3, 3, c // 32, c), generator=gen, device="cuda") * 40).round()
            wq = wq.clamp(-127, 127).to(torch.int8)
            args = (cs.int8_around((batch, h, h, c), 100, gen), pack_grouped_weight(wq, 32),
                    torch.rand(c, generator=gen, device="cuda") * 2e-3 + 1e-3,
                    torch.randn(c, generator=gen, device="cuda"),
                    wq.int().sum((0, 1, 2), dtype=torch.int32))
            kw = dict(stride=stride, in_scale=0.05, in_zp=100, out_scale=0.04, out_zp=3)
            got, ref = grouped_conv_int8(*args, **kw), grouped_conv_int8_plain(*args, **kw)
            errs[f"{path}/{label}"] = int((got.int() - ref.int()).abs().max())
            inputs.append((f"{path}/{label}", args, kw))

    def timed():
        per = {name: cs.time_ms(lambda: grouped_conv_int8(*args, **kw), spin=True)
               for name, args, kw in inputs}
        return {"ms": per, **{f"{p}_ms": sum(v for k, v in per.items() if k.startswith(p + "/"))
                              for p in GC_CALLS}}

    out = {"gconv": timed(), "max_abs_err": errs,
           "ptxas": [ln for ln in _lib.build_logs.get("gconv_int8", "").splitlines()
                     if "registers" in ln or "spill" in ln or "gconv" in ln]}
    if sweep:
        out["sweep"] = sweep_plans(inputs)
    if ablate:
        kernel = _lib.kernel_fn("gconv_int8", "ievm_gconv_int8")
        out["ablations"] = {}
        for name, fn in ablated_kernels("gconv_int8", "ievm_gconv_int8", "gconv_int8",
                                        GC_ABLATIONS).items():
            _lib._fns["ievm_gconv_int8"] = fn
            out["ablations"][name] = timed()
        _lib._fns["ievm_gconv_int8"] = kernel
    return out


def forward(root: str, batch: int) -> dict:
    """The r2 ResNet18 INT8 forward of the checkout at ``root``, timed as its
    caller sees it at batch 1 and ``batch``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from inference_efficient_vision_models_tpu_torch.compress.quant.qresnet import (
        load_static_int8,
    )

    model = load_static_int8(os.path.join(root, "artifacts", "bench", "quantization", "r2",
                                          "fold_0"), device="cuda")
    out = {}
    with torch.inference_mode():
        for b in (1, batch):
            x = torch.from_numpy(np.random.default_rng(2).integers(
                0, 256, (b, 224, 224, 3), dtype=np.uint8)).cuda()
            out[f"forward_ms_b{b}"] = cs.time_ms(lambda: model(x))
    return out


# Kernel C's project launch with one part taken out (a text edit of
# csrc/fused_mbconv.cu; the outputs are then wrong): --ablate times each.
C_ABLATIONS = {
    "no_transform": ("    pj_transform(a, PieceMap(", "    if (a.M < 0) pj_transform(a, PieceMap("),
    "no_mma": ("      if (ck * PJ_KS + PJ_KS <= a.kc) {  // a whole chunk",
               "      if (a.M > 0) {\n      } else if (ck * PJ_KS + PJ_KS <= a.kc) {  // a whole chunk"),
    "no_epilogue": ("      if (has_cols) pj_epilogue<TN>(", "      if (has_cols && a.M < 0) pj_epilogue<TN>("),
    "no_stores": ("  if (ncb == a.Co && a.flat16) {", "  if (a.M > 0) return;\n  if (ncb == a.Co && a.flat16) {"),
    "no_copies": ("    if (in_u < units) {", "    if (in_u < units && a.M < 0) {"),
}
# Kernel C's SE-gate launch with one part taken out: the float64 multiply-adds
# of FC1 or FC2, the weight copies, or the final exp and reciprocal.
SE_ABLATIONS = {
    "no_fc1_math": ("for (int im = 0; im < G; ++im) acc[im] += pooled[im * Ce + c0 + cl] * wv;",
                    "acc[0] += wv;"),
    "no_fc2_math": ("for (int im = 0; im < G; ++im) sum[im] += r[im * Se + j0 + jl] * wv;",
                    "sum[0] += wv;"),
    "no_weight_copies": ("    const int nf = rows_of(k) * len;",
                         "    if (nrows > 0) return;\n    const int nf = rows_of(k) * len;"),
    "no_sigmoid": ("(float)(1.0 / (1.0 + exp(-(acc2[im * Ce + c] + b))));",
                   "(float)(acc2[im * Ce + c] + b);"),
}
# MobileNetV2 (width 1.0) at 224 x 224: (block, input side, Cin, Ce, Co, k,
# stride, residual); no SE, ReLU6
MBV2_BLOCKS = [
    ("s0b0", 112, 32, 32, 16, 3, 1, False), ("s1b0", 112, 16, 96, 24, 3, 2, False),
    ("s1b1", 56, 24, 144, 24, 3, 1, True), ("s2b0", 56, 24, 144, 32, 3, 2, False),
    ("s2b1", 28, 32, 192, 32, 3, 1, True), ("s2b2", 28, 32, 192, 32, 3, 1, True),
    ("s3b0", 28, 32, 192, 64, 3, 2, False), ("s3b1", 14, 64, 384, 64, 3, 1, True),
    ("s3b2", 14, 64, 384, 64, 3, 1, True), ("s3b3", 14, 64, 384, 64, 3, 1, True),
    ("s4b0", 14, 64, 384, 96, 3, 1, False), ("s4b1", 14, 96, 576, 96, 3, 1, True),
    ("s4b2", 14, 96, 576, 96, 3, 1, True), ("s5b0", 14, 96, 576, 160, 3, 2, False),
    ("s5b1", 7, 160, 960, 160, 3, 1, True), ("s5b2", 7, 160, 960, 160, 3, 1, True),
    ("s6b0", 7, 160, 960, 320, 3, 1, False),
]


def c_blocks(root: str, batch: int, mbv2: bool):
    """(name, x, packed, kwargs) of every fused block of the net at batch
    ``batch``: the committed B0's blocks, or MobileNetV2's on seeded random
    blocks, int8 inputs spread around each block's input zero point."""
    import numpy as np
    import torch

    from inference_efficient_vision_models_tpu_torch.ops import to_device_packed

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def x_of(h, cin, zp):
        return (torch.randn((batch, h, h, cin), generator=gen, device="cuda") * 30
                + (zp - 118)).round().clamp(-128, 127).to(torch.int8)

    out = []
    if mbv2:
        import chip_smoke as cs

        rng = np.random.default_rng(0)
        for name, h, cin, ce, co, k, stride, residual in MBV2_BLOCKS:
            p_np, zp = cs.random_block(rng, cin=cin, ce=ce, co=co, se=0, k=k, expand=ce != cin)
            x = x_of(h, cin, zp)
            out.append((name, x, to_device_packed(p_np, "cuda"),
                        dict(kernel=k, stride=stride, act="relu6", x_res=x if residual else None)))
        return out
    from inference_efficient_vision_models_tpu_torch.compress.quant.fusedpath import (
        block_plan,
        load_static_int8_fused,
    )

    model = load_static_int8_fused(os.path.join(root, "inference_efficient_vision_models_tpu_torch",
                                                "testdata", "effnet_b0_int8"), device="cuda")
    h = model.q["stem"]["e"].shape[1]
    for name, k, stride, residual in block_plan(model.spec):
        packed = model.qf[name]
        cin = packed["we"].k if "we" in packed else packed["wdw"].shape[-1]
        x = x_of(h, cin, int(packed["scal"][0]) + 128)
        out.append((name, x, packed, dict(kernel=k, stride=stride, act="silu",
                                          x_res=x if residual else None)))
        h = (h - 1) // stride + 1
    return out


def c_launches(root: str, batch: int, mbv2: bool, ablate: bool, sweep: bool) -> dict:
    """Kernel C's launches apart at every block of the net (``c_blocks``,
    ``launch_ms``); with ``ablate``, the project launch on each copy of
    ``C_ABLATIONS`` and (B0) the SE gate on each of ``SE_ABLATIONS``; with
    ``sweep``, the project launch under every plan (``c_sweep``)."""
    from inference_efficient_vision_models_tpu_torch.ops import _lib

    blocks = c_blocks(root, batch, mbv2)

    def timed():
        per = {name: launch_ms(x, packed, kw["kernel"], kw["stride"], kw["act"], kw["x_res"])
               for name, x, packed, kw in blocks}
        return {"blocks": per, "total": {k: sum(b[k] for b in per.values()) for k in LAUNCHES}}

    out = timed()
    if sweep:
        out["sweep"] = c_sweep(blocks)
    if ablate:
        out["ablations"] = {}
        for launch, edits in [("project", C_ABLATIONS)] + ([] if mbv2 else
                                                            [("se_gate", SE_ABLATIONS)]):
            sym = f"ievm_fused_mbconv_{launch}"
            kernel = _lib.kernel_fn("fused_mbconv_block", sym)
            for name, fn in ablated_kernels("fused_mbconv", sym, "fused_mbconv_block",
                                            edits).items():
                _lib._fns[sym] = fn
                t = timed()
                out["ablations"][name] = {f"{launch}_ms": t["total"][launch],
                                          "ms": {b: v[launch] for b, v in t["blocks"].items()}}
            _lib._fns[sym] = kernel
    return out


def c_sweep(blocks) -> dict:
    """The project launch at each block under every plan the kernel takes
    for its (M, Ce, Co): each count of blocks per SM its registers allow,
    the weights resident (where they fit) or streamed, the ring as deep as
    fits (``fused_mbconv.project_fit``); each held equal to the plain
    version, the plan ``project_plan`` chooses marked. -> {block: {"chosen":
    ms, "best": ms, "plans": [[bps, resident, stages, ms], ...]}}."""
    import chip_smoke as cs
    import torch

    from inference_efficient_vision_models_tpu_torch.ops import fused_mbconv as fm

    chosen_fn, res = fm.project_plan, {}
    for name, x, packed, kw in blocks:
        _, _, a3 = launch_args(x, packed, kw["kernel"], kw["stride"], kw["act"], kw["x_res"])
        yq, g, co = a3[0], a3[1], packed["wp"].n
        n, ho, wo, ce = yq.shape
        shape = (n * ho * wo, ho * wo, ce, co, g is not None, kw["x_res"] is not None)
        chosen, ref = chosen_fn(*shape), fm._project_plain(*a3)
        plans = []
        for bps in range(fm.project_max_blocks(chosen), 0, -1):
            for resident in (True, False):
                p = fm.project_fit(chosen, bps, resident, co, *shape[4:])
                if p is None:
                    continue
                fm.project_plan = lambda *a_, p=p: p
                try:
                    if not torch.equal(fm._project_cuda(*a3), ref):
                        raise RuntimeError(f"project launch at {name} under {p} differs")
                    plans.append([bps, resident, p.stages,
                                  cs.time_ms(lambda: fm._project_cuda(*a3), spin=True),
                                  p == chosen])
                finally:
                    fm.project_plan = chosen_fn
        res[name] = {"chosen": next(t for *_, t, c in plans if c),
                     "best": min(t for *_, t, _ in plans),
                     "plans": [pl[:4] for pl in plans]}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="checkout whose port package to time")
    ap.add_argument("--batch", type=int, default=256)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--resnet", action="store_true",
                      help="kernel B's calls and the ResNet18 forward by kernel")
    mode.add_argument("--dwconv", action="store_true", help="kernel E's calls")
    mode.add_argument("--gconv", action="store_true", help="kernel F's calls")
    mode.add_argument("--forward", action="store_true",
                      help="the ResNet18 INT8 forward at batch 1 and --batch")
    mode.add_argument("--mbv2", action="store_true",
                      help="kernel C's launches at MobileNetV2's 17 block shapes")
    ap.add_argument("--ablate", action="store_true",
                    help="kernel C (the default, or --mbv2), --dwconv or --gconv: also copies of "
                         "the checkout's kernel with a part taken out")
    ap.add_argument("--sweep", action="store_true",
                    help="kernel C (the default, or --mbv2) or --gconv: also every tile plan of "
                         "each call")
    args = ap.parse_args()
    if args.sweep and (args.resnet or args.dwconv or args.forward):
        ap.error("--sweep goes with kernel C or --gconv")
    if args.ablate and (args.resnet or args.forward):
        ap.error("--ablate goes with kernel C, --dwconv or --gconv")
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("port_block_launches: no CUDA device", file=sys.stderr)
        return 1
    if args.gconv:
        print(json.dumps({"root": os.path.abspath(args.root), "batch": args.batch,
                          "device": torch.cuda.get_device_name(0),
                          **gconv(args.batch, args.ablate, args.sweep)}))
        return 0
    if args.resnet or args.dwconv or args.forward:
        root = os.path.abspath(args.root)
        if args.forward:
            res = forward(root, args.batch)
        else:
            res = resnet(root, args.batch) if args.resnet else dwconv(root, args.batch,
                                                                      args.ablate)
        print(json.dumps({"root": root, "batch": args.batch,
                          "device": torch.cuda.get_device_name(0), **res}))
        return 0
    root = os.path.abspath(args.root)
    print(json.dumps({"root": root, "batch": args.batch, "net": "mobilenet_v2" if args.mbv2
                      else "efficientnet_b0", "device": torch.cuda.get_device_name(0),
                      **c_launches(root, args.batch, args.mbv2, args.ablate, args.sweep)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
