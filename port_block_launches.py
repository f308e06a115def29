#!/usr/bin/env python3
"""Device time of kernel C's three launches at every EfficientNet-B0 block,
or (``--resnet``) of kernel B's calls and the whole ResNet18 forward by kernel,
or (``--dwconv``) of kernel E's calls, or (``--gconv``) of kernel F's, or
(``--forward``) the ResNet18 INT8 forward as its caller sees it.

Run from the repository root: ``python3 port_block_launches.py [--root DIR]
[--resnet | --dwconv [--ablate] | --gconv [--ablate]]``. It serves nothing. By default it loads the committed
static-INT8 EfficientNet-B0 (``testdata/effnet_b0_int8``) on the GPU, feeds
each fused MBConv block int8 activations at batch 256 spread around the
block's input zero point (from a seed), and times ``fused_mbconv_block`` per
launch (expand + depthwise, SE gate, project) as device time by
``torch.profiler``. With ``--resnet`` it loads the committed pruned ResNet18
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
package (and, with ``--resnet`` or ``--dwconv``, its ``chip_smoke.py``)
from another checkout (for example the parent commit
unpacked with ``git archive``), so two versions can be timed in one run on
one card. Prints one JSON object. ``chip_smoke.py`` uses ``launch_ms`` for
its own per-block rows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

LAUNCHES = ("expand_dw", "se_gate", "project")


def launch_ms(call, runs: int = 10) -> dict:
    """Device ms per call of each of kernel C's launches (by kernel name),
    averaged over ``runs`` calls after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            call()
        torch.cuda.synchronize()
    out = dict.fromkeys(LAUNCHES, 0.0)
    for e in prof.key_averages():
        for k in LAUNCHES:
            if f"{k}_kernel" in e.key:
                out[k] += e.self_device_time_total / 1e3 / runs
    return out


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
    ap.add_argument("--ablate", action="store_true",
                    help="with --dwconv or --gconv: also copies of this checkout's kernel with "
                         "a part taken out")
    ap.add_argument("--sweep", action="store_true",
                    help="with --gconv: also every tile plan of each call")
    args = ap.parse_args()
    if args.sweep and not args.gconv:
        ap.error("--sweep goes with --gconv")
    if args.ablate and not (args.dwconv or args.gconv):
        ap.error("--ablate goes with --dwconv or --gconv")
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
    from inference_efficient_vision_models_tpu_torch.compress.quant.fusedpath import (
        block_plan,
        load_static_int8_fused,
    )
    from inference_efficient_vision_models_tpu_torch.ops import fused_mbconv_block

    artifact = os.path.join(os.path.abspath(args.root), "inference_efficient_vision_models_tpu_torch",
                            "testdata", "effnet_b0_int8")
    model = load_static_int8_fused(artifact, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    h = model.q["stem"]["e"].shape[1]
    blocks = {}
    for name, k, stride, residual in block_plan(model.spec):
        packed = model.qf[name]
        cin = packed["we"].k if "we" in packed else packed["wdw"].shape[-1]
        zp = int(packed["scal"][0]) + 128
        x = (torch.randn((args.batch, h, h, cin), generator=gen, device="cuda") * 30
             + (zp - 118)).round().clamp(-128, 127).to(torch.int8)
        kw = dict(kernel=k, stride=stride, act="silu", x_res=x if residual else None)
        blocks[name] = launch_ms(lambda: fused_mbconv_block(x, packed, **kw))
        h = (h - 1) // stride + 1
    total = {k: sum(b[k] for b in blocks.values()) for k in LAUNCHES}
    print(json.dumps({"root": os.path.abspath(args.root), "batch": args.batch,
                      "device": torch.cuda.get_device_name(0), "blocks": blocks, "total": total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
