#!/usr/bin/env python3
"""Device time of kernel C's three launches at every EfficientNet-B0 block,
or (``--resnet``) of kernel B's calls and the whole ResNet18 forward by kernel,
or (``--dwconv``) of kernel E's calls.

Run from the repository root: ``python3 port_block_launches.py [--root DIR]
[--resnet | --dwconv [--ablate]]``. It serves nothing. By default it loads the committed
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
the shares of its time no profiler on the card can break down. ``--root`` takes the port package (and, with ``--resnet`` or ``--dwconv``,
its ``chip_smoke.py``) from another checkout (for example the parent commit
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
    "no_epilogue": ("        silu_requant(y, a.rs_out, zpm, q);",
                    "        for (int u = 0; u < 8; ++u) q[u] = __float_as_uint(y[u]);"),
    "no_taps": ("    for (int sr = 0; sr < NR; ++sr) {", "    for (int sr = 0; sr < 0; ++sr) {"),
    "no_staging": ("  for (int r = 0; r < a.rh; ++r) {", "  for (int r = 0; r < 0; ++r) {"),
}


def ablated_kernels(root: str) -> dict:
    """name -> the ctypes entry of kernel E built from the checkout's source
    with that ablation's edit (one nvcc per variant, all at once)."""
    import ctypes
    import shutil
    import subprocess

    from inference_efficient_vision_models_tpu_torch.ops import _lib

    src = open(os.path.join(_lib.CSRC, "dwconv_int8.cu")).read()
    procs = {}
    for name, (old, new) in DW_ABLATIONS.items():
        if old not in src:
            raise RuntimeError(f"ablation {name}: its edit does not apply to {_lib.CSRC}")
        d = os.path.join(_lib.BUILD_DIR, f"ablate_{name}")
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(_lib.CSRC):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(_lib.CSRC, f), d)
        with open(os.path.join(d, "dwconv_int8.cu"), "w") as f:
            f.write(src.replace(old, new))
        so = os.path.join(d, "libdwconv_int8.so")
        procs[name] = (subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique", "-o", so,
             os.path.join(d, "dwconv_int8.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {name} failed to build:\n{out}")
        fn = ctypes.CDLL(so).ievm_dwconv_int8
        fn.argtypes = _lib.KERNELS["dwconv_int8"][1]["ievm_dwconv_int8"]
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
        for name, fn in ablated_kernels(root).items():
            _lib._fns["ievm_dwconv_int8"] = fn
            per = timed()
            out["ablations"][name] = {"total_ms": sum(per.values()), "ms": per}
        _lib._fns["ievm_dwconv_int8"] = kernel
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
    ap.add_argument("--ablate", action="store_true",
                    help="with --dwconv: also kernel E with its epilogue, taps or staging "
                         "taken out")
    args = ap.parse_args()
    if args.ablate and not args.dwconv:
        ap.error("--ablate goes with --dwconv")
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("port_block_launches: no CUDA device", file=sys.stderr)
        return 1
    if args.resnet or args.dwconv:
        root = os.path.abspath(args.root)
        res = resnet(root, args.batch) if args.resnet else dwconv(root, args.batch, args.ablate)
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
