"""Plain PyTorch reference of a static-INT8 EfficientNet artifact served by
the fused MBConv executor.

It reads the artifact with the benchmark's own msgpack reader and computes
the network in the arithmetic the fused executor states (the JAX package's
``fusedpath``), working out again everything that executor derives at load:
the per-block scalars, the expand and project biases with the zero-point
corrections folded in, the dequantized SE weights and the stem's offset map.

* stem: raw pixels u - 128 padded with -128, the 3x3 stride-2 int8 conv,
  y = float32(sum) * s_w + bias + E (E = conv(-mean/std, W_fp) +
  128 s_w sum(w_q), derived here on the CPU), SiLU, requantized by division;
* each block: expand (int8 GEMM of the shifted input, y = sum * ve0 + ve1,
  SiLU, requant by 1/s) -> depthwise over the centered codes, exact in
  float32 (y = sum * vdw0 + vdw1, SiLU, requant by 1/s) -> SE gate in
  float64 from the exact integer sums of the codes, rounded to float32 once
  -> the gated map requantized by 1/s -> project (int8 GEMM, y = sum * vp0
  + vp1) plus the dequantized input where the block has a residual ->
  requant by 1/s;
* head: the 1x1 conv, SiLU as y * sigmoid(y), requant by division, the mean
  of the dequantized map in float32, the int8 fc to float32 logits.

SiLU inside the blocks and the stem is y * (1 / (1 + exp(-y))), as the
fused executor states it. ``bits=4`` gives the control on the int4 grid
(``common.Grid``). Nothing here imports the program under test.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .common import (IMAGENET_MEAN, IMAGENET_STD, Grid, conv_nhwc, f32, read_spec, requant_div,
                     requant_mul, to_dev)
from .msgpack_reader import read_checkpoint

CHECKPOINT = "model_static_int8.msgpack"


def silu_k(y: torch.Tensor) -> torch.Tensor:
    return y * torch.reciprocal(1.0 + torch.exp(-y))


def stem_offsets(stem: dict, w_q: np.ndarray, w_scale: np.ndarray) -> np.ndarray:
    """E (1, Ho, Wo, C) float32 on the CPU: conv_zero-pad(d, W_fp) + 128 s_w sum(w_q)."""
    w_fp = torch.from_numpy(np.array(stem["w_fp"], np.float32))
    cin = w_fp.shape[2]
    d = -(np.asarray(IMAGENET_MEAN[:cin], np.float32) / np.asarray(IMAGENET_STD[:cin],
                                                                   np.float32))
    h, w = (int(v) for v in np.asarray(stem["input_hw"]))
    d_img = torch.from_numpy(d).reshape(1, cin, 1, 1).expand(1, cin, h, w)
    conv_d = F.conv2d(d_img, w_fp.permute(3, 2, 0, 1), stride=int(stem["stride"]),
                      padding=int(stem["pad"]))
    wq = np.asarray(w_q, np.float32)
    ws = np.asarray(w_scale, np.float32)
    e = conv_d.permute(0, 2, 3, 1).numpy() + 128.0 * ws * wq.sum(axis=(0, 1, 2))
    return np.ascontiguousarray(e, np.float32)


def block_plan(spec: dict):
    """(stage, block, kernel, stride, residual) of every MBConv block."""
    plan = []
    for s, depth in enumerate(spec["depths"]):
        for b in range(depth):
            stride = spec["stage_strides"][s] if b == 0 else 1
            cin = spec["stage_widths"][s] if b > 0 else (
                spec["stem_width"] if s == 0 else spec["stage_widths"][s - 1])
            residual = stride == 1 and cin == spec["stage_widths"][s]
            plan.append((s, b, spec["stage_kernels"][s], stride, residual))
    return plan


class EffNetInt8FusedReference:
    """The artifact in ``config_dir`` on ``device``; call it on raw uint8
    images (N, H, W, 3) on that device -> float32 logits (N, classes)."""

    def __init__(self, config_dir: str, device, bits: int = 8):
        spec = read_spec(config_dir)
        if spec.get("__kind__") != "efficientnet":
            raise NotImplementedError("the reference computes EfficientNet artifacts")
        self.grid = g = Grid(bits)
        self.dev = dev = torch.device(device)
        tree = read_checkpoint(os.path.join(config_dir, CHECKPOINT))

        st = tree["stem"]
        w, s = g.weight(st["w_q"], st["w_scale"])
        self.stem = {
            "w": to_dev(w, dev, torch.float64),
            "eff": to_dev(s * np.float32(1.0), dev, torch.float32),
            "bias": to_dev(np.asarray(st["bias"], np.float32), dev, torch.float32),
            "e": to_dev(stem_offsets(st, w, s), dev, torch.float32),
            "stride": int(st["stride"]), "pad": int(st["pad"]),
            "out": g.act(st["out_scale"], st["out_zp"]),
        }
        self.blocks = []
        cur = self.stem["out"]
        for s_, b, k, stride, residual in block_plan(spec):
            blk = tree[f"stage{s_}"][str(b)]
            self.blocks.append(self._pack(blk, cur, k, stride, residual))
            cur = g.act(blk["out_scale"], blk["out_zp"])
        last = tree["last"]
        wl, sl = g.weight(last["w_q"], last["w_scale"])
        self.last = {"w": to_dev(wl, dev, torch.float64),
                     "eff": to_dev(sl * np.float32(cur[0]), dev, torch.float32),
                     "bias": to_dev(np.asarray(last["bias"], np.float32), dev, torch.float32),
                     "in": cur, "out": g.act(last["out_scale"], last["out_zp"])}
        fc = tree["fc"]
        wf, sf = g.weight(fc["w_q"], fc["w_scale"])
        f_in = g.act(fc["in_scale"], fc["in_zp"])
        self.fc = {"w": to_dev(wf, dev, torch.float64),
                   "eff": to_dev(sf * np.float32(f_in[0]), dev, torch.float32),
                   "bias": to_dev(np.asarray(fc["bias"], np.float32), dev, torch.float32),
                   "in": f_in}

    def _pack(self, blk: dict, cur, kernel: int, stride: int, residual: bool) -> dict:
        """One block's operands and float32 scalars, as the fused executor
        derives them from the converted leaves."""
        g, dev = self.grid, self.dev
        in_scale, in_zp = cur
        zp_s = np.float32(in_zp - 128.0)
        out = {"kernel": kernel, "stride": stride, "residual": residual,
               "zp_s_in": float(zp_s), "res_scale": f32(in_scale)}
        if "expand" in blk:
            e = blk["expand"]
            we, se = g.weight(e["w_q"], e["w_scale"])
            eff = np.float32(in_scale) * se
            w_sum = we.sum(axis=tuple(range(we.ndim - 1))).astype(np.float32)
            out["we"] = to_dev(we.reshape(-1, we.shape[-1]), dev, torch.float64)
            out["ve0"] = to_dev(eff, dev, torch.float32)
            out["ve1"] = to_dev(np.asarray(e["bias"], np.float32) - zp_s * w_sum * eff, dev,
                                torch.float32)
            e_s, e_zp = g.act(e["out_scale"], e["out_zp"])
            out["inv_e"], out["e_zp"] = f32(1.0 / float(e_s)), float(np.float32(e_zp))
            dw_in_scale = float(e_s)
        else:
            dw_in_scale = float(in_scale)
        d = blk["dw"]
        wd, sd = g.weight(d["w_q"], d["w_scale"])
        out["wdw"] = to_dev(wd, dev, torch.float64)  # (k, k, 1, Ce): a grouped HWIO kernel
        out["vdw0"] = to_dev(np.float32(dw_in_scale) * sd, dev, torch.float32)
        out["vdw1"] = to_dev(np.asarray(d["bias"], np.float32), dev, torch.float32)
        d_s, d_zp = g.act(d["out_scale"], d["out_zp"])
        out["inv_d"], out["d_zp"], out["d_scale"] = f32(1.0 / float(d_s)), f32(d_zp), f32(d_s)

        def deq_se(leaf):
            w_, s_ = g.weight(leaf["w_q"], leaf["w_scale"])
            return to_dev(w_.astype(np.float32) * s_, dev, torch.float64)

        out["srw"] = deq_se(blk["se_reduce"])
        out["srb"] = to_dev(np.asarray(blk["se_reduce"]["b"], np.float32), dev, torch.float64)
        out["sew"] = deq_se(blk["se_expand"])
        out["seb"] = to_dev(np.asarray(blk["se_expand"]["b"], np.float32), dev, torch.float64)
        q_s, q_zp = g.act(blk["se_scale"], blk["se_zp"])
        out["inv_q"], out["q_zp"] = f32(1.0 / float(q_s)), f32(q_zp)

        p = blk["project"]
        wp, sp = g.weight(p["w_q"], p["w_scale"])
        effp = np.float32(q_s) * sp
        wp_sum = wp.sum(axis=tuple(range(wp.ndim - 1))).astype(np.float32)
        out["wp"] = to_dev(wp.reshape(-1, wp.shape[-1]), dev, torch.float64)
        out["vp0"] = to_dev(effp, dev, torch.float32)
        out["vp1"] = to_dev(np.asarray(p["bias"], np.float32)
                            - np.float32(q_zp - 128.0) * wp_sum * effp, dev, torch.float32)
        o_s, o_zp = g.act(blk["out_scale"], blk["out_zp"])
        out["inv_o"], out["o_zp"] = f32(1.0 / float(o_s)), f32(o_zp)
        return out

    def _block(self, q: torch.Tensor, p: dict) -> torch.Tensor:
        """quint codes (N, H, W, Cin) float32 -> the block's output codes."""
        g = self.grid
        n, h, w, cin = q.shape
        if "we" in p:
            acc = (q - 128.0).double().reshape(-1, cin) @ p["we"]
            y = silu_k(acc.float() * p["ve0"] + p["ve1"])
            hidden = (requant_mul(y, p["inv_e"], p["e_zp"], g) - p["e_zp"]).reshape(n, h, w, -1)
        else:
            hidden = (q - 128.0) - p["zp_s_in"]
        k, stride = p["kernel"], p["stride"]
        acc = conv_nhwc(hidden.double(), p["wdw"], stride=stride, pad=(k - 1) // 2,
                        groups=hidden.shape[-1]).float()
        yq = requant_mul(silu_k(acc * p["vdw0"] + p["vdw1"]), p["inv_d"], p["d_zp"], g)
        ho, wo = yq.shape[1:3]
        pool = (yq - p["d_zp"]).double().sum(dim=(1, 2))
        pooled = pool * (p["d_scale"] / (ho * wo))
        r = pooled @ p["srw"] + p["srb"]
        r = r * torch.reciprocal(1.0 + torch.exp(-r))
        v = r @ p["sew"] + p["seb"]
        gate = torch.reciprocal(1.0 + torch.exp(-v)).float()
        hf = (yq - p["d_zp"]) * p["d_scale"] * gate[:, None, None, :]
        hq = requant_mul(hf, p["inv_q"], p["q_zp"], g) - 128.0
        accp = hq.double().reshape(-1, hq.shape[-1]) @ p["wp"]
        yp = (accp.float() * p["vp0"] + p["vp1"]).reshape(n, ho, wo, -1)
        if p["residual"]:
            yp = yp + ((q - 128.0) - p["zp_s_in"]) * p["res_scale"]
        return requant_mul(yp, p["inv_o"], p["o_zp"], g)

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        g = self.grid
        st = self.stem
        x = images.to(torch.float64) - 128.0
        acc = conv_nhwc(x, st["w"], stride=st["stride"], pad=st["pad"], value=-128.0)
        y = silu_k(acc.float() * st["eff"] + st["bias"] + st["e"])
        q = requant_div(y, *st["out"], g)
        for p in self.blocks:
            q = self._block(q, p)
        la = self.last
        in_s, in_zp = la["in"]
        acc = (q - in_zp).double().reshape(-1, q.shape[-1]) @ la["w"]
        y = (acc.float() * la["eff"] + la["bias"]).reshape(*q.shape[:3], -1)
        o_s, o_zp = la["out"]
        h = requant_div(y * torch.sigmoid(y), o_s, o_zp, g)
        feats = ((h - o_zp) * f32(o_s)).contiguous().mean(dim=(1, 2))
        fc = self.fc
        f_s, f_zp = fc["in"]
        xq = requant_div(feats, f_s, f_zp, g)
        return ((xq - f_zp).double() @ fc["w"]).float() * fc["eff"] + fc["bias"]

Reference = EffNetInt8FusedReference
