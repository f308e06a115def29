"""Plain PyTorch reference of a static-INT8 ResNet (basic blocks) artifact.

It reads the artifact with the benchmark's own msgpack reader and computes
the network the artifact defines, in the arithmetic the served executor
states (the JAX package's static-INT8 executor):

* activations are quint8 codes q with a scale s and zero point zp; a conv
  sums (q - zp) * w_q exactly, then y = float32(sum) * float32(s_w * s_in)
  + bias in float32;
* the stem folds the ImageNet normalization: raw pixels u - 128 in the
  space-to-depth layout, padded (2, 1) with -128, through the 4x4 kernel
  ``w4_q``; y + E4, ReLU, requantized by division. E4 is derived here again
  from the stored float kernel ``w_fp``: conv(-mean/std, W) + 128 s_w sum(w4_q);
* a block's conv1 is ReLU and requantized by a multiply with 1/s (float32);
  conv2 adds the identity (the block input dequantized, or the downsample's
  float32 output), ReLU, requantized by division;
* the head dequantizes, averages over the map in float32, quantizes the
  features by division and runs the int8 fc to float32 logits.

``bits=4`` gives the control: the same network on the int4 grid
(``common.Grid``). Nothing here imports the program under test.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .common import (IMAGENET_MEAN, IMAGENET_STD, Grid, conv_nhwc, f32, inv32, read_spec,
                     requant_div, requant_mul, to_dev)
from .msgpack_reader import read_checkpoint

CHECKPOINT = "model_static_int8.msgpack"


def remap_stem_s2d(w: torch.Tensor) -> torch.Tensor:
    """(7, 7, C, O) stride-2 kernel -> the (4, 4, 4C, O) stride-1 kernel over
    the space-to-depth(2) input padded (2, 1): W4[k, l, (sy, sx, c)] =
    W[2k + sy - 1, 2l + sx - 1, c] where that index lies in [0, 6], else 0."""
    _, _, c, o = w.shape
    w4 = torch.zeros((4, 4, 4 * c, o), dtype=w.dtype)
    for k in range(4):
        for sy in range(2):
            dy = 2 * k + sy - 1
            if not 0 <= dy <= 6:
                continue
            for l in range(4):
                for sx in range(2):
                    dx = 2 * l + sx - 1
                    if 0 <= dx <= 6:
                        w4[k, l, (sy * 2 + sx) * c : (sy * 2 + sx + 1) * c] = w[dy, dx]
    return w4


def stem_offsets(stem: dict, w4_q: np.ndarray, w4_scale: np.ndarray) -> np.ndarray:
    """E4 (1, H/2, W/2, C), float32 on the CPU: the normalization's offset
    through the stem, conv_zero-pad(d, W_fp) in the s2d form, plus 128 s_w
    sum(w4_q)."""
    d = -torch.tensor(IMAGENET_MEAN, dtype=torch.float32) / torch.tensor(IMAGENET_STD,
                                                                          dtype=torch.float32)
    h, w = (int(v) for v in np.asarray(stem["input_hw"]))
    w_fp = torch.from_numpy(np.array(stem["w_fp"], np.float32))
    d12 = d.repeat(4).reshape(1, 12, 1, 1).expand(1, 12, h // 2, w // 2)
    conv_d4 = F.conv2d(F.pad(d12, (2, 1, 2, 1)), remap_stem_s2d(w_fp).permute(3, 2, 0, 1))
    w4 = torch.from_numpy(np.array(w4_q, np.float32))
    s4 = torch.from_numpy(np.array(w4_scale, np.float32))
    e4 = conv_d4.permute(0, 2, 3, 1) + 128.0 * s4 * w4.sum(dim=(0, 1, 2))
    return e4.contiguous().numpy()


def block_stride(s: int, b: int) -> int:
    return 2 if (s > 0 and b == 0) else 1


class ResNetInt8Reference:
    """The artifact in ``config_dir`` on ``device``; call it on raw uint8
    images (N, H, W, 3) on that device -> float32 logits (N, classes)."""

    def __init__(self, config_dir: str, device, bits: int = 8):
        spec = read_spec(config_dir)
        if spec.get("block", "basic") != "basic" or spec.get("groups", 1) != 1:
            raise NotImplementedError("the reference computes basic-block ResNets")
        self.depths = list(spec["depths"])
        self.grid = g = Grid(bits)
        self.dev = dev = torch.device(device)
        tree = read_checkpoint(os.path.join(config_dir, CHECKPOINT))

        st = tree["stem"]
        w4, s4 = g.weight(st["w4_q"], st["w4_scale"])
        self.stem = {
            "w": to_dev(w4, dev, torch.float64),
            "eff": to_dev(s4 * np.float32(1.0), dev, torch.float32),
            "bias": to_dev(np.asarray(st["bias"], np.float32), dev, torch.float32),
            "e4": to_dev(stem_offsets(st, w4, s4), dev, torch.float32),
            "out": g.act(st["out_scale"], st["out_zp"]),
        }
        self.blocks = []
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                blk = tree[f"layer{s + 1}"][str(b)]
                self.blocks.append({
                    "stride": block_stride(s, b),
                    **{k: self._conv(blk[k]) for k in ("conv1", "conv2", "down") if k in blk},
                    "a": g.act(blk["conv1"]["out_scale"], blk["conv1"]["out_zp"]),
                    "out": g.act(blk["out_scale"], blk["out_zp"]),
                })
        self.fc = self._conv(tree["fc"])
        self.fc_in = g.act(tree["fc"]["in_scale"], tree["fc"]["in_zp"])

    def _conv(self, leaf):
        w, s = self.grid.weight(leaf["w_q"], leaf["w_scale"])
        return (to_dev(w, self.dev, torch.float64), s,
                to_dev(np.asarray(leaf["bias"], np.float32), self.dev, torch.float32))

    def _affine(self, acc: torch.Tensor, w_scale: np.ndarray, in_scale, bias) -> torch.Tensor:
        """float32(acc) * float32(s_w * s_in) + bias."""
        eff = torch.from_numpy(w_scale * np.float32(in_scale)).to(self.dev)
        return acc.float() * eff + bias

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        g = self.grid
        n, h, w, c = images.shape
        x = images.to(torch.float64).reshape(n, h // 2, 2, w // 2, 2, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c) - 128.0
        st = self.stem
        acc = conv_nhwc(x, st["w"], pad=(2, 1, 2, 1), value=-128.0)
        y = acc.float() * st["eff"] + st["bias"]
        q_s, zp = st["out"]
        q = requant_div(torch.relu(y + st["e4"]), q_s, zp, g)
        q = F.max_pool2d(q.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)

        for blk in self.blocks:
            stride = blk["stride"]
            centered = (q - zp).double()
            if "down" in blk:
                wd, sd, bd = blk["down"]
                identity = self._affine(conv_nhwc(centered, wd, stride=stride), sd, q_s, bd)
            else:
                identity = (q - zp) * f32(q_s)
            w1, s1, b1 = blk["conv1"]
            y1 = torch.clamp_min(
                self._affine(conv_nhwc(centered, w1, stride=stride, pad=1), s1, q_s, b1), 0.0)
            a_s, a_zp = blk["a"]
            a = requant_mul(y1, inv32(a_s), a_zp, g)
            w2, s2, b2 = blk["conv2"]
            y2 = self._affine(conv_nhwc((a - a_zp).double(), w2, pad=1), s2, a_s, b2)
            q_s, zp = blk["out"]
            q = requant_div(torch.relu(y2 + identity), q_s, zp, g)

        feats = ((q - zp) * f32(q_s)).contiguous().mean(dim=(1, 2))
        f_s, f_zp = self.fc_in
        xq = requant_div(feats, f_s, f_zp, g)
        wf, sf, bf = self.fc
        return self._affine((xq - f_zp).double() @ wf, sf, f_s, bf)

Reference = ResNetInt8Reference
