"""The work of each layer of a basic-block ResNet static-INT8 artifact, from
its spec alone: what any implementation of the layer must read, write and
compute, never what a launch's arguments hold (no patch matrix, no
space-to-depth padding, no K padding).

Each layer reads each input once and writes its output once: int8
activations (the raw uint8 image into the stem), int8 weights, 8 bytes of
scale and bias per output channel; the outputs that the network keeps in
float32 (a downsample's output, which the block adds as the identity, the
fc's input features and its logits) at 4 bytes. A 1x1 stride-2 downsample
needs only the pixels it reads. MACs are int8 multiply-adds (2 operations
each). The int8 executor computes all of them with kernels A and B, so every
layer belongs to the group ``conv_gemm``.
"""

from __future__ import annotations

from typing import Dict, List


def _conv(name, n, h, w, cin, cout, k, stride, *, in_bytes=1, out_bytes=1, extra_in=0,
          read_in=None) -> Dict:
    pad = (k - 1) // 2
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    macs = n * ho * wo * cout * k * k * cin
    reads = read_in if read_in is not None else n * h * w * cin
    return {"name": name, "group": "conv_gemm", "macs": macs, "int8_ops": 2 * macs,
            "bytes": reads * in_bytes + k * k * cin * cout + 8 * cout
            + n * ho * wo * cout * out_bytes + extra_in, "out_hw": (ho, wo)}


def layers(spec: Dict, batch: int, image_hw=(224, 224)) -> List[Dict]:
    n = batch
    h, w = image_hw
    c0 = spec["stem_width"]
    out = [_conv("stem", n, h, w, spec.get("in_chans", 3), c0, 7, 2)]
    h, w = out[-1]["out_hw"]
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1  # the 3x3/s2 max pool (glue)
    cin = c0
    for s, depth in enumerate(spec["depths"]):
        cout = spec["stage_widths"][s]
        for b in range(depth):
            stride = 2 if (s > 0 and b == 0) else 1
            name = f"layer{s + 1}.{b}"
            c1 = _conv(f"{name}.conv1", n, h, w, cin, cout, 3, stride)
            ho, wo = c1["out_hw"]
            down = stride != 1 or cin != cout
            if down:
                out.append(_conv(f"{name}.down", n, h, w, cin, cout, 1, stride, out_bytes=4,
                                 read_in=n * ho * wo * cin))
            identity = n * ho * wo * cout * (4 if down else 1)
            out.append(c1)
            out.append(_conv(f"{name}.conv2", n, ho, wo, cout, cout, 3, 1, extra_in=identity))
            h, w, cin = ho, wo, cout
    out.append(_conv("fc", n, 1, 1, cin, spec["num_classes"], 1, 1, in_bytes=4, out_bytes=4))
    return out
