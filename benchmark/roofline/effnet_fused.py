"""The work of each layer of a static-INT8 EfficientNet artifact as the
fused executor runs it, from its spec alone (the same rules as
``resnet.py``): the stem, the 1x1 head conv and the fc in the group
``conv_gemm`` (kernel A), each MBConv block whole in the group ``mbconv``
(kernel C: expand, depthwise, SE gate, project and residual in one unit of
work, so only the block's input, weights and output must move).

A block's operations: the expand's and project's int8 MACs and the
depthwise int8 MACs, all at the card's int8 rate (an implementation may
take the depthwise to the tensor cores or to dp4a: the bound holds for
any), and the SE gate's float64 multiply-adds (the configuration states a
float64 gate) at the float64 rate. Its bytes: the input and output maps at
one byte a value, every weight at one byte (the artifact's int8), 8 bytes of
scale and bias per channel of each conv and 4 of bias per SE unit.
"""

from __future__ import annotations

from typing import Dict, List

from .resnet import _conv


def layers(spec: Dict, batch: int, image_hw=(224, 224)) -> List[Dict]:
    n = batch
    h, w = image_hw
    stem = _conv("stem", n, h, w, spec.get("in_chans", 3), spec["stem_width"], 3, 2)
    out = [stem]
    h, w = stem["out_hw"]
    cin = spec["stem_width"]
    for s, depth in enumerate(spec["depths"]):
        k = spec["stage_kernels"][s]
        cout = spec["stage_widths"][s]
        for b in range(depth):
            stride = spec["stage_strides"][s] if b == 0 else 1
            ce = spec["hidden_widths"][s][b]
            cse = spec["se_widths"][s][b]
            expand = spec["has_expand"][s][b]
            pad = (k - 1) // 2
            ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
            mac_e = n * h * w * cin * ce if expand else 0
            mac_dw = n * ho * wo * ce * k * k
            mac_p = n * ho * wo * ce * cout
            fma_se = n * 2 * ce * cse
            weights = ((cin * ce + 8 * ce) if expand else 0) + k * k * ce + 8 * ce \
                + 2 * ce * cse + 4 * (ce + cse) + ce * cout + 8 * cout
            out.append({"name": f"stage{s}.{b}", "group": "mbconv",
                        "macs": mac_e + mac_dw + mac_p + fma_se,
                        "int8_ops": 2 * (mac_e + mac_dw + mac_p), "fp64_fma": fma_se,
                        "bytes": n * h * w * cin + weights + n * ho * wo * cout,
                        "out_hw": (ho, wo)})
            h, w, cin = ho, wo, cout
    last = _conv("last", n, h, w, cin, spec["last_width"], 1, 1)
    out.append(last)
    out.append(_conv("fc", n, 1, 1, spec["last_width"], spec["num_classes"], 1, 1, in_bytes=4,
                     out_bytes=4))
    return out
