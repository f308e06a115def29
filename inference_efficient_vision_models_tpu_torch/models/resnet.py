"""Functional float ResNet (BasicBlock / Bottleneck), the port of the JAX
package's ``models/resnet.py``.

Plain functions on nested dicts of tensors, with the JAX package's keys:
``init(spec, generator) -> (params, state)`` and ``apply(spec, params, state,
x) -> (logits, new_state)``. torchvision's architecture: 7x7/2 stem conv
(pad 3) -> BN -> ReLU -> 3x3/2 max pool (pad 1) -> four stages of blocks ->
global average pool -> linear head, with explicit symmetric padding.

Layouts: conv kernels are OIHW and activations NCHW tensors; on the GPU both
are kept in channels-last memory, so cuDNN runs its NHWC kernels and
``apply`` takes NHWC images without a copy (on the CPU they are contiguous:
oneDNN's channels-last backward of a strided 1x1 conv crashes at some
shapes in PyTorch 2.13). The fc weight is (in, out) as in JAX.
``params_from_jax`` / ``params_to_jax`` convert from and to the JAX layouts
(HWIO convs), in which checkpoints are stored.

Casts follow the JAX package, not ``torch.autocast``: each conv casts its
input and kernel to the compute dtype and emits that dtype; BatchNorm
computes in fp32 and casts back; the pooled features and the fc are fp32.
Training-mode BatchNorm normalizes with the biased batch variance and
tracks the running statistics with the unbiased one (momentum 0.1, eps
1e-5). fp32 forwards run with TF32 off (``utils.device.exact_fp32``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import bn_group, sum_over
from ..utils.device import DeviceLike, exact_fp32, resolve_device
from .widths import ResNetSpec

Params = Dict[str, Any]
State = Dict[str, Any]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


# --------------------------------------------------------------------------
# primitive layers
# --------------------------------------------------------------------------


def conv2d(x, w, stride: int = 1, padding: int = 0, dtype=None, groups: int = 1):
    """NCHW-view conv with torch-style symmetric padding; ``dtype`` casts the
    input and the kernel first (the output has that dtype)."""
    if dtype is not None:
        x = x.to(dtype)
        w = w.to(dtype)
    return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)


def batch_norm(x, p, s, *, train: bool, momentum: float = BN_MOMENTUM):
    """Functional batch norm in fp32, cast back to ``x.dtype``; returns
    (y, new_running_stats). In training mode the new statistics are fresh
    tensors: ``s`` is left as it was; inside a step over a mesh
    (``parallel.mesh.GlobalView``) they are the whole batch's, summed over
    the data axis."""
    x32 = x.float()
    if train and bn_group() is not None:
        y, new_s = _batch_norm_global(x32, p, s, momentum, bn_group())
    elif train:
        mean, var = s["mean"].clone(), s["var"].clone()
        y = F.batch_norm(x32, mean, var, p["scale"], p["bias"], training=True,
                         momentum=momentum, eps=BN_EPS)
        new_s = {"mean": mean, "var": var}
    else:
        y = F.batch_norm(x32, s["mean"], s["var"], p["scale"], p["bias"], training=False,
                         eps=BN_EPS)
        new_s = s
    return y.to(x.dtype), new_s


def _batch_norm_global(x32, p, s, momentum: float, group):
    """Training BatchNorm over the batch of every rank of ``group``
    (SyncBatchNorm): two-pass mean and biased variance from differentiable
    sums, running statistics with the unbiased variance."""
    c = x32.shape[1]
    dims = (0, 2, 3)
    count = sum_over(torch.full((), float(x32.numel() // c), device=x32.device), group)
    mean = sum_over(x32.sum(dims), group) / count
    xc = x32 - mean.view(1, c, 1, 1)
    var = sum_over((xc * xc).sum(dims), group) / count
    y = (xc * torch.rsqrt(var + BN_EPS).view(1, c, 1, 1) * p["scale"].view(1, c, 1, 1)
         + p["bias"].view(1, c, 1, 1))
    with torch.no_grad():
        new_s = {"mean": (1 - momentum) * s["mean"] + momentum * mean,
                 "var": (1 - momentum) * s["var"] + momentum * var * (count / (count - 1))}
    return y, new_s


def max_pool(x, window: int = 3, stride: int = 2, padding: int = 1):
    return F.max_pool2d(x, window, stride, padding)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


def _conv_w(t: torch.Tensor) -> torch.Tensor:
    """A conv kernel or activation in its device's memory layout."""
    return t.contiguous(memory_format=torch.channels_last if t.is_cuda
                        else torch.contiguous_format)


def place(tree, device: DeviceLike = None):
    """A params/state tree moved to ``device``, conv kernels in its layout."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: place(v, dev) for k, v in tree.items()}
    t = tree.to(dev)
    return _conv_w(t) if t.ndim == 4 else t


def init(spec: ResNetSpec, generator: torch.Generator, device: DeviceLike = None
         ) -> Tuple[Params, State]:
    """Random parameters drawn as the JAX ``init`` draws them (not the same
    numbers: ``generator`` is torch's): Kaiming-normal fan_out convs, unit BN,
    a uniform ±1/sqrt(in) fc. On the GPU unless ``device="cpu"``; the draws
    happen on the generator's device and move."""
    dev = resolve_device(device)

    def conv(kh, kw, cin, cout):
        std = math.sqrt(2.0 / (kh * kw * cout))
        w = torch.randn((cout, cin, kh, kw), generator=generator, device=generator.device)
        return {"w": _conv_w((w * std).to(dev))}

    def bn(c):
        return ({"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)},
                {"mean": torch.zeros(c, device=dev), "var": torch.ones(c, device=dev)})

    params: Params = {"conv1": conv(7, 7, spec.in_chans, spec.stem_width)}
    state: State = {}
    params["bn1"], state["bn1"] = bn(spec.stem_width)
    for s, depth in enumerate(spec.depths):
        lp, ls = {}, {}
        for b in range(depth):
            cin, cout = spec.block_in_width(s, b), spec.stage_widths[s]
            inner = spec.inner_widths[s][b]
            bp, bs = {}, {}
            if spec.block == "basic":
                (w1,) = inner
                bp["conv1"] = conv(3, 3, cin, w1)
                bp["bn1"], bs["bn1"] = bn(w1)
                bp["conv2"] = conv(3, 3, w1, cout)
                bp["bn2"], bs["bn2"] = bn(cout)
            else:
                w1, w2 = inner
                if w1 % spec.groups:
                    raise ValueError(f"inner width {w1} is not a multiple of groups={spec.groups}")
                bp["conv1"] = conv(1, 1, cin, w1)
                bp["bn1"], bs["bn1"] = bn(w1)
                bp["conv2"] = conv(3, 3, w1 // spec.groups, w2)
                bp["bn2"], bs["bn2"] = bn(w2)
                bp["conv3"] = conv(1, 1, w2, cout)
                bp["bn3"], bs["bn3"] = bn(cout)
            if spec.has_downsample(s, b):
                bp["down_conv"] = conv(1, 1, cin, cout)
                bp["down_bn"], bs["down_bn"] = bn(cout)
            lp[str(b)], ls[str(b)] = bp, bs
        params[f"layer{s + 1}"], state[f"layer{s + 1}"] = lp, ls
    cin = spec.stage_widths[-1]
    bound = 1.0 / math.sqrt(cin)
    u = torch.rand((cin + 1, spec.num_classes), generator=generator, device=generator.device)
    u = (u * (2 * bound) - bound).to(dev)
    params["fc"] = {"w": u[:cin].contiguous(), "b": u[cin].contiguous()}
    return params, state


def params_from_jax(tree, device: DeviceLike = None):
    """The JAX package's ResNet params or state (nested dicts of numpy arrays,
    HWIO convs) -> the port's: fp32 tensors on ``device``, OIHW convs (in
    channels-last memory on the GPU). Also converts AdamW moments, which share the
    params' structure."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, np.float32))
    return place(t.permute(3, 2, 0, 1) if t.ndim == 4 else t, dev)


def params_to_jax(tree):
    """The inverse of ``params_from_jax``: nested dicts of fp32 numpy arrays
    (C-contiguous copies, never views of the tensors), HWIO convs."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    t = tree.detach().float().cpu()
    if t.ndim == 4:
        t = t.permute(2, 3, 1, 0)
    return t.numpy().copy()


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return int(params.numel())


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def apply(
    spec: ResNetSpec,
    params: Params,
    state: State,
    x: torch.Tensor,
    *,
    train: bool = False,
    compute_dtype=torch.float32,
    return_features: bool = False,
):
    """Forward: NHWC float images -> (logits fp32, new_state), or with
    ``return_features`` the pooled fp32 features instead of the logits."""
    with exact_fp32():
        new_state: State = {}
        h = _conv_w(x.permute(0, 3, 1, 2))  # on the GPU: an NCHW view of the NHWC batch
        h = conv2d(h, params["conv1"]["w"], stride=2, padding=3, dtype=compute_dtype)
        h, new_state["bn1"] = batch_norm(h, params["bn1"], state["bn1"], train=train)
        h = max_pool(F.relu(h), 3, 2, 1)
        for s, depth in enumerate(spec.depths):
            lname = f"layer{s + 1}"
            new_state[lname] = {}
            for b in range(depth):
                h, new_state[lname][str(b)] = _apply_block(
                    spec, params[lname][str(b)], state[lname][str(b)], h, s, b,
                    train=train, compute_dtype=compute_dtype)
        feats = h.float().mean(dim=(2, 3))  # global average pool
        if return_features:
            return feats, new_state
        return feats @ params["fc"]["w"] + params["fc"]["b"], new_state


def _apply_block(spec, p, st, x, s, b, *, train, compute_dtype):
    stride = spec.block_stride(s, b)
    new_st: State = {}
    identity = x
    if spec.block == "basic":
        out = conv2d(x, p["conv1"]["w"], stride=stride, padding=1, dtype=compute_dtype)
        out, new_st["bn1"] = batch_norm(out, p["bn1"], st["bn1"], train=train)
        out = conv2d(F.relu(out), p["conv2"]["w"], stride=1, padding=1, dtype=compute_dtype)
        out, new_st["bn2"] = batch_norm(out, p["bn2"], st["bn2"], train=train)
    else:
        out = conv2d(x, p["conv1"]["w"], stride=1, padding=0, dtype=compute_dtype)
        out, new_st["bn1"] = batch_norm(out, p["bn1"], st["bn1"], train=train)
        out = conv2d(F.relu(out), p["conv2"]["w"], stride=stride, padding=1,
                     dtype=compute_dtype, groups=spec.groups)
        out, new_st["bn2"] = batch_norm(out, p["bn2"], st["bn2"], train=train)
        out = conv2d(F.relu(out), p["conv3"]["w"], stride=1, padding=0, dtype=compute_dtype)
        out, new_st["bn3"] = batch_norm(out, p["bn3"], st["bn3"], train=train)
    if spec.has_downsample(s, b):
        identity = conv2d(x, p["down_conv"]["w"], stride=stride, padding=0, dtype=compute_dtype)
        identity, new_st["down_bn"] = batch_norm(identity, p["down_bn"], st["down_bn"],
                                                 train=train)
    return F.relu(out + identity), new_st
