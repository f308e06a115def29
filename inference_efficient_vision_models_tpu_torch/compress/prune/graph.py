"""Channel-dependency graphs of a ResNet, an EfficientNet and a MobileNetV2
for structured pruning: the port's copy of the JAX package's
``compress/prune/graph.py`` (its CNN parts).

Every prunable width is one coupled group of parameter slices, derived
statically from the width descriptor:

* producers: conv kernels whose OUTPUT channel axis carries the width (HWIO
  axis 3) and the BatchNorms that normalize it (every vector, axis 0),
* consumers: conv kernels whose INPUT channel axis carries it (HWIO axis 2),
  and the classifier kernel's input rows for the last stage's group.

Residual adds couple a whole stage: every block output of a stage (with the
downsample branch, and the stem where it is tied to stage 0) shares one
group. The MBConv families add the depthwise edge: a depthwise kernel (k, k, 1, C) is a
PRODUCER (axis 3) of the group that carries its channels (the expand's
group, or the block's input group in a t=1 block); an EfficientNet's SE gate
couples twice (``se_expand``'s output columns and bias produce the hidden width,
``se_reduce``'s input rows consume it; the SE squeeze width is a free group
of its own). SE weights are (in, out) matrices, so their axes are 0 and 1;
``vectors`` lists 1-D biases sliced on axis 0. Paths are key tuples into
the params/state trees in the JAX layout (``params_to_jax``): the surgery
runs on those numpy trees, so the axes here are HWIO axes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ...models.efficientnet import EfficientNetSpec
from ...models.mobilenet import MobileNetV2Spec
from ...models.widths import ResNetSpec

Path = Tuple[str, ...]

OUT_AXIS = 3  # HWIO conv kernel output-channel axis
IN_AXIS = 2   # HWIO conv kernel input-channel axis


def _last_conv(spec: ResNetSpec) -> str:
    return "conv2" if spec.block == "basic" else "conv3"


def group_slices(spec) -> List[Dict]:
    """Coupled groups with their parameter slices. Each group dict:

      key:        ("stem",) | ("stage", s) | ("inner", s, b, i)   (ResNet)
                  ("stem",) | ("stage", s) | ("hidden", s, b) | ("se", s, b)
                  | ("last",)                       (EfficientNet; MobileNetV2
                                                    without "se")
      width:      current channel count
      producers:  [(w_path, axis), ...]   (conv OUT_AXIS, SE matrix 1)
      bns:        [bn_path_prefix, ...]   (scale/bias/mean/var, axis 0)
      consumers:  [(w_path, axis), ...]   (conv IN_AXIS, SE matrix 0)
      vectors:    [bias_path, ...]        (1-D, axis 0; EfficientNet SE)
      fc_in:      True if the fc kernel's rows (axis 0) are consumers
      lanes, grouped_in: a ResNeXt bottleneck's welded inner group, whose
                  channels go as whole lanes (see group_slices_resnet)
    """
    if isinstance(spec, EfficientNetSpec):
        return group_slices_effnet(spec)
    if isinstance(spec, MobileNetV2Spec):
        return group_slices_mbv2(spec)
    if not isinstance(spec, ResNetSpec):
        raise TypeError(
            f"no channel groups for {type(spec).__name__}: a ViT prunes its MLP units and "
            f"heads through compress/prune/vit_engine.py (engine.prune_model dispatches)")
    return group_slices_resnet(spec)


def _group(key, width, **kw) -> Dict:
    g = {"key": key, "width": width, "producers": [], "bns": [], "consumers": [],
         "vectors": [], "fc_in": False}
    g.update(kw)
    return g


def group_slices_mbv2(spec: MobileNetV2Spec) -> List[Dict]:
    """Coupled groups of a MobileNetV2: the stem, one group per stage
    (residual adds couple every block's project output with the next blocks'
    inputs), one free ``("hidden", s, b)`` group per block with an expand
    conv (expand output + depthwise kernel and BN + project input), and the
    head conv ``last``. A t=1 block has no hidden group: its depthwise
    kernel and BN ride its input's group."""
    groups: List[Dict] = []

    def attach_consumer(g: Dict, s: int, b: int) -> None:
        """Wire group g to block (s, b), whose INPUT carries g's width."""
        base = (f"stage{s}", str(b))
        if spec.has_expand[s][b]:
            g["consumers"].append((base + ("expand", "w"), IN_AXIS))
        else:
            g["producers"].append((base + ("dw", "w"), OUT_AXIS))
            g["bns"].append(base + ("dw_bn",))
            g["consumers"].append((base + ("project", "w"), IN_AXIS))

    stem = _group(("stem",), spec.stem_width, producers=[(("stem", "w"), OUT_AXIS)],
                  bns=[("stem_bn",)])
    attach_consumer(stem, 0, 0)
    groups.append(stem)
    for s, depth in enumerate(spec.depths):
        g = _group(("stage", s), spec.stage_widths[s])
        for b in range(depth):
            base = (f"stage{s}", str(b))
            g["producers"].append((base + ("project", "w"), OUT_AXIS))
            g["bns"].append(base + ("project_bn",))
            if b >= 1:
                attach_consumer(g, s, b)
        if s + 1 < len(spec.depths):
            attach_consumer(g, s + 1, 0)
        else:
            g["consumers"].append((("last", "w"), IN_AXIS))
        groups.append(g)
    for s, depth in enumerate(spec.depths):
        for b in range(depth):
            if spec.has_expand[s][b]:
                base = (f"stage{s}", str(b))
                groups.append(_group(
                    ("hidden", s, b), spec.hidden_widths[s][b],
                    producers=[(base + ("expand", "w"), OUT_AXIS), (base + ("dw", "w"), OUT_AXIS)],
                    bns=[base + ("expand_bn",), base + ("dw_bn",)],
                    consumers=[(base + ("project", "w"), IN_AXIS)]))
    groups.append(_group(("last",), spec.last_width, producers=[(("last", "w"), OUT_AXIS)],
                         bns=[("last_bn",)], fc_in=True))
    return groups


def group_slices_effnet(spec: EfficientNetSpec) -> List[Dict]:
    """Coupled groups of an EfficientNet: one group per stage (residual adds
    couple every block's project output with the next blocks' inputs), the
    stem, one free ``("hidden", s, b)`` group per block with an expand conv,
    one free ``("se", s, b)`` group per block, and the head conv ``last``."""
    groups: List[Dict] = []
    group = _group

    def attach_consumer(g: Dict, s: int, b: int) -> None:
        """Wire group g to block (s, b), whose INPUT carries g's width."""
        base = (f"stage{s}", str(b))
        if spec.has_expand[s][b]:
            g["consumers"].append((base + ("expand", "w"), IN_AXIS))
        else:
            # t=1: the depthwise conv and the SE gate act on g's channels
            g["producers"].append((base + ("dw", "w"), OUT_AXIS))
            g["producers"].append((base + ("se_expand", "w"), 1))
            g["vectors"].append(base + ("se_expand", "b"))
            g["bns"].append(base + ("dw_bn",))
            g["consumers"].append((base + ("project", "w"), IN_AXIS))
            g["consumers"].append((base + ("se_reduce", "w"), 0))

    stem = group(("stem",), spec.stem_width, producers=[(("stem", "w"), OUT_AXIS)],
                 bns=[("stem_bn",)])
    attach_consumer(stem, 0, 0)
    groups.append(stem)

    for s, depth in enumerate(spec.depths):
        g = group(("stage", s), spec.stage_widths[s])
        for b in range(depth):
            base = (f"stage{s}", str(b))
            g["producers"].append((base + ("project", "w"), OUT_AXIS))
            g["bns"].append(base + ("project_bn",))
            if b >= 1:
                attach_consumer(g, s, b)
        if s + 1 < len(spec.depths):
            attach_consumer(g, s + 1, 0)
        else:
            g["consumers"].append((("last", "w"), IN_AXIS))
        groups.append(g)

    for s, depth in enumerate(spec.depths):
        for b in range(depth):
            base = (f"stage{s}", str(b))
            if spec.has_expand[s][b]:
                groups.append(group(
                    ("hidden", s, b), spec.hidden_widths[s][b],
                    producers=[(base + ("expand", "w"), OUT_AXIS), (base + ("dw", "w"), OUT_AXIS),
                               (base + ("se_expand", "w"), 1)],
                    bns=[base + ("expand_bn",), base + ("dw_bn",)],
                    consumers=[(base + ("project", "w"), IN_AXIS), (base + ("se_reduce", "w"), 0)],
                    vectors=[base + ("se_expand", "b")]))
            groups.append(group(
                ("se", s, b), spec.se_widths[s][b],
                producers=[(base + ("se_reduce", "w"), 1)],
                consumers=[(base + ("se_expand", "w"), 0)],
                vectors=[base + ("se_reduce", "b")]))

    groups.append(group(("last",), spec.last_width, producers=[(("last", "w"), OUT_AXIS)],
                        bns=[("last_bn",)], fc_in=True))
    return groups


def group_slices_resnet(spec: ResNetSpec) -> List[Dict]:
    """Coupled groups of a ResNet (see group_slices for the dict contract)."""
    groups: List[Dict] = []
    lc = _last_conv(spec)

    def layer(s: int) -> str:
        return f"layer{s + 1}"

    n_stages = len(spec.depths)

    # stem group (only when NOT tied into stage 0)
    if not spec.stem_tied_to_stage0:
        consumers = [((layer(0), "0", "conv1", "w"), IN_AXIS)]
        if spec.has_downsample(0, 0):
            consumers.append(((layer(0), "0", "down_conv", "w"), IN_AXIS))
        groups.append({
            "key": ("stem",),
            "width": spec.stem_width,
            "producers": [(("conv1", "w"), OUT_AXIS)],
            "bns": [("bn1",)],
            "consumers": consumers,
            "fc_in": False,
        })

    # one residual group per stage
    for s, depth in enumerate(spec.depths):
        producers: List[Tuple[Path, int]] = []
        bns: List[Path] = []
        consumers: List[Tuple[Path, int]] = []

        if s == 0 and spec.stem_tied_to_stage0:
            producers.append((("conv1", "w"), OUT_AXIS))
            bns.append(("bn1",))
            # block 0 consumes the (same-group) stem width
            consumers.append(((layer(0), "0", "conv1", "w"), IN_AXIS))

        for b in range(depth):
            producers.append(((layer(s), str(b), lc, "w"), OUT_AXIS))
            bns.append((layer(s), str(b), f"bn{lc[-1]}"))
            if spec.has_downsample(s, b):
                producers.append(((layer(s), str(b), "down_conv", "w"), OUT_AXIS))
                bns.append((layer(s), str(b), "down_bn"))
            if b >= 1:
                consumers.append(((layer(s), str(b), "conv1", "w"), IN_AXIS))

        if s + 1 < n_stages:
            consumers.append(((layer(s + 1), "0", "conv1", "w"), IN_AXIS))
            if spec.has_downsample(s + 1, 0):
                consumers.append(((layer(s + 1), "0", "down_conv", "w"), IN_AXIS))

        groups.append({
            "key": ("stage", s),
            "width": spec.stage_widths[s],
            "producers": producers,
            "bns": bns,
            "consumers": consumers,
            "fc_in": s + 1 == n_stages,
        })

    # free inner-conv groups. A ResNeXt bottleneck's grouped conv2 welds
    # conv1-out == conv2-in == conv2-out == conv3-in into ONE group whose
    # channels go as whole LANES (the same within-group index across all
    # cardinality groups): the grouped kernel's HWIO input axis is indexed
    # relative to its group.
    for s, depth in enumerate(spec.depths):
        for b in range(depth):
            if spec.groups > 1 and spec.block == "bottleneck":
                w0, w1 = spec.inner_widths[s][b]
                assert w0 == w1, (
                    f"grouped bottleneck ({s},{b}) needs equal inner widths, "
                    f"got {spec.inner_widths[s][b]}"
                )
                groups.append({
                    "key": ("inner", s, b, 0),
                    "width": w0,
                    "producers": [
                        ((layer(s), str(b), "conv1", "w"), OUT_AXIS),
                        ((layer(s), str(b), "conv2", "w"), OUT_AXIS),
                    ],
                    "bns": [(layer(s), str(b), "bn1"), (layer(s), str(b), "bn2")],
                    "consumers": [((layer(s), str(b), "conv3", "w"), IN_AXIS)],
                    "grouped_in": [((layer(s), str(b), "conv2", "w"), spec.groups)],
                    "lanes": spec.groups,
                    "fc_in": False,
                })
                continue
            for i, w in enumerate(spec.inner_widths[s][b]):
                conv_n = i + 1
                groups.append({
                    "key": ("inner", s, b, i),
                    "width": w,
                    "producers": [((layer(s), str(b), f"conv{conv_n}", "w"), OUT_AXIS)],
                    "bns": [(layer(s), str(b), f"bn{conv_n}")],
                    "consumers": [((layer(s), str(b), f"conv{conv_n + 1}", "w"), IN_AXIS)],
                    "fc_in": False,
                })
    return groups


def get_path(tree, path: Path):
    for p in path:
        tree = tree[p]
    return tree


def set_path(tree, path: Path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value
