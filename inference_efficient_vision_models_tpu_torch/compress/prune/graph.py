"""Channel-dependency graph of a ResNet for structured pruning: the port's
copy of the JAX package's ``compress/prune/graph.py`` (ResNet part).

Every prunable width is one coupled group of parameter slices, derived
statically from the width descriptor:

* producers: conv kernels whose OUTPUT channel axis carries the width (HWIO
  axis 3) and the BatchNorms that normalize it (every vector, axis 0),
* consumers: conv kernels whose INPUT channel axis carries it (HWIO axis 2),
  and the classifier kernel's input rows for the last stage's group.

Residual adds couple a whole stage: every block output of a stage (with the
downsample branch, and the stem where it is tied to stage 0) shares one
group. Paths are key tuples into the params/state trees in the JAX layout
(``models.resnet.params_to_jax``): the surgery runs on those numpy trees,
so the axes here are HWIO axes. The MobileNetV2 and EfficientNet graphs
are not ported (ROADMAP queue 1 items 13-14).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ...models.widths import ResNetSpec

Path = Tuple[str, ...]

OUT_AXIS = 3  # HWIO conv kernel output-channel axis
IN_AXIS = 2   # HWIO conv kernel input-channel axis


def _last_conv(spec: ResNetSpec) -> str:
    return "conv2" if spec.block == "basic" else "conv3"


def group_slices(spec) -> List[Dict]:
    """Coupled groups with their parameter slices. Each group dict:

      key:        ("stem",) | ("stage", s) | ("inner", s, b, i)
      width:      current channel count
      producers:  [(conv_w_path, OUT_AXIS), ...]
      bns:        [bn_path_prefix, ...]   (scale/bias/mean/var, axis 0)
      consumers:  [(conv_w_path, IN_AXIS), ...]
      fc_in:      True if the fc kernel's rows (axis 0) are consumers
      lanes, grouped_in: a ResNeXt bottleneck's welded inner group, whose
                  channels go as whole lanes (see group_slices_resnet)
    """
    if not isinstance(spec, ResNetSpec):
        raise NotImplementedError(
            f"structured pruning of {type(spec).__name__[:-4]} is not ported yet (ROADMAP "
            f"queue 1 items 13-15); the port prunes the ResNet family")
    return group_slices_resnet(spec)


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
