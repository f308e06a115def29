"""The roofline arithmetic, held to numbers worked by hand, and the trace
reductions on events made up for the test."""

import json
import os

import pytest

from benchmark.harness.cell import BENCH
from benchmark.harness.peaks import H100, bound_s
from benchmark.harness.trace import Trace
from benchmark.roofline import effnet_fused, resnet


def _spec(name):
    with open(os.path.join(BENCH, "configs", name, "spec.json")) as f:
        return json.load(f)


def test_resnet_layer_by_hand():
    """layer1.0.conv1 of the pruned ResNet-18 at batch 1: 3x3, 56 -> 56
    channels on 56x56. Bytes: input 56*56*56 = 175,616, weights 9*56*56 =
    28,224, scale and bias 8*56 = 448, output 175,616: 379,904. MACs:
    56*56*56*9*56 = 88,510,464. Bound: 379,904 B / 3.35 TB/s = 1.1340e-7 s
    against 177,020,928 int8 ops / 1,979 TOP/s = 8.945e-8 s: the bytes."""
    layer = {x["name"]: x for x in resnet.layers(_spec("resnet18_pruned_int8"), 1)}[
        "layer1.0.conv1"]
    assert layer["bytes"] == 379_904 and layer["macs"] == 88_510_464
    assert bound_s(layer, H100) == pytest.approx(379_904 / 3.35e12, rel=1e-12)


def test_model_macs():
    assert sum(x["macs"] for x in resnet.layers(_spec("resnet18_pruned_int8"), 1)) == 1_411_864_432
    layers = effnet_fused.layers(_spec("efficientnet_b0_int8_fused"), 1)
    assert [x["group"] for x in layers].count("mbconv") == 16
    assert 0.38e9 < sum(x["macs"] for x in layers) < 0.40e9  # B0: 0.39 GFLOPs-as-MACs
    # the work scales with the batch
    b256 = effnet_fused.layers(_spec("efficientnet_b0_int8_fused"), 256)
    assert b256[3]["macs"] == 256 * layers[3]["macs"]


def test_trace_union_and_gaps():
    dev = [("k1", 0.0, 10.0), ("Memcpy HtoD (Pinned -> Device)", 5.0, 15.0), ("k2", 30.0, 40.0)]
    host = [("aten::cat", 14.0, 31.0, 1), ("bench.dispatch", 0.0, 100.0, 2)]
    t = Trace(dev, host, 0.0, 50.0)
    assert t.busy_s() == pytest.approx(25e-6)
    assert t.seconds(kind="memcpy") == pytest.approx(10e-6)
    assert t.seconds(kind="kernel", match=["k2"]) == pytest.approx(10e-6)
    gaps = t.idle_gaps()
    assert gaps == [("aten::cat", pytest.approx(15e-6)), ("bench.dispatch", pytest.approx(10e-6))]
    b = t.breakdown()
    assert b["device_ops"][0][0] in ("k1", "k2", "Memcpy HtoD (Pinned -> Device)")
    assert b["idle_gaps"][0] == ["aten::cat", pytest.approx(15e-6)]
