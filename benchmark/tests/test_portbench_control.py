"""The comparison that decides ``correct``, at a size a test run holds: on
the CPU the port's plain path (what its kernels compute bit for bit) comes
out within each configuration's limit of the reference, and the control,
the reference on the int4 grid, outside it."""

import numpy as np
import pytest
import torch

from benchmark.harness.cell import find_cell, load_benchmark
from benchmark.run import logit_gap
from benchmark.traffic import generator

CONFIGS = {w["config"]: w["name"] for w in load_benchmark()["workloads"]}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_program_passes_and_control_fails(config):
    from inference_efficient_vision_models_tpu_torch.serving import load_quantized

    cell = find_cell(CONFIGS[config])
    limit = cell.config["limits"]["logit_gap"]
    images = generator.frames(2, cell.config["image_hw"], 2**31 + 7)
    x = torch.from_numpy(images)
    _, model, _, _ = load_quantized(cell.config_dir, cell.config["method"], device="cpu",
                                    device_preprocess=bool(cell.config["device_preprocess"]))
    with torch.inference_mode():
        prog = model(x, impl="plain").numpy()
    ref_mod = cell.reference()
    ref = ref_mod.Reference(cell.config_dir, "cpu")(x).numpy().astype(np.float64)
    ctl = ref_mod.Reference(cell.config_dir, "cpu", bits=4)(x).numpy()
    assert logit_gap(prog, ref) <= limit
    assert logit_gap(ctl, ref) > limit
