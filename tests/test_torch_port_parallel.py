"""The port's mesh (``parallel/mesh.py``) on gloo: ranks are processes on this
CPU, joined through a ``FileStore`` under the test's temporary directory (no
port). A train step over 2 ranks (data 2) and over 4 (data 2 x model 2,
the head split over the model axis) on a batch whose padded rows fall
unevenly on the ranks, held to the port's one-process step and to the JAX
package's step on its 8-device CPU mesh (``tests/test_parallel.py``); a KD
step with the similarity-preserving loss on unpadded rows; ``Predictor``
over 2 ranks on a JAX-made static-INT8 ResNet artifact, held to one
process; the refusals of an indivisible batch or bucket and of the fused
executor.

Tolerances (fp32; the ranks sum in another order than one process): loss
and metrics within 1e-5 relative, BatchNorm statistics 1e-5 and AdamW's first
moment 1e-5 of each leaf's largest value, the updated parameters within two
learning rates (AdamW's first step moves each by about ±lr, so a gradient
near 0 may flip its sign).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import resnet_params_from_seed  # noqa: E402

LR = 1e-3
LOSS_RTOL, STATE_TAU, MOMENT_TAU = 1e-5, 1e-5, 1e-5
BATCH, SIZE, PAD = 16, 32, 5  # rows 11..15 padded: 8 valid rows on rank 0, 3 on rank 1
SPEC = dict(name="tiny_basic1", block="basic", depths=[1, 1, 1, 1], stage_widths=[8, 16, 32, 64],
            inner_widths=[[[8]], [[16]], [[32]], [[64]]], stem_width=8, num_classes=6, groups=1)
SEED = 7

_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
          "from tests.test_torch_port_parallel import _rank_main; _rank_main(sys.argv[2:])")


def batch_np(pad=PAD, seed=5):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, SPEC["num_classes"], BATCH).astype(np.int32)
    mask = np.ones(BATCH, np.float32)
    mask[BATCH - pad:] = 0.0
    return imgs, labels, mask


def t_batch(b):
    imgs, labels, mask = b
    return (torch.from_numpy(imgs), torch.from_numpy(labels.astype(np.int64)),
            torch.from_numpy(mask))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree,
                               np.float32)}


def port_model():
    from inference_efficient_vision_models_tpu_torch.models import registry as treg
    from inference_efficient_vision_models_tpu_torch.models import resnet as tr

    spec = treg.spec_from_dict(SPEC)
    p, s = resnet_params_from_seed(spec, SEED)
    return spec, tr.params_from_jax(p, "cpu"), tr.params_from_jax(s, "cpu")


def port_steps(mesh=None, model_parallel=1):
    """One CE step on the padded batch and one KD step (sp_weight 0.5) on
    unpadded rows, on this process's share -> flat results."""
    from inference_efficient_vision_models_tpu_torch.models import resnet as tr
    from inference_efficient_vision_models_tpu_torch.parallel import param_shardings
    from inference_efficient_vision_models_tpu_torch.parallel.mesh import shard_params
    from inference_efficient_vision_models_tpu_torch.train import optim as to
    from inference_efficient_vision_models_tpu_torch.train import steps as ts

    spec, p, s = port_model()
    if mesh is not None and model_parallel > 1:
        p = shard_params(mesh, p, param_shardings(mesh, p, tp_head=True))
    out = {}
    step = ts.make_train_step(spec, learning_rate=LR, compute_dtype="float32", mesh=mesh)
    p2, s2, opt, m = step(p, s, to.adamw_init(p), t_batch(batch_np()))
    out.update({f"ce/p{k}": v for k, v in flat(tr.params_to_jax(p2)).items()})
    out.update({f"ce/s{k}": v for k, v in flat(tr.params_to_jax(s2)).items()})
    out.update({f"ce/mu{k}": v for k, v in flat(tr.params_to_jax(opt.mu)).items()})
    out.update({f"ce/{k}": np.float64(v) for k, v in m.items()})
    if model_parallel == 1:
        spec, p, s = port_model()
        _, tp, tst = port_model()
        kd = ts.make_kd_train_step(spec, spec, alpha=0.5, temperature=4.0, learning_rate=LR,
                                   compute_dtype="float32", sp_weight=0.5, mesh=mesh)
        p2, s2, opt, m = kd(p, s, to.adamw_init(p), tp, tst, t_batch(batch_np(pad=0, seed=9)))
        out.update({f"kd/p{k}": v for k, v in flat(tr.params_to_jax(p2)).items()})
        out.update({f"kd/mu{k}": v for k, v in flat(tr.params_to_jax(opt.mu)).items()})
        out.update({f"kd/{k}": np.float64(v) for k, v in m.items()})
    return out


def serve_case(fold_dir: str, mesh):
    from inference_efficient_vision_models_tpu_torch.serving import Predictor, load_quantized

    imgs = np.random.default_rng(3).integers(0, 256, (20, SIZE, SIZE, 3), dtype=np.uint8)
    pred = Predictor.from_artifact(fold_dir, "static_int8", batch_size=8, bucket_sizes=(2,),
                                   mesh=mesh)
    out = {"logits": pred.predict_logits(imgs), "short": pred.predict_logits(imgs[:1])}
    refused = []
    for kw in ({"batch_size": 7}, {"batch_size": 16, "bucket_sizes": (3,)}):
        try:
            Predictor(lambda x: x, mesh=mesh, **kw)
        except ValueError as e:
            refused.append(str(e))
    try:
        load_quantized(fold_dir, "static_int8_fused", mesh=mesh)
    except ValueError as e:
        refused.append(str(e))
    out["refused"] = np.array(refused)
    return out


LOOP_RTOL = 1e-4  # two AdamW steps: a flipped near-zero update moves the second loss


def loop_run(root: str, device="cpu"):
    """``train_classifier``: one fp32 epoch (2 steps of 8, 4 validation
    images) of the tiny ResNet -> (history, whether a checkpoint was written)."""
    from inference_efficient_vision_models_tpu_torch.core.config import TeacherConfig
    from inference_efficient_vision_models_tpu_torch.core.log import get_logger
    from inference_efficient_vision_models_tpu_torch.train.loop import train_classifier

    spec, p, s = port_model()
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (20, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, 6, 20)
    cfg = TeacherConfig(artifacts_root=root, batch_size=8, compute_dtype="float32", epochs=1)
    fold = cfg.fold_dir(0)
    _, _, hist = train_classifier(cfg, spec, p, s, (imgs[:16], labels[:16]),
                                  (imgs[16:], labels[16:]), fold, get_logger(name="dp"),
                                  device=device)
    return ({k: np.asarray(hist[k], np.float64) for k in ("train_loss", "val_loss")},
            os.path.exists(os.path.join(fold, "training_log.json")))


def _rank_main(argv):
    """One gloo rank: join through the FileStore, run the case, write its
    results as ``rank<r>.npz``."""
    import torch.distributed as dist

    from inference_efficient_vision_models_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
    )

    rank, world, tmp, case = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.set_num_threads(1)
    initialize_distributed(device="cpu", store=dist.FileStore(os.path.join(tmp, "store"), world),
                           rank=rank, world_size=world)
    try:
        if case == "serve":
            res = serve_case(argv[4], make_mesh())
            hist, wrote = loop_run(os.path.join(tmp, f"loop{rank}"))
            res.update({f"loop/{k}": v for k, v in hist.items()}, wrote=np.array(wrote))
        else:
            mp = int(case[2:])  # "mp1" | "mp2"
            try:
                make_mesh(model_parallel=3)
                bad = ""
            except ValueError as e:
                bad = str(e)
            res = {**port_steps(make_mesh(model_parallel=mp), mp), "bad_mesh": np.array(bad)}
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def spawn(tmp, case: str, world: int, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, ROOT, str(r), str(world), str(tmp),
                               case, *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        finally:
            p.kill()
        if p.returncode != 0:
            errs.append(err[-4000:])
    assert not errs, "\n".join(errs)
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(world)]


def jax_mesh_step(model_parallel: int):
    """The JAX package's train step on its 8-device CPU mesh (data 8, or data
    4 x model 2 with the head tensor-parallel) -> flat results."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from inference_efficient_vision_models_tpu.models import registry as jreg
    from inference_efficient_vision_models_tpu.parallel import make_mesh, param_shardings
    from inference_efficient_vision_models_tpu.parallel import shard_batch
    from inference_efficient_vision_models_tpu.train import adamw_init, make_train_step

    spec = jreg.spec_from_dict(SPEC)
    p, s = resnet_params_from_seed(spec, SEED)
    mesh = make_mesh(model_parallel=model_parallel)
    sh = param_shardings(mesh, p, tp_head=model_parallel > 1)
    ps = jax.tree.map(jax.device_put, p, sh)
    ss = jax.device_put(s, NamedSharding(mesh, P()))
    step = make_train_step(spec, learning_rate=LR, compute_dtype="float32")
    p2, s2, o2, m = jax.device_get(step(ps, ss, adamw_init(ps), shard_batch(mesh, batch_np())))
    out = {f"ce/p{k}": v for k, v in flat(p2).items()}
    out.update({f"ce/s{k}": v for k, v in flat(s2).items()})
    out.update({f"ce/mu{k}": v for k, v in flat(o2.mu).items()})
    out.update({f"ce/{k}": np.float64(v) for k, v in m.items()})
    return out


def join_tp(ranks):
    """Rank 0's results with the head's two model-axis halves joined."""
    out = dict(ranks[0])
    for k in out:
        if "/fc/" in k and not k.startswith("ce/s"):
            out[k] = np.concatenate([ranks[0][k], ranks[1][k]], axis=-1)
    return out


def assert_step_close(got, ref, kind="ce"):
    for k in ("loss", "acc", "n"):
        a, b = float(got[f"{kind}/{k}"]), float(ref[f"{kind}/{k}"])
        assert abs(a - b) <= LOSS_RTOL * abs(b), (k, a, b)
    keys = [k for k in ref if k.startswith(f"{kind}/p") or k.startswith(f"{kind}/s")
            or k.startswith(f"{kind}/mu")]
    assert keys
    for k in keys:
        assert got[k].shape == ref[k].shape, k
        d = np.abs(got[k] - ref[k]).max()
        if k.startswith(f"{kind}/p"):
            assert d <= 2 * LR, (k, d)
        else:
            assert d <= (MOMENT_TAU if "/mu/" in k else STATE_TAU) * np.abs(ref[k]).max(), (k, d)


@pytest.fixture(scope="module")
def one_process():
    return port_steps()


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("dp2"), "mp1", 2)


@pytest.fixture(scope="module")
def dp2x2(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("dp2x2"), "mp2", 4)


def test_padded_rows_fall_unevenly():
    mask = batch_np()[2]
    assert mask[: BATCH // 2].sum() == 8 and mask[BATCH // 2 :].sum() == 3


def test_dp2_step_matches_one_process(dp2, one_process):
    for r in dp2:  # every rank holds the same replicated result
        assert_step_close(r, one_process)
    assert float(dp2[0]["ce/n"]) == BATCH - PAD


def test_dp2_step_matches_jax_mesh(dp2):
    assert_step_close(dp2[0], jax_mesh_step(1))


def test_dp2x2_tp_head_step_matches_one_process(dp2x2, one_process):
    # the model axis splits the 6 classes 3 + 3
    assert dp2x2[0]["ce/p/fc/w"].shape == (64, 3)
    assert np.array_equal(dp2x2[0]["ce/p/fc/w"], dp2x2[2]["ce/p/fc/w"])  # data-axis replicas
    assert_step_close(join_tp(dp2x2[:2]), one_process)
    assert_step_close(join_tp(dp2x2[2:]), one_process)


def test_dp2x2_tp_head_step_matches_jax_mesh(dp2x2):
    assert_step_close(join_tp(dp2x2[:2]), jax_mesh_step(2))


def test_kd_sp_step_dp2_matches_one_process(dp2, one_process):
    assert float(one_process["kd/sp"]) > 0
    for r in dp2:
        assert_step_close(r, one_process, "kd")
        assert abs(float(r["kd/sp"]) - float(one_process["kd/sp"])) <= \
            LOSS_RTOL * float(one_process["kd/sp"])


def test_make_mesh_refuses_indivisible_model_axis(dp2):
    assert "not divisible by model_parallel=3" in str(dp2[0]["bad_mesh"])


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


def _jax_artifact(fold_dir: str):
    """A static-INT8 tiny ResNet made by the JAX package on the CPU."""
    import jax
    from flax import serialization

    from inference_efficient_vision_models_tpu.compress.quant import qresnet
    from inference_efficient_vision_models_tpu.data.pipeline import Batches
    from inference_efficient_vision_models_tpu.models import registry as jreg

    spec = jreg.spec_from_dict(SPEC)
    p, s = resnet_params_from_seed(spec, SEED)
    folded = qresnet.fold(spec, p, s)
    imgs = np.random.default_rng(0).integers(0, 255, (16, SIZE, SIZE, 3)).astype(np.uint8)
    obs = qresnet.calibrate(spec, folded, Batches(imgs, np.zeros(16, np.int32), 16),
                            max_images=16)
    q = qresnet.convert_static_int8(spec, folded, obs, image_size=(SIZE, SIZE))
    os.makedirs(fold_dir, exist_ok=True)
    with open(os.path.join(fold_dir, "spec.json"), "w") as f:
        json.dump(spec.to_dict(), f)
    with open(os.path.join(fold_dir, "model_static_int8.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(qresnet.serializable(jax.device_get(q))))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    fold = str(tmp / "fold_0")
    _jax_artifact(fold)
    return fold, spawn(tmp, "serve", 2, fold)


def test_predictor_mesh_matches_one_process(served):
    from inference_efficient_vision_models_tpu_torch.serving import Predictor

    fold, ranks = served
    imgs = np.random.default_rng(3).integers(0, 256, (20, SIZE, SIZE, 3), dtype=np.uint8)
    ref = Predictor.from_artifact(fold, "static_int8", batch_size=8, bucket_sizes=(2,),
                                  device="cpu").predict_logits(imgs)
    for r in ranks:  # every rank returns the whole batch's logits
        assert r["logits"].shape == (20, 6)
        np.testing.assert_array_equal(r["logits"], ref)
        np.testing.assert_array_equal(r["short"], ref[:1])


def test_predictor_mesh_refuses_indivisible_batch_and_bucket(served):
    refused = [str(m) for m in served[1][0]["refused"]]
    assert "batch/bucket size 7 not divisible by data-axis size 2" in refused
    assert "batch/bucket size 3 not divisible by data-axis size 2" in refused


def test_fused_executor_refuses_a_mesh(served):
    assert "the fused executor is single-device" in [str(m) for m in served[1][0]["refused"]]


def test_train_classifier_runs_data_parallel(served, tmp_path):
    """With two ranks in the group the loop trains over a mesh: its history
    equals one process's within ``LOOP_RTOL``, and only rank 0 writes."""
    ref, wrote = loop_run(str(tmp_path))
    assert wrote
    ranks = served[1]
    for r in ranks:
        for k, v in ref.items():
            np.testing.assert_allclose(r[f"loop/{k}"], v, rtol=LOOP_RTOL)
    assert [bool(r["wrote"]) for r in ranks] == [True, False]


def test_initialize_distributed_is_a_noop_without_coordinates(monkeypatch):
    import torch.distributed as dist

    from inference_efficient_vision_models_tpu_torch.parallel import initialize_distributed
    from inference_efficient_vision_models_tpu_torch.parallel.mesh import world_size

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    initialize_distributed(device="cpu")
    assert not dist.is_initialized() and world_size() == 1
