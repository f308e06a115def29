"""The port's HTTP server and MicroBatcher on the CPU, beside the JAX
package's server on the same artifact: a ResNet18 (full width, 64x64
input) quantized to static INT8 by the port's own stage-4 engine from the
seeded weights of ``chip_smoke.resnet_params_from_seed``; the JAX package
reads the same fold directory.

Routes, payload kinds, status codes and error bodies are held EQUAL between
the two servers; classes equal and logits within the ResNet18 serving
limit (``chip_smoke.R18_LIMIT``: the port's plain int8 path against JAX's
``lax`` path). Inside the port, answers equal the model's direct forward
(rtol/atol 1e-6: the same function, batch composition aside).
"""

import base64
import io
import json
import logging
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from chip_smoke import R18_LIMIT, bmp_bytes, http, npy_bytes, png_bytes, resnet_params_from_seed
from inference_efficient_vision_models_tpu import server as jserver
from inference_efficient_vision_models_tpu.serving import Predictor as JPredictor
from inference_efficient_vision_models_tpu_torch import server as tserver
from inference_efficient_vision_models_tpu_torch.cli.quantize import _save_qmodel
from inference_efficient_vision_models_tpu_torch.compress.quant.engine import QuantizationEngine
from inference_efficient_vision_models_tpu_torch.compress.quant.qresnet import load_static_int8
from inference_efficient_vision_models_tpu_torch.core.config import QuantConfig
from inference_efficient_vision_models_tpu_torch.data.native_loader import decode_batch_native
from inference_efficient_vision_models_tpu_torch.models import registry as treg
from inference_efficient_vision_models_tpu_torch.models import resnet as tr
from inference_efficient_vision_models_tpu_torch.serving import MicroBatcher, Predictor

try:
    from tests.test_torch_port_prune import one_thread  # noqa: F401  (autouse)
except ImportError:
    from test_torch_port_prune import one_thread  # noqa: F401  (autouse)

LOG = logging.getLogger("test_torch_port_server")
SIZE = 64


def make_artifact(root, method: str = "static_int8") -> str:
    """A static-INT8 ResNet18 fold dir for 64x64 images, made by the port's
    stage-4 engine (minmax, 16 calibration images) from seeded weights;
    ``method="dynamic_int8"``: the same weights with the dynamic INT8 head,
    whose activation range is taken over the whole batch."""
    spec = treg.make_spec("resnet18", 6)
    p, s = resnet_params_from_seed(spec, 0)
    cfg = QuantConfig(artifacts_root=str(root / "cfg"), batch_size=8, image_size=(SIZE, SIZE),
                      calibration_images=16)
    eng = QuantizationEngine(cfg, spec, tr.params_from_jax(p, "cpu"),
                             tr.params_from_jax(s, "cpu"), LOG, "cpu")
    if method == "dynamic_int8":
        qmodel, _ = eng.dynamic_quantize()
    else:
        qmodel, _ = eng.static_quantize((images(16, seed=0), np.zeros(16, np.int32)))
    fold = str(root / "fold_0")
    _save_qmodel(fold, method, qmodel, spec)
    return fold


def images(n: int, seed: int, size: int = SIZE) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    return make_artifact(tmp_path_factory.mktemp("r18"))


@pytest.fixture(scope="module")
def dynamic_fold(tmp_path_factory):
    return make_artifact(tmp_path_factory.mktemp("r18_dynamic"), "dynamic_int8")


@pytest.fixture(scope="module")
def oracle(fold):
    model = load_static_int8(fold, "cpu")

    def run(imgs: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return model(torch.from_numpy(imgs)).numpy()

    return run


@pytest.fixture(scope="module")
def servers(fold):
    """(port server, JAX server) on the same artifact, batch 8, bucket 1."""
    tpred = Predictor.from_artifact(fold, device="cpu", batch_size=8, bucket_sizes=(1,))
    jpred = JPredictor.from_artifact(fold, "static_int8", batch_size=8, bucket_sizes=(1,))
    meta = {"artifact": fold, "method": "static_int8"}
    t = tserver.InferenceServer(tpred, port=0, max_wait_ms=20, image_size=(SIZE, SIZE),
                                metadata=meta)
    j = jserver.InferenceServer(jpred, port=0, max_wait_ms=20, image_size=(SIZE, SIZE),
                                metadata=meta, warmup=False)
    with t, j:
        yield t, j


def _npy(arr):
    return npy_bytes(arr), {"Content-Type": "application/x-npy"}


def _typed(body, ctype):
    return body, {"Content-Type": ctype}


_ONE = images(1, seed=5)[0]
CASES = {
    "healthz": ("GET", "/healthz", None, {}),
    "metadata": ("GET", "/v1/metadata", None, {}),
    "get_unknown_404": ("GET", "/nope", None, {}),
    "post_unknown_404": ("POST", "/nope", *_npy(images(1, seed=1))),
    "npy_5": ("POST", "/v1/predict", *_npy(images(5, seed=3))),
    "npy_accept_npy": ("POST", "/v1/predict", npy_bytes(images(2, seed=4)),
                       {"Content-Type": "application/x-npy", "Accept": "application/x-npy"}),
    "json_b64_single": ("POST", "/v1/predict", *_typed(json.dumps(
        {"images_b64": base64.b64encode(npy_bytes(_ONE)).decode()}).encode(),
        "application/json")),
    "bmp_24bit": ("POST", "/v1/predict", *_typed(bmp_bytes(_ONE), "image/bmp")),
    "bmp_8bit": ("POST", "/v1/predict", *_typed(bmp_bytes(_ONE[..., 0]), "image/bmp")),
    "png": ("POST", "/v1/predict", *_typed(png_bytes(_ONE), "image/png")),
    "unsupported_415": ("POST", "/v1/predict", *_typed(b"x", "text/plain")),
    "malformed_npy_400": ("POST", "/v1/predict", *_typed(b"not npy", "application/x-npy")),
    "bad_dtype_400": ("POST", "/v1/predict", *_npy(np.zeros((1, SIZE, SIZE, 3), np.float32))),
    "bad_shape_400": ("POST", "/v1/predict", *_npy(np.zeros((1, SIZE, SIZE, 4), np.uint8))),
    "empty_body_413": ("POST", "/v1/predict", *_typed(b"", "application/x-npy")),
    "json_without_key_400": ("POST", "/v1/predict", *_typed(b"{}", "application/json")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_server_answers_as_jax_server(servers, case):
    method, path, body, headers = CASES[case]
    (tc, tt, tb), (jc, jt, jb) = (http(s.port, method, path, body, headers) for s in servers)
    assert (tc, tt) == (jc, jt), (tb, jb)
    if tt == "application/x-npy":
        got, want = (np.load(io.BytesIO(b)) for b in (tb, jb))
        np.testing.assert_allclose(got, want, **R18_LIMIT)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
        return
    got, want = json.loads(tb), json.loads(jb)
    if tc == 200 and "logits" in want:
        assert got["classes"] == want["classes"] and got["class_names"] == want["class_names"]
        np.testing.assert_allclose(got["logits"], want["logits"], **R18_LIMIT)
    else:
        assert got == want


def test_stats_keys_and_a_bad_bmp(servers):
    t, j = servers
    # the port's batcher also reports its requests' mean queue wait and how
    # its dispatches were staged
    assert json.loads(http(t.port, "GET", "/v1/stats")[2]).keys() == \
        json.loads(http(j.port, "GET", "/v1/stats")[2]).keys() | {
            "queue_wait_ms_mean", "staged_in_place", "staged_copy"}
    # both refuse a body that is no BMP with 400 (the decoders word it differently)
    for s in servers:
        code, _, raw = http(s.port, "POST", "/v1/predict", b"BMnonsense",
                            {"Content-Type": "image/bmp"})
        assert code == 400 and "error" in json.loads(raw)


def test_bmp_is_decoded_natively_and_resized(servers, oracle, tmp_path):
    """An 8-bit 80x96 BMP: the port's answer is the model's on the native
    file decoder's resize of the same bytes (PIL's differs by rounding)."""
    t, _ = servers
    raw = bmp_bytes(np.random.default_rng(6).integers(0, 256, (80, 96), dtype=np.uint8))
    path = tmp_path / "x.bmp"
    path.write_bytes(raw)
    decoded, ok = decode_batch_native([str(path)], (SIZE, SIZE))
    assert ok.all()
    code, _, body = http(t.port, "POST", "/v1/predict", raw,
                         {"Content-Type": "image/bmp", "Accept": "application/x-npy"})
    assert code == 200
    np.testing.assert_allclose(np.load(io.BytesIO(body)), oracle(decoded),
                               rtol=1e-6, atol=1e-6)


def test_png_without_pil_is_415(servers, monkeypatch):
    t, _ = servers
    monkeypatch.setitem(sys.modules, "PIL", None)  # a host without PIL
    code, _, raw = http(t.port, "POST", "/v1/predict", png_bytes(_ONE),
                        {"Content-Type": "image/png"})
    assert code == 415 and "PIL" in json.loads(raw)["error"]


def test_concurrent_clients_coalesce(servers, oracle):
    t, _ = servers
    reqs = [images(1, seed=20 + i) for i in range(8)]
    before = t.batcher.stats()["batches"]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(lambda r: http(
            t.port, "POST", "/v1/predict", npy_bytes(r),
            {"Content-Type": "application/x-npy", "Accept": "application/x-npy"}), reqs))
    for r, (code, _, body) in zip(reqs, outs):
        assert code == 200
        np.testing.assert_allclose(np.load(io.BytesIO(body)), oracle(r),
                                   rtol=1e-6, atol=1e-6)
    assert t.batcher.stats()["batches"] - before < 8


def test_oversized_request_chunks(servers, oracle):
    t, _ = servers
    x = images(19, seed=8)
    np.testing.assert_allclose(t.infer(x), oracle(x), rtol=1e-6, atol=1e-6)


def test_main_flags_match_jax(monkeypatch, fold):
    """The same argparse flags and defaults reach ``from_artifact``."""
    seen = {}
    for name, mod in (("port", tserver), ("jax", jserver)):
        def fake(fold_dir, method, _name=name, **kw):
            seen[_name] = dict(kw, fold_dir=fold_dir, method=method)
            raise KeyboardInterrupt  # stop before binding or loading

        monkeypatch.setattr(mod.InferenceServer, "from_artifact", staticmethod(fake))
        if name == "port":
            monkeypatch.setenv("IEVM_PLATFORM", "cpu")
        else:
            monkeypatch.setattr("inference_efficient_vision_models_tpu.utils."
                                "enable_compilation_cache", lambda: None)
        with pytest.raises(KeyboardInterrupt):
            mod.main(["--fold", fold])
    assert seen["port"].pop("device") == torch.device("cpu")
    seen["port"].pop("logger"), seen["jax"].pop("logger")
    assert seen["port"] == seen["jax"]
    assert seen["port"]["batch_size"] == 64 and seen["port"]["bucket_sizes"] == (1, 8)
    assert seen["port"]["max_wait_ms"] == 2.0


# -- MicroBatcher: the seven scenarios of tests/test_microbatcher.py --------


def _recording(fold, *, batch_size=8, bucket_sizes=None, delay=0.0):
    """A Predictor whose forward records (batch rows, thread) of each call."""
    base = Predictor.from_artifact(fold, device="cpu", batch_size=batch_size)
    seen = []

    def recording(x):
        seen.append((int(x.shape[0]), threading.current_thread()))
        time.sleep(delay)
        return base.apply_fn(x)

    pred = Predictor(recording, host_preprocess=base.host_preprocess, batch_size=batch_size,
                     bucket_sizes=bucket_sizes, device="cpu")
    return pred, seen


def _coalesces_and_matches(fold, oracle):
    pred, seen = _recording(fold)
    test = images(6, seed=7)
    with MicroBatcher(pred, max_wait_ms=500) as mb:
        futs = [mb.submit(test[i : i + 1]) for i in range(6)]
        logits = np.concatenate([f.result(timeout=60) for f in futs])
        stats = mb.stats()
        dispatcher = mb._thread
    np.testing.assert_allclose(logits, oracle(test), rtol=1e-6, atol=1e-6)
    assert stats["batches"] == 1 and stats["images"] == 6
    assert [n for n, _ in seen] == [8]
    assert all(t is dispatcher for _, t in seen)  # the only thread that runs the model


def _routes_through_buckets(fold, oracle):
    pred, seen = _recording(fold, bucket_sizes=(1, 4))
    with MicroBatcher(pred, max_wait_ms=1) as mb:
        out = mb.infer(images(1, seed=8))
    assert out.shape == (1, 6) and [n for n, _ in seen] == [1]


def _concurrent_clients_match_oracle(fold, oracle):
    pred, seen = _recording(fold)
    reqs = [images(2, seed=30 + i) for i in range(10)]
    with MicroBatcher(pred, max_wait_ms=20) as mb:
        mb.warmup((SIZE, SIZE, 3))
        with ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(mb.infer, reqs))
        stats = mb.stats()
        dispatcher = mb._thread
    for req, out in zip(reqs, outs):
        np.testing.assert_allclose(out, oracle(req), rtol=1e-6, atol=1e-6)
    assert stats["images"] == 20 and stats["requests"] == 10
    assert stats["batches"] < 10  # concurrency coalesced some requests
    assert all(t is dispatcher for _, t in seen)  # warmup included


def _overflow_carries_to_next_batch(fold, oracle):
    pred, _ = _recording(fold, batch_size=4)
    a, b = images(3, seed=10), images(3, seed=11)
    with MicroBatcher(pred, max_wait_ms=300, max_batch=4) as mb:
        fa, fb = mb.submit(a), mb.submit(b)
        np.testing.assert_allclose(fa.result(timeout=60), oracle(a), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(fb.result(timeout=60), oracle(b), rtol=1e-6, atol=1e-6)
        assert mb.stats()["batches"] == 2


def _validation_and_close(fold, oracle):
    pred, _ = _recording(fold, batch_size=4)
    mb = MicroBatcher(pred, max_wait_ms=1)
    with pytest.raises(ValueError):
        mb.submit(np.zeros((5, SIZE, SIZE, 3), np.uint8))  # > max_batch
    with pytest.raises(ValueError):
        mb.submit(np.zeros((SIZE, SIZE, 3), np.uint8))  # not (n, H, W, C)
    assert mb.submit(np.zeros((0, SIZE, SIZE, 3), np.uint8)).result().size == 0
    mb.close()
    mb.close()  # idempotent
    with pytest.raises(RuntimeError):
        mb.submit(np.zeros((1, SIZE, SIZE, 3), np.uint8))
    with pytest.raises(RuntimeError):
        mb.warmup((SIZE, SIZE, 3))
    with pytest.raises(ValueError):
        MicroBatcher(pred, max_batch=99)  # > predictor.batch_size


def _close_drains_pending(fold, oracle):
    pred, _ = _recording(fold, batch_size=4, delay=0.05)
    mb = MicroBatcher(pred, max_wait_ms=1)
    futs = [mb.submit(np.zeros((1, SIZE, SIZE, 3), np.uint8)) for _ in range(4)]
    mb.close()
    for f in futs:
        assert f.result(timeout=60).shape == (1, 6)


def _exception_scatters_to_all_futures(fold, oracle):
    def boom(x):
        raise RuntimeError("device on fire")

    with MicroBatcher(Predictor(boom, batch_size=4, device="cpu"), max_wait_ms=100) as mb:
        f1 = mb.submit(np.zeros((1, SIZE, SIZE, 3), np.uint8))
        f2 = mb.submit(np.zeros((1, SIZE, SIZE, 3), np.uint8))
        with pytest.raises(RuntimeError, match="device on fire"):
            f1.result(timeout=60)
        assert isinstance(f2.exception(timeout=60), RuntimeError)


SCENARIOS = {f.__name__.strip("_"): f for f in (
    _coalesces_and_matches, _routes_through_buckets, _concurrent_clients_match_oracle,
    _overflow_carries_to_next_batch, _validation_and_close, _close_drains_pending,
    _exception_scatters_to_all_futures)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_microbatcher(scenario, fold, oracle):
    SCENARIOS[scenario](fold, oracle)


# -- MicroBatcher's reused staging buffer ------------------------------------


class _Gate:
    """A forward that, once ``hold()`` is called, waits at its next call
    until ``release()``: requests submitted meanwhile queue up, so the
    batches after it are made of them in a known order. Records each call's
    rows."""

    def __init__(self, fn):
        self.fn, self.rows = fn, []
        self.entered, self.open = threading.Event(), threading.Event()
        self.open.set()

    def __call__(self, x):
        self.rows.append(int(x.shape[0]))
        self.entered.set()
        assert self.open.wait(timeout=60)
        return self.fn(x)

    def hold(self):
        self.rows.clear()
        self.entered.clear()
        self.open.clear()

    def queue_behind(self, mb, first, rest):
        """``first`` dispatched alone, ``rest`` submitted while its forward
        waits; -> the futures of all, in order."""
        self.hold()
        futs = [mb.submit(first)]
        assert self.entered.wait(timeout=60)
        futs += [mb.submit(r) for r in rest]
        self.release()
        return futs

    def release(self):
        self.open.set()


def _toy(x):
    return x.reshape(len(x), -1)[:, :3].float()


def _mixed_sizes(pred, gate, copies: bool):
    """Requests of 1, 3, 4, 2 and 1 images at batch 8, buckets 2 and 4: the
    first alone (bucket 2, its pad row zeros before it is filled), then 3 + 4
    (bucket 8; the 2 would overflow and leads the next batch), then 2 + 1
    (bucket 4, its pad row a frame of the batch before until filled). The
    last two requests are low-contrast frames, whose features lie well below
    a noise frame's: a stale pad row would widen the dynamic INT8 head's
    range. ``copies``: every batch joined and padded by copies, as before
    the buffer. -> (answers, requests, stats, batcher)."""
    reqs = [images(n, seed=60 + i) for i, n in enumerate((1, 3, 4, 2, 1))]
    reqs[3:] = [120 + r // 16 for r in reqs[3:]]
    mb = MicroBatcher(pred, max_wait_ms=50)
    try:
        mb.warmup((SIZE, SIZE, 3))
        if copies:
            mb._fits = lambda images: False
        futs = gate.queue_behind(mb, reqs[0], reqs[1:])
        answers = [f.result(timeout=60) for f in futs]
    finally:
        mb.close()
    assert gate.rows == [2, 8, 4]
    return answers, reqs, mb.stats(), mb


ROUTES = {  # (artifact, method, device_preprocess)
    "host_s2d": ("fold", "static_int8", False),
    "device_s2d": ("fold", "static_int8", True),
    "dynamic_int8": ("dynamic_fold", "dynamic_int8", False),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_microbatcher_stages_in_place_as_the_concat_path(request, oracle, route):
    """Logits of requests staged in the reused buffer equal bit for bit those
    of the same batches joined and padded by copies: the pad rows hold the
    last frame, not zeros or stale frames, so the dynamic INT8 head's
    batch-wide activation range is that of the copy path."""
    artifact, method, device_preprocess = ROUTES[route]
    base = Predictor.from_artifact(request.getfixturevalue(artifact), method, device="cpu",
                                   device_preprocess=device_preprocess)
    gate = _Gate(base.apply_fn)
    pred = Predictor(gate, host_preprocess=base.host_preprocess, batch_size=8,
                     bucket_sizes=(2, 4), device="cpu")
    got, reqs, stats, mb = _mixed_sizes(pred, gate, copies=False)
    want, _, want_stats, _ = _mixed_sizes(pred, gate, copies=True)
    for req, g, w in zip(reqs, got, want):
        np.testing.assert_array_equal(g, w)
        if method == "static_int8":  # row by row: each request alone
            np.testing.assert_allclose(g, oracle(req), rtol=1e-6, atol=1e-6)
    # the last batch's pad row holds its last frame
    np.testing.assert_array_equal(mb._buf_np[3], reqs[4][0])
    assert (stats["batches"], stats["staged_in_place"], stats["staged_copy"]) == (3, 3, 0)
    assert (want_stats["staged_in_place"], want_stats["staged_copy"]) == (0, 3)
    assert stats["mean_dispatch_slots"] == want_stats["mean_dispatch_slots"] == 14 / 3


def test_microbatcher_reuses_one_buffer():
    """One buffer, allocated by warmup (rows for the largest bucket
    max_batch can reach, zeroed), is handed to every dispatch; a warmup of
    another image shape replaces it."""
    pred = Predictor(_toy, batch_size=8, bucket_sizes=(2, 4), device="cpu")
    hosts = []
    run = pred._run
    pred._run = lambda host: hosts.append(host.data_ptr()) or run(host)
    with MicroBatcher(pred, max_wait_ms=1, max_batch=3) as mb:
        mb.warmup((4, 4, 3))
        buf = mb._buf
        assert buf.shape == (4, 4, 4, 3) and not buf.is_pinned() and not buf.any()
        hosts.clear()
        for i in range(4):
            x = images(1 + i % 3, seed=70 + i, size=4)
            np.testing.assert_array_equal(mb.submit(x).result(timeout=60),
                                          _toy(torch.from_numpy(x)).numpy())
        assert hosts == [buf.data_ptr()] * 4 and mb._buf is buf
        mb.warmup((5, 5, 3))
        assert mb._buf.shape == (4, 5, 5, 3)
        assert mb.stats()["staged_in_place"] == mb.stats()["batches"] == 4


def test_microbatcher_stages_by_copies_before_a_warmup():
    """A batcher never warmed up has no buffer: it stages by copies."""
    pred = Predictor(_toy, batch_size=8, bucket_sizes=(2, 4), device="cpu")
    x = images(3, seed=85, size=4)
    with MicroBatcher(pred, max_wait_ms=1) as mb:
        np.testing.assert_array_equal(mb.submit(x).result(timeout=60),
                                      _toy(torch.from_numpy(x)).numpy())
        assert mb._buf is None
        stats = mb.stats()
    assert (stats["batches"], stats["staged_in_place"], stats["staged_copy"]) == (1, 0, 1)


FALLBACKS = {
    # (requests queued behind a first one of 1 uint8 4x4 image, dispatched
    # alone; what each of them answers)
    "float_dtype": ([np.ones((2, 4, 4, 3), np.float32)], "logits"),
    "other_shape": ([images(2, seed=80, size=5)], "logits"),
    "mixed_dtype_batch": ([images(1, seed=81, size=4), np.full((2, 4, 4, 3), 0.5, np.float32)],
                          "logits"),
    "unjoinable_batch": ([images(1, seed=82, size=4), images(2, seed=83, size=5)], ValueError),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_microbatcher_falls_back_to_copies(case):
    """A batch holding a request of another dtype or image shape takes the
    copy path, with its outcome: the forward of the joined batch, or the
    join's exception to every future."""
    rest, outcome = FALLBACKS[case]
    gate = _Gate(_toy)
    pred = Predictor(gate, batch_size=8, bucket_sizes=(2, 4), device="cpu")
    first = images(1, seed=84, size=4)
    with MicroBatcher(pred, max_wait_ms=50) as mb:
        mb.warmup((4, 4, 3))
        futs = gate.queue_behind(mb, first, rest)
        np.testing.assert_array_equal(futs[0].result(timeout=60),
                                      _toy(torch.from_numpy(first)).numpy())
        for req, fut in zip(rest, futs[1:]):
            if outcome == "logits":
                np.testing.assert_array_equal(fut.result(timeout=60),
                                              _toy(torch.from_numpy(req)).numpy())
            else:
                assert isinstance(fut.exception(timeout=60), outcome)
        stats = mb.stats()
    copied = 1 if outcome == "logits" else 0  # a batch that raised counts in no statistic
    assert (stats["staged_in_place"], stats["staged_copy"]) == (1, copied)
    assert stats["batches"] == 1 + copied
