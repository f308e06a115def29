"""Deployment CLI: classify images with a saved stage-4 artifact, the port of
the JAX package's ``cli/predict.py``.

Takes any images (files, a directory tree, or an ``.npy`` batch), runs them
through the pipelined :class:`~inference_efficient_vision_models_tpu_torch.serving.Predictor`
over a quantized artifact, and emits per-image predictions as CSV. It runs
on ``cuda``; ``IEVM_PLATFORM=cpu`` runs it on the CPU.

Usage (the same ``key=value`` convention as the four stage CLIs)::

    python -m inference_efficient_vision_models_tpu_torch.cli.predict \
        artifact=exp_name [fold=0] [method=static_int8] \
        inputs=path[,path...] [output=preds.csv] [topk=1] \
        [batch_size=256] [buckets='(1,16,64)'] [image_size='(224,224)']

``artifact`` is either an experiment name (resolved to
``output/quantization/<exp>/fold_<fold>``) or a fold directory path.
``inputs`` entries may be image files (BMP by the native decoder, other
formats by PIL where it is installed), directories (scanned recursively),
or a ``.npy`` uint8 array of shape (N, H, W, 3).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List

import numpy as np

from ..core.config import CLS_NAME_ID_MAP
from .common import parse_cli_kwargs, stage_device

_IMG_EXTS = (".bmp", ".jpg", ".jpeg", ".png")


def _resolve_artifact(artifact: str, fold: int) -> str:
    """Experiment name or fold-dir path -> fold directory holding spec.json."""
    if os.path.isdir(artifact):
        if os.path.exists(os.path.join(artifact, "spec.json")):
            return artifact
        cand = os.path.join(artifact, f"fold_{fold}")
        if os.path.exists(os.path.join(cand, "spec.json")):
            return cand
        raise SystemExit(f"no spec.json under {artifact!r}")
    cand = os.path.join("output", "quantization", artifact, f"fold_{fold}")
    if os.path.exists(os.path.join(cand, "spec.json")):
        return cand
    raise SystemExit(
        f"artifact {artifact!r} is neither a fold directory nor an experiment "
        f"under output/quantization/ (looked for {cand})"
    )


def _scan_inputs(inputs, image_size) -> tuple:
    """inputs spec -> (images uint8 (N,H,W,3), per-image source labels)."""
    from ..data.neudet import load_images

    if isinstance(inputs, (list, tuple)):
        entries = [str(e) for e in inputs]
    else:
        entries = [e for e in str(inputs).split(",") if e]
    paths: List[str] = []
    arrays: List[np.ndarray] = []
    array_names: List[str] = []
    for e in entries:
        if e.endswith(".npy"):
            arr = np.load(e)
            if arr.ndim != 4 or arr.shape[-1] != 3:
                raise SystemExit(f"{e}: expected (N, H, W, 3) uint8, got {arr.shape}")
            arrays.append(arr.astype(np.uint8))
            array_names += [f"{e}[{i}]" for i in range(len(arr))]
        elif os.path.isdir(e):
            for dirpath, _dirs, files in sorted(os.walk(e)):
                paths += [
                    os.path.join(dirpath, f)
                    for f in sorted(files)
                    if f.lower().endswith(_IMG_EXTS)
                ]
        elif os.path.exists(e):
            paths.append(e)
        else:
            raise SystemExit(f"input {e!r} not found")
    if paths:
        arrays.append(load_images(paths, image_size))
    if not arrays:
        raise SystemExit("no images found in inputs")
    images = np.concatenate(arrays) if len(arrays) > 1 else arrays[0]
    names = array_names + paths
    if images.shape[1:3] != tuple(image_size):
        raise SystemExit(
            f".npy images are {images.shape[1:3]}, expected {tuple(image_size)} "
            "(resize happens at decode; pre-resize npy batches yourself)"
        )
    return images, names


def main(argv=None) -> int:
    kw = parse_cli_kwargs(argv)
    artifact = kw.pop("artifact", None)
    inputs = kw.pop("inputs", None)
    if not artifact or not inputs:
        raise SystemExit(__doc__)
    fold = int(kw.pop("fold", 0))
    method = kw.pop("method", "static_int8")
    output = kw.pop("output", None)
    topk = int(kw.pop("topk", 1))
    batch_size = int(kw.pop("batch_size", 256))
    buckets = tuple(kw.pop("buckets", ()) or ())
    image_size = tuple(kw.pop("image_size", (224, 224)))
    if kw:
        raise SystemExit(f"unknown arguments: {sorted(kw)}")

    from ..serving import Predictor, load_quantized

    device = stage_device()
    fold_dir = _resolve_artifact(str(artifact), fold)
    _spec, _model, apply_fn, pre = load_quantized(fold_dir, method, device=device)
    pred = Predictor(
        apply_fn,
        host_preprocess=pre,
        batch_size=min(batch_size, 1024),
        bucket_sizes=buckets,
        device=device,
    )

    images, names = _scan_inputs(inputs, image_size)
    t0 = time.perf_counter()
    logits = pred.predict_logits(images)
    dt = time.perf_counter() - t0

    # stable softmax on the host; tiny next to the device work
    z = logits - logits.max(axis=1, keepdims=True)
    probs = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
    n_cls = logits.shape[1]
    if n_cls == len(CLS_NAME_ID_MAP):
        id_name = {v: k for k, v in CLS_NAME_ID_MAP.items()}
    else:
        id_name = {i: f"class_{i}" for i in range(n_cls)}
    topk = max(1, min(topk, n_cls))
    order = np.argsort(-probs, axis=1)[:, :topk]

    lines = ["image,rank,class_id,class_name,prob"]
    for i, name in enumerate(names):
        for r in range(topk):
            c = int(order[i, r])
            lines.append(f"{name},{r + 1},{c},{id_name[c]},{probs[i, c]:.4f}")
    text = "\n".join(lines) + "\n"
    if output:
        with open(output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    print(
        f"# {len(images)} images · {method} @ {fold_dir} on {device.type} · "
        f"{len(images) / max(dt, 1e-9):.1f} img/s (incl. first-call costs)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
