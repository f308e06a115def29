"""Import a reference torch ``.pth`` checkpoint into a fold directory, the
port of the JAX package's ``cli/import_torch.py`` (ResNet family).

The reference's checkpoints (``model_state_dict`` unwrap, ``module.``
prefix strip, full-pickle pruned modules) become the fold-dir contract
(msgpack in the JAX layout, byte-identical to the JAX package's, + spec
JSON)::

    python -m inference_efficient_vision_models_tpu_torch.cli.import_torch \
        path/to/model_best.pth model=resnet18 out=output/kd/myexp/fold_0 \
        [num_classes=6] [which=best]

After this, every downstream stage of either package reads the fold dir as
if it had made it (``cli.teacher.load_stage_model(out, "best")``). The
conversion runs on the host; no device is needed.
"""

from __future__ import annotations

import sys

from ..core import artifacts
from ..core.log import get_logger
from ..models.registry import make_spec, params_to_jax
from ..models.torch_import import load_torch_checkpoint


def _parse_argv(argv):
    import ast

    path = None
    kw = {}
    for a in argv:
        if "=" in a:
            k, v = a.split("=", 1)
            try:
                kw[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                kw[k] = v
        elif path is None:
            path = a
        else:
            raise SystemExit(f"unexpected positional argument {a!r}")
    if path is None:
        raise SystemExit(__doc__)
    return path, kw


def import_torch_checkpoint(
    ckpt_path: str,
    model: str,
    out_dir: str,
    *,
    num_classes: int = 6,
    which: str = artifacts.BEST,
    logger=None,
) -> str:
    """Convert one torch checkpoint; returns the written msgpack path."""
    logger = logger or get_logger(name="import_torch")
    spec = make_spec(model, num_classes=num_classes)
    params, state = load_torch_checkpoint(spec, ckpt_path)
    path = artifacts.save_checkpoint(out_dir, which, params_to_jax(spec, params),
                                     params_to_jax(spec, state), spec)
    logger.info("imported %s (%s, %d classes) → %s", ckpt_path, model, num_classes, path)
    return path


def main(argv=None):
    ckpt_path, kw = _parse_argv(sys.argv[1:] if argv is None else argv)
    if "model" not in kw or "out" not in kw:
        raise SystemExit("required: model=<family name> out=<fold_dir>\n" + __doc__)
    import_torch_checkpoint(
        ckpt_path,
        str(kw["model"]),
        str(kw["out"]),
        num_classes=int(kw.get("num_classes", 6)),
        which=str(kw.get("which", artifacts.BEST)),
    )


if __name__ == "__main__":
    main()
