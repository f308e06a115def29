"""Launches of the port's hand-written kernels per forward in the profiled
stretch: the program's counter ``ops._lib.launches`` (every kernel summed),
read as the stretch starts and as it stops, over the stretch's forwards.
Each launch costs the host its call; a kernel merged into another shows
here."""


def probe():
    from inference_efficient_vision_models_tpu_torch.ops import _lib

    return sum(_lib.launches.values())


def read(ctx):
    if ctx.probe is None or not ctx.stretch.get("forwards"):
        return None
    before, after = ctx.probe
    return (after - before) / ctx.stretch["forwards"] if after > before else None
