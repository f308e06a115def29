"""The program's own spans (``utils/profiling.totals()``: name -> (count,
seconds)), read as the profiled stretch starts and as it stops. A program
without them reads as nothing, and its metrics are left out of the result
line."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple


def probe():
    """The program's totals now, or None where it keeps none."""
    from inference_efficient_vision_models_tpu_torch.utils import profiling

    totals = getattr(profiling, "totals", None)
    return totals() if totals is not None else None


def delta(ctx, name: str) -> Tuple[int, float]:
    """(count, seconds) that ``name`` added over the stretch."""
    before, after = ctx.probe or (None, None)
    if before is None or after is None:
        return 0, 0.0
    c0, s0 = before.get(name, (0, 0.0))
    c1, s1 = after.get(name, (0, 0.0))
    return c1 - c0, s1 - s0


def ms_per(ctx, seconds_of: Sequence[str], count_of: str) -> Optional[float]:
    """The seconds of the spans ``seconds_of`` over the stretch, in ms per
    span ``count_of`` over it; None where that count did not advance."""
    n = delta(ctx, count_of)[0]
    if n <= 0:
        return None
    return 1e3 * sum(delta(ctx, name)[1] for name in seconds_of) / n
