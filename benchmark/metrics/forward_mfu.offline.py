"""The executor's share of the card's dense int8 peak over the profiled
stretch (%): 2 x the model's MACs per image (counted from the spec by the
configuration's roofline module) x the images the stretch returned / the
device time of every kernel there (copies and sets left out) / the peak."""


def read(ctx):
    st = ctx.stretch
    if ctx.peaks is None or ctx.trace is None or not st.get("images"):
        return None
    t = ctx.trace.seconds(kind="kernel")
    if t <= 0:
        return None
    return 100.0 * 2.0 * ctx.macs_per_image * st["images"] / t / ctx.peaks["int8_ops_per_s"]
