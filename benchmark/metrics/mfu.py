"""The whole window's share of the card's peak: the useful operations of
every frame restored in the traced window over the window's length at the
data-sheet peak, in %. Reads `mfu` and each cell's own `mfu.<cell>`."""


def read(ctx):
    if ctx.trace is None or not ctx.peak_ops or not ctx.frames:
        return None
    return 100.0 * ctx.frames * ctx.ops_per_frame / ctx.peak_ops / ctx.window_s
