"""The library GEMMs (`trace.GEMM` names) against their roofline: the
useful convolution operations of the frames the window restored, at the
data-sheet peak, over the union of the GEMMs' device time, in %."""


def read(ctx):
    t = ctx.trace
    busy = t.seconds("gemm") if t is not None else 0.0
    if not busy or not ctx.peak_ops:
        return None
    return 100.0 * ctx.frames * ctx.ops_per_frame / ctx.peak_ops / busy
