"""Device ms per frame of every kernel beside the library GEMMs and the
port's network kernels (the route's im2col, bias and requant epilogues),
memsets and copies on the device, their union; read where the trace has
GEMMs."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device["gemm"] or not ctx.frames:
        return None
    return 1e3 * t.seconds("kernel", "copy") / ctx.frames
