"""Frames returned to host memory in the window over the window's whole
length (host clock). Reads `fps` and each cell's own `fps.<cell>`."""


def read(ctx):
    return ctx.frames / ctx.window_s if ctx.frames else None
