"""Seconds from the process's start to the first timed call: imports,
inputs and weights, the program's build (and, in a fresh checkout, its
compile) and warm-up."""


def read(ctx):
    return ctx.setup_s
