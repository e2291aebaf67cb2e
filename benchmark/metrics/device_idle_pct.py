"""The share of the traced window in which no kernel and no copy runs on
the card, in %. Reads `device_idle_pct` and each cell's own
`device_idle_pct.<cell>`."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s():
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.window_s)
