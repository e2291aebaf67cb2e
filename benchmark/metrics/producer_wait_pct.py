"""The share of the window, in %, in which the stream's producer waits
for room in the queue of batches in flight (`stream.backpressure`
spans): the device and the fetcher behind it set the pace there."""

from benchmark import spans


def read(ctx):
    got = spans.host_seconds(ctx.trace, (spans.BACKPRESSURE,))
    return None if got is None or not ctx.window_s else 100.0 * got[1] / ctx.window_s
