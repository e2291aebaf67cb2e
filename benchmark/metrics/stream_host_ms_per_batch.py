"""Host ms per batch the stream's producer spends on its own work: the
copy into the pinned slot (`stream.stage_in`) and the enqueues of the
host->device and device->host copies (`stream.upload`,
`stream.download`), over the batches sent (`stream.send` spans). The
fetcher's sink runs on a thread the harness's profiler does not follow,
so it is not counted."""

from benchmark import spans


def read(ctx):
    got = spans.host_seconds(ctx.trace, (spans.STAGE_IN, spans.UPLOAD, spans.DOWNLOAD))
    return None if got is None else 1e3 * got[1] / got[0]
