"""Device ms per frame of what the library GEMM route's `conv.assemble`
spans launched (each band's accumulators copied into its layer's
output), their union; read where the trace attributes the compute
stream's events to program spans (`benchmark/spans.py`)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms_per_frame(ctx, ("conv.assemble",))
