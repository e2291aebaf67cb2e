"""Device ms per frame of the int32 epilogues: what the spans `conv.bias`,
`wide.input` (the input's centring), `wide.requant` (each hidden layer's
BLU requant) and `wide.residual` (the tail's residual and its add)
launched, their union; read where the trace attributes the compute
stream's events to program spans (`benchmark/spans.py`)."""

from benchmark import spans

EPILOGUES = ("conv.bias", "wide.input", "wide.requant", "wide.residual")


def read(ctx):
    return spans.device_ms_per_frame(ctx, EPILOGUES)
