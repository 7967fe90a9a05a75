"""Mean stream-ordered device milliseconds of the program's
`train/optimizer` phase (Adam) in the traced window (CUDA events at its
entry and exit; core/trace.py)."""
from benchmark.harness import spans


def read(ctx):
    return spans.device_ms(ctx, "train/optimizer")
