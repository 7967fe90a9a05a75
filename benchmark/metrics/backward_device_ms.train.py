"""Mean stream-ordered device milliseconds of the program's
`train/backward` phase in the traced window (CUDA events at its entry
and after `loss.backward()` returns; core/trace.py)."""
from benchmark.harness import spans


def read(ctx):
    return spans.device_ms(ctx, "train/backward")
