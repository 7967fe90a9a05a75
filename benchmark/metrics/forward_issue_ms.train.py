"""Mean host milliseconds of the program's `train/forward` spans in the
traced window: issuing the forward and the loss."""
from benchmark.harness import spans


def read(ctx):
    return spans.host_ms(ctx, "train/forward")
