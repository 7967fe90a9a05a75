"""Mean host milliseconds of the program's `train/optimizer` spans in the
traced window: issuing Adam's step."""
from benchmark.harness import spans


def read(ctx):
    return spans.host_ms(ctx, "train/optimizer")
