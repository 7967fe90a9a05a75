"""Mean host milliseconds of the program's `train/backward` spans in the
traced window: zero_grad and `loss.backward()` until it returns (autograd
issues the backward from its own thread while the caller waits)."""
from benchmark.harness import spans


def read(ctx):
    return spans.host_ms(ctx, "train/backward")
