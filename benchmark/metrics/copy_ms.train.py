"""Mean host milliseconds of the program's `train/batch_to_device` spans in
the traced window: padding a step's batch, pinning it and queueing its
copy to the card."""
from benchmark.harness import spans


def read(ctx):
    return spans.host_ms(ctx, spans.COPY)
