"""Share of the traced window in which no kernel or copy runs on the card
while the host is inside the program's `train/batch_to_device` span."""
from benchmark.harness import spans


def read(ctx):
    return spans.idle_share_inside(ctx, spans.COPY)
