"""Mean stream-ordered device milliseconds of the program's `train/forward`
phase in the traced window: CUDA events recorded on the step's stream at
the phase's entry and exit (garmentnets_tpu_torch/core/trace.py)."""
from benchmark.harness import spans


def read(ctx):
    return spans.device_ms(ctx, "train/forward")
