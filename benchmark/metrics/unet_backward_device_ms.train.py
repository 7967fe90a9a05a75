"""Mean stream-ordered device milliseconds of the stage-2 U-Net's backward
in the traced window: the program's timed span `unet3d/backward`, CUDA
events recorded as the gradient of the U-Net's output arrives and once
the gradient of its input is done (garmentnets_tpu_torch/core/trace.py
`backward_span`)."""
from benchmark.harness import spans


def read(ctx):
    return spans.device_ms(ctx, "unet3d/backward")
