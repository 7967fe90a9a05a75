"""Mean stream-ordered device milliseconds of the stage-2 U-Net's forward
in the traced window: the program's timed span `unet3d/forward`, CUDA
events at the entry and exit of UNet3D.forward
(garmentnets_tpu_torch/core/trace.py)."""
from benchmark.harness import spans


def read(ctx):
    return spans.device_ms(ctx, "unet3d/forward")
