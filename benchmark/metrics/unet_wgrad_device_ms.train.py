"""Stream-ordered device milliseconds a step of the stage-2 U-Net's 3x3x3
filter gradients: the total of the program's timed span `unet3d/wgrad`
(each SwapGradConv3d's filter gradient, garmentnets_tpu_torch/models/
unet3d.py) in the traced window over the window's steps. None for a
program without it."""


def read(ctx):
    if getattr(ctx, "trace_data", None) is None or not ctx.steps:
        return None
    try:
        from garmentnets_tpu_torch.core import trace
    except ImportError:
        return None
    ms, n = trace.device_ms().get("unet3d/wgrad", (0.0, 0))
    return ms / ctx.steps if n else None
