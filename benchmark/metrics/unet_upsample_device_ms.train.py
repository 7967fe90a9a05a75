"""Stream-ordered device milliseconds a step of the residual U-Net's four
transposed convolutions, forward and backward: the totals of the program's
timed spans `unet3d/upsample` and `unet3d/upsample_backward` in the traced
window over the window's steps (garmentnets_tpu_torch/core/trace.py). None
for a program without them."""


def read(ctx):
    if getattr(ctx, "trace_data", None) is None or not ctx.steps:
        return None
    try:
        from garmentnets_tpu_torch.core import trace
    except ImportError:
        return None
    totals = trace.device_ms()
    got = [totals[k][0] for k in ("unet3d/upsample",
                                  "unet3d/upsample_backward")
           if totals.get(k, (0.0, 0))[1]]
    return sum(got) / ctx.steps if got else None
