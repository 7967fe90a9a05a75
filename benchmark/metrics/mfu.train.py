"""Model operations of the samples stepped in the window (forward three
times for the trained parts, once for a frozen stage 1;
harness/flops.py: train_sample) over the window, as a share of the
card's dense bf16 peak."""
from benchmark.harness import flops


def read(ctx):
    dm = ctx.config["datamodule"]
    per = flops.train_sample(ctx.config, ctx.traffic["stage"],
                             dm["num_pc_sample"], dm["num_volume_sample"],
                             dm["num_surface_sample"])
    return 100.0 * per * ctx.samples / ctx.window_s / flops.PEAK_TENSOR_FLOPS
