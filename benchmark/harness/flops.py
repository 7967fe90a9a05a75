"""The yardstick: published peaks of the chip, and the work of the model
and its layers counted from the configuration's shapes.

The count rule: the algorithm's work is counted once, at the
configuration's precision (float32), whatever products an implementation
splits it into (a float32 product computed as three bf16 products counts
as one). Matrix products are tensor-core work; everything else
(interpolation, norms, activations, distances, reduction) is CUDA-core
work. Each input byte is read once and each output byte written once. A
kernel's least time is the largest of its tensor-core work at the dense
bf16 peak, its CUDA-core work at the f32 peak and its bytes at the memory
bandwidth.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_TENSOR_FLOPS = 989e12      # bf16 tensor cores
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12      # HBM3


class Work:
    """Tensor-core operations, CUDA-core operations and bytes."""

    def __init__(self, tc=0.0, cc=0.0, nbytes=0.0):
        self.tc, self.cc, self.bytes = float(tc), float(cc), float(nbytes)

    def __add__(self, o):
        return Work(self.tc + o.tc, self.cc + o.cc, self.bytes + o.bytes)

    def __mul__(self, k):
        return Work(self.tc * k, self.cc * k, self.bytes * k)

    __rmul__ = __mul__

    @property
    def flops(self) -> float:
        return self.tc + self.cc

    def least_s(self) -> float:
        return max(self.tc / PEAK_TENSOR_FLOPS, self.cc / PEAK_F32_FLOPS,
                   self.bytes / PEAK_BYTES_PER_S)


def mlp(rows: float, channels, norm: bool = True) -> Work:
    """Linear -> ReLU (-> BatchNorm affine) per layer over `rows` rows."""
    tc = cc = 0.0
    for a, b in zip(channels[:-1], channels[1:]):
        tc += 2 * a * b * rows
        cc += (2 + (2 if norm else 0)) * b * rows      # bias, relu, affine
    return Work(tc, cc)


def linear(rows: float, a: int, b: int) -> Work:
    return Work(2 * a * b * rows, b * rows)


def fps(b: int, n: int, m: int) -> Work:
    """m picks over n points: 3 differences, 3 products, 2 sums, a min and
    an argmax compare per point and pick."""
    return Work(0, 10.0 * b * n * m)


def ball_query(b: int, n: int, m: int) -> Work:
    """The distance of every point to every center, and the selection."""
    return Work(0, 9.0 * b * n * m)


def knn(b: int, src: int, dst: int, k: int, c: int) -> Work:
    return Work(0, 9.0 * b * src * dst + 3.0 * b * dst * k * c)


def sa_slots(slots: float, cin: int, channels) -> Work:
    """A set abstraction's MLP and max over `slots` neighbour slots: the
    relative position (3) and the max (c_out) beside the MLP."""
    w = mlp(slots, [cin] + list(channels[1:]))
    return w + Work(0, (3 + channels[-1]) * slots)


def stage1(cfg: dict, b: int, n: int, k: int = 64) -> Work:
    """PointNet++ NOCS forward at its nominal shapes (every slot)."""
    m1 = int(n * cfg["sa1_ratio"])
    m2 = int(m1 * cfg["sa2_ratio"])
    out = cfg["nocs_bins"] * 3
    f = cfg["feature_dim"]
    w = fps(b, n, m1) + ball_query(b, n, m1)
    w += sa_slots(b * m1 * k, 6, (6, 64, 64, 128))
    w += fps(b, m1, m2) + ball_query(b, m1, m2)
    w += sa_slots(b * m2 * k, 131, (131, 128, 128, 256))
    w += mlp(b * m2, (259, 256, 512, 1024)) + Work(0, b * m2 * 1024)
    w += knn(b, 1, m2, cfg["fp3_k"], 1024) + mlp(b * m2, (1280, 256, 256))
    w += knn(b, m2, m1, cfg["fp2_k"], 256) + mlp(b * m1, (384, 256, 128))
    w += knn(b, m1, n, cfg["fp1_k"], 128) + mlp(b * n, (131, 128, 128, 128))
    w += linear(b * n, 128, 128) + linear(b * n, 128, f) + linear(b * n, f, out)
    w += linear(b, 1024, 1024) + linear(b, 1024, out)
    w += Work(0, 3 * b * n * out)                  # argmax and softmax
    return w


def unet3d(b: int, cin: int, cout: int, f_maps: int, levels: int, grid: int,
           groups_norm: bool = True) -> Work:
    """'gcr' U-Net: 3x3x3 convolutions, GroupNorm (~8 operations an
    element), ReLU, max pools, nearest upsampling, a final 1x1x1 conv."""
    fm = [f_maps * 2 ** i for i in range(levels)]
    w = Work()
    ch, g = cin, grid
    sizes = []
    for i, o in enumerate(fm):
        if i:
            w += Work(0, 8 * b * ch * g ** 3)      # max pool (8 to 1)
            g //= 2
        c1 = max(o // 2, ch)
        for a, c in ((ch, c1), (c1, o)):
            vox = b * g ** 3
            w += Work(2 * 27 * a * c * vox, (8 * a + c) * vox)
        sizes.append((o, g))
        ch = o
    for i in range(levels - 1):
        skip_c, g = sizes[levels - 2 - i]
        a = ch + skip_c
        vox = b * g ** 3
        for x, c in ((a, skip_c), (skip_c, skip_c)):
            w += Work(2 * 27 * x * c * vox, (8 * x + c) * vox)
        ch = skip_c
    vox = b * grid ** 3
    return w + Work(2 * ch * cout * vox, cout * vox)


def aggregate(b: int, n: int, channels, grid: int) -> Work:
    return mlp(b * n, channels) + Work(0, b * n * (channels[-1] + 6))


def point_decoder(rows: float, channels) -> Work:
    """Trilinear lookup (8 corners, 3 operations a channel) and the MLP."""
    return Work(0, 24 * channels[0] * rows) + mlp(rows, channels)


def train_sample(cfg: dict, stage: int, n: int, nv: int, ns: int) -> float:
    """Model operations of one training sample: the forward of the trained
    parts three times (forward and backward), the frozen stage 1 once."""
    s1 = stage1(cfg["model"], 1, n).flops
    if stage == 1:
        return 3 * s1
    c = cfg["conv_implicit_model"]
    agg, un = c["volume_agg_params"], c["unet3d_params"]
    g = agg["grid_shape"][0]
    trained = (aggregate(1, n, agg["nn_channels"], g)
               + unet3d(1, un["in_channels"], un["out_channels"],
                        un["f_maps"], un["num_levels"], g)
               + point_decoder(nv, c["volume_decoder_params"]["nn_channels"])
               + point_decoder(ns, c["surface_decoder_params"]["nn_channels"]))
    return s1 + 3 * trained.flops
