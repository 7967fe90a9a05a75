"""Plain PyTorch reference of the residual 3D U-Net (pytorch-3dunet's
ResidualUNet3D, Lee et al. 2017, arXiv:1706.00120; GarmentNets'
components/unet3d.py:147-192 and 494-509), for judging how the port trains
a pipeline built on it.

Written from the published block equations in plain torch operations
(`F.group_norm`, `F.conv3d`, `F.conv_transpose3d`, `F.max_pool3d`),
float32, with nothing of the port imported. In the 'gcr' order a
SingleConv is GroupNorm over its input, a 3x3x3 convolution without bias,
then ReLU (`SC_gc` stops before the ReLU):

    h1 = SC_gcr(x);  block(x) = ReLU(SC_gc(SC_gcr(h1)) + h1)

Encoder k > 0 max-pools by 2 first; decoder k runs
ConvTranspose3d(c_{k+1} -> c_k, kernel 3, stride 2, padding 1) to the
skip's size, sums it with the skip, then a block c_k -> c_k; last a 1x1x1
convolution. The weights are read by the residual names
(`encoders.{i}.basic_module.conv{1,2,3}.*`,
`decoders.{i}.upsampling.upsample.*`), so the state of any other U-Net
fails with a KeyError.

`in_reference()` puts this U-Net in the place of reference/model.py's
for the stage-2 loss inside the block.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference import model as M

BASE = "unet_3d.abstract_3d_unet."
GN_EPS = 1e-5


def _gc(x, p, prefix: str, groups: int):
    """GroupNorm over x's channels (one group where they are fewer than
    `groups`), then the 3x3x3 convolution without bias."""
    gw = p[prefix + "groupnorm.weight"]
    x = F.group_norm(x, groups if gw.numel() >= groups else 1, gw,
                     p[prefix + "groupnorm.bias"], eps=GN_EPS)
    return F.conv3d(x, p[prefix + "conv.weight"], padding=1)


def block(x, p, prefix: str, groups: int, residual: bool = True):
    """ExtResNetBlock in the 'gcr' order; residual False leaves the sum
    with h1 out (a planted fault)."""
    h1 = torch.relu(_gc(x, p, prefix + "conv1.", groups))
    out = _gc(torch.relu(_gc(h1, p, prefix + "conv2.", groups)), p,
              prefix + "conv3.", groups)
    return torch.relu(out + h1 if residual else out)


def upsample(x, p, prefix: str, size):
    """The stride-2 transposed convolution to the spatial `size`."""
    pad = [s - (2 * n - 1) for s, n in zip(size, x.shape[2:])]
    return F.conv_transpose3d(x, p[prefix + "weight"], p[prefix + "bias"],
                              stride=2, padding=1, output_padding=pad)


def unet3d(p, vol, groups: int, levels: int, residual_left_out=None):
    """[B, D, H, W, C] -> [B, D, H, W, C_out]; residual_left_out: the index
    of the decoder whose block leaves its residual sum out (a planted
    fault), None for none."""
    x = vol.permute(0, 4, 1, 2, 3)
    skips = []
    for i in range(levels):
        if i:
            x = F.max_pool3d(x, 2)
        x = block(x, p, f"{BASE}encoders.{i}.basic_module.", groups)
        skips.insert(0, x)
    for i, skip in enumerate(skips[1:]):
        d = f"{BASE}decoders.{i}."
        x = skip + upsample(x, p, d + "upsampling.upsample.", skip.shape[2:])
        x = block(x, p, d + "basic_module.", groups,
                  residual=i != residual_left_out)
    x = F.conv3d(x, p[BASE + "final_conv.weight"], p[BASE + "final_conv.bias"])
    return x.permute(0, 2, 3, 4, 1)


def check_config(unet_params: dict) -> None:
    """The configuration this reference computes: the residual U-Net in the
    'gcr' order."""
    if (unet_params.get("name") != "ResidualUNet3D"
            or unet_params.get("layer_order") != "gcr"):
        raise ValueError("the residual reference computes "
                         "unet3d_params.name ResidualUNet3D in the 'gcr' "
                         f"order, not {unet_params}")


def state_names(levels: int) -> list:
    """The names of the weights unet3d reads, in the order it reads them."""
    def blk(prefix):
        return [f"{prefix}conv{j}.{leaf}" for j in (1, 2, 3)
                for leaf in ("groupnorm.weight", "groupnorm.bias",
                             "conv.weight")]
    names = []
    for i in range(levels):
        names += blk(f"{BASE}encoders.{i}.basic_module.")
    for i in range(levels - 1):
        d = f"{BASE}decoders.{i}."
        names += [d + "upsampling.upsample.weight",
                  d + "upsampling.upsample.bias"] + blk(d + "basic_module.")
    return names + [BASE + "final_conv.weight", BASE + "final_conv.bias"]


def check_state(names, levels: int) -> None:
    """A state whose names lack one that unet3d reads (a program that built
    another U-Net) fails here, with a KeyError naming the first."""
    missing = [k for k in state_names(levels) if k not in names]
    if missing:
        raise KeyError(missing[0])


@contextlib.contextmanager
def in_reference(residual_left_out=None):
    """reference/model.py's stage-2 loss runs this U-Net inside the block
    (residual_left_out as unet3d's), and its own again after it."""
    prev = M.unet3d

    def unet(p, vol, groups, levels):
        return unet3d(p, vol, groups, levels, residual_left_out)

    M.unet3d = unet
    try:
        yield
    finally:
        M.unet3d = prev
