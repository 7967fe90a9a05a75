"""3D U-Net (torch port of garmentnets_tpu/models/unet3d.py: UNet3D with
SingleConv/DoubleConv).

Public layout is channels-last [B, D, H, W, C] as in the JAX package;
inside, the volume runs channels-first through Conv3d. Module names follow
the reference Lightning layout (`abstract_3d_unet.encoders.{i}.basic_module.
SingleConv{1,2}.{groupnorm,conv,batchnorm}`, `final_conv`).

Conv3d runs with TF32 off: cuDNN's TF32 default keeps ~3 decimal digits
and would break the f32 parity bar. ResidualUNet3D waits for a later slice.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from garmentnets_tpu_torch.core.device import full_f32


def number_of_features_per_level(init: int, num_levels: int):
    return [init * 2 ** k for k in range(num_levels)]


class SingleConv(nn.Sequential):
    """One conv layer from an order string (reference create_conv):
    c(onv) g(roupnorm) b(atchnorm) r(elu) l(eaky relu) e(lu). The conv has
    no bias when a norm is present; GroupNorm eps is 1e-5."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, order: str = "gcr",
                 num_groups: int = 8):
        super().__init__()
        if "c" not in order or order[0] in "rle":
            raise ValueError(f"invalid conv order {order!r}")
        conv_pos = order.index("c")
        for i, ch in enumerate(order):
            if ch == "c":
                self.add_module("conv", nn.Conv3d(
                    in_channels, out_channels, kernel_size,
                    padding=kernel_size // 2,
                    bias=not ("g" in order or "b" in order)))
            elif ch == "g":
                n = in_channels if i < conv_pos else out_channels
                groups = num_groups if n >= num_groups else 1
                self.add_module("groupnorm", nn.GroupNorm(groups, n,
                                                          eps=1e-5))
            elif ch == "b":
                n = in_channels if i < conv_pos else out_channels
                self.add_module("batchnorm", nn.BatchNorm3d(n))
            elif ch == "r":
                self.add_module("ReLU", nn.ReLU())
            elif ch == "l":
                self.add_module("LeakyReLU", nn.LeakyReLU(0.1))
            elif ch == "e":
                self.add_module("ELU", nn.ELU())
            else:
                raise ValueError(f"unsupported layer type {ch!r}")


class DoubleConv(nn.Module):
    """Two SingleConvs; the encoder halves-then-expands channels with the
    reference's clamp rule."""

    def __init__(self, in_channels: int, out_channels: int, encoder: bool,
                 order: str = "gcr", num_groups: int = 8):
        super().__init__()
        if encoder:
            c1_out = max(out_channels // 2, in_channels)
            c1_in, c2_in, c2_out = in_channels, c1_out, out_channels
        else:
            c1_in, c1_out = in_channels, out_channels
            c2_in, c2_out = out_channels, out_channels
        self.SingleConv1 = SingleConv(c1_in, c1_out, 3, order, num_groups)
        self.SingleConv2 = SingleConv(c2_in, c2_out, 3, order, num_groups)

    def forward(self, x):
        return self.SingleConv2(self.SingleConv1(x))


class _Stage(nn.Module):
    def __init__(self, basic_module: nn.Module):
        super().__init__()
        self.basic_module = basic_module


class _Abstract3DUNet(nn.Module):
    def __init__(self, in_channels, out_channels, f_maps, order, num_groups,
                 num_levels):
        super().__init__()
        fm = (number_of_features_per_level(f_maps, num_levels)
              if isinstance(f_maps, int) else list(f_maps))
        encs, ch = [], in_channels
        for o in fm:
            encs.append(_Stage(DoubleConv(ch, o, True, order, num_groups)))
            ch = o
        self.encoders = nn.ModuleList(encs)
        rev = list(reversed(fm))
        self.decoders = nn.ModuleList([
            _Stage(DoubleConv(rev[i] + rev[i + 1], rev[i + 1], False, order,
                              num_groups))
            for i in range(len(rev) - 1)])
        self.final_conv = nn.Conv3d(fm[0], out_channels, 1)

    def forward(self, x):
        feats = []
        for i, enc in enumerate(self.encoders):
            if i > 0:
                x = F.max_pool3d(x, 2)
            x = enc.basic_module(x)
            feats.insert(0, x)
        for dec, skip in zip(self.decoders, feats[1:]):
            # nearest upsample by repeat (spatial dims always exactly x2)
            for ax in (2, 3, 4):
                x = x.repeat_interleave(skip.shape[ax] // x.shape[ax], dim=ax)
            x = dec.basic_module(torch.cat([skip, x], dim=1))
        return self.final_conv(x)


class UNet3D(nn.Module):
    """Abstract3DUNet parity: DoubleConv basic module, max-pool encoders,
    nearest-upsample + concat decoders, final 1x1x1 conv."""

    def __init__(self, in_channels: int, out_channels: int, f_maps=32,
                 layer_order: str = "gcr", num_groups: int = 8,
                 num_levels: int = 4):
        super().__init__()
        self.abstract_3d_unet = _Abstract3DUNet(
            in_channels, out_channels, f_maps, layer_order, num_groups,
            num_levels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, D, H, W, C] -> [B, D, H, W, C_out]."""
        h = x.permute(0, 4, 1, 2, 3).contiguous()
        with full_f32():
            h = self.abstract_3d_unet(h)
        return h.permute(0, 2, 3, 4, 1).contiguous()
