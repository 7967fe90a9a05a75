"""3D U-Nets (torch port of garmentnets_tpu/models/unet3d.py): UNet3D with
SingleConv/DoubleConv, and ResidualUNet3D with ExtResNetBlock.

Public layout is channels-last [B, D, H, W, C] as in the JAX package;
inside, the volume runs channels-first through Conv3d. Module names follow
the reference Lightning layout (`abstract_3d_unet.encoders.{i}.basic_module.
SingleConv{1,2}.{groupnorm,conv,batchnorm}`, `final_conv`).

Conv3d runs with TF32 off: cuDNN's TF32 default keeps ~3 decimal digits
and would break the f32 parity bar. The 3x3x3 convolutions take their
gradients as swapped problems (SwapGradConv3d): at the U-Net's shapes
cuDNN's heuristics run those on engines up to 3.6x faster than the ones
they pick for the same sums asked as input and filter gradients. 'gcr' (the shipped order) has no running statistics; an order
with 'b' normalizes with BatchNorm3d's batch statistics in training mode
and moves its running statistics (momentum 0.1, unbiased variance), as
the JAX MaskedBatchNorm does without a mask.
ResidualUNet3D (reference unet3d.py:494-509) is keyed like UNet3D, with
`encoders.{i}.basic_module.conv{1,2,3}` and
`decoders.{i}.upsampling.upsample` (a ConvTranspose3d); no
PipelineConfig selects it.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from garmentnets_tpu_torch.core.device import full_f32
from garmentnets_tpu_torch.core.trace import backward_span, span
from garmentnets_tpu_torch.models.mlp import train_batch_norm


class BatchNorm3d(nn.BatchNorm3d):
    """nn.BatchNorm3d over [B, C, D, H, W]; in training mode under a process
    group (models/mlp.set_batch_norm_group) it takes the statistics of the
    ranks' batches together, with models/mlp.train_batch_norm."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.group is None:
            return super().forward(x)
        return train_batch_norm(self, x.movedim(1, -1), None,
                                self.group).movedim(-1, 1)


def number_of_features_per_level(init: int, num_levels: int):
    return [init * 2 ** k for k in range(num_levels)]


def _swapped(weight, padding) -> tuple:
    """The kernel and padding of the swapped problem: the convolution at
    stride 1 from the output back to the input, the kernel flipped and its
    in and out channels exchanged."""
    pad = [n - 1 - p for n, p in zip(weight.shape[2:], padding)]
    return weight.transpose(0, 1).flip(2, 3, 4).contiguous(), pad


def input_grad(grad, weight, padding):
    """The input gradient of a stride-1 convolution as the forward
    convolution of the swapped problem on the output gradient (the same
    sum in another order)."""
    w, pad = _swapped(weight, padding)
    return F.conv3d(grad, w, None, 1, pad)


def weight_grad(grad, x, weight, padding):
    """The filter gradient of a stride-1 convolution as the filter
    gradient of the swapped problem (from grad to x), turned back: the
    same sum in another order."""
    w, pad = _swapped(weight, padding)
    swapped = torch.ops.aten.convolution_backward(
        x, grad, w, None, [1, 1, 1], pad, [1, 1, 1], False, [0, 0, 0], 1,
        [False, True, False])[1]
    return swapped.transpose(0, 1).flip(2, 3, 4).contiguous()


class _SwapGrad(torch.autograd.Function):
    """conv3d at stride 1 whose backward is input_grad and weight_grad,
    in full f32 whatever flags the backward's caller has set."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding):
        ctx.save_for_backward(x, weight)
        ctx.padding, ctx.bias = padding, bias is not None
        return F.conv3d(x, weight, bias, 1, padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        grad = grad.contiguous()
        gx = gw = gb = None
        with full_f32():
            if ctx.needs_input_grad[0]:
                gx = input_grad(grad, weight, ctx.padding)
            if ctx.needs_input_grad[1]:
                gw = weight_grad(grad, x, weight, ctx.padding)
        if ctx.bias and ctx.needs_input_grad[2]:
            gb = grad.sum((0, 2, 3, 4))
        return gx, gw, gb, None


class SwapGradConv3d(nn.Conv3d):
    """nn.Conv3d at stride 1 (same state dict) whose gradients are
    input_grad and weight_grad: on a card the U-Net's input gradients then
    run on cuDNN's f32 implicit-GEMM forward engines and its filter
    gradients on the swapped problem, at the same f32 sums
    (tools/profile_unet3d.py measures both ways)."""

    def __init__(self, in_channels, out_channels, kernel_size, padding,
                 bias):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=padding, bias=bias)

    def forward(self, x):
        return _SwapGrad.apply(x, self.weight, self.bias, self.padding)


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
                self.add_module("conv", SwapGradConv3d(
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
                self.add_module("batchnorm", BatchNorm3d(n))
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


class ExtResNetBlock(nn.Module):
    """Residual block (reference unet3d.py:147-192): conv1, then conv2 and
    conv3 (conv3's order without its nonlinearity), summed with conv1's
    output, then the order's nonlinearity (ELU, LeakyReLU or ReLU)."""

    def __init__(self, in_channels: int, out_channels: int,
                 order: str = "cge", num_groups: int = 8):
        super().__init__()
        plain = "".join(c for c in order if c not in "rel")
        self.conv1 = SingleConv(in_channels, out_channels, 3, order,
                                num_groups)
        self.conv2 = SingleConv(out_channels, out_channels, 3, order,
                                num_groups)
        self.conv3 = SingleConv(out_channels, out_channels, 3, plain,
                                num_groups)
        self.order = order

    def forward(self, x):
        out = self.conv1(x)
        out = self.conv3(self.conv2(out)) + out
        if "l" in self.order:
            return F.leaky_relu(out, 0.1)
        if "e" in self.order:
            return F.elu(out)
        return F.relu(out)


class _Upsampling(nn.Module):
    """ConvTranspose3d(k=3, s=2, p=1) to the skip's size (output padding
    1 for the exact doubling of every level)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.upsample = nn.ConvTranspose3d(in_channels, out_channels, 3,
                                           stride=2, padding=1)

    def forward(self, x, size):
        return self.upsample(x, output_size=size)


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


class _ResidualDecoder(nn.Module):
    def __init__(self, in_channels, out_channels, order, num_groups):
        super().__init__()
        self.upsampling = _Upsampling(in_channels, out_channels)
        self.basic_module = ExtResNetBlock(out_channels, out_channels, order,
                                           num_groups)


class _ResidualAbstract3DUNet(nn.Module):
    def __init__(self, in_channels, out_channels, f_maps, order, num_groups,
                 num_levels):
        super().__init__()
        fm = (number_of_features_per_level(f_maps, num_levels)
              if isinstance(f_maps, int) else list(f_maps))
        encs, ch = [], in_channels
        for o in fm:
            encs.append(_Stage(ExtResNetBlock(ch, o, order, num_groups)))
            ch = o
        self.encoders = nn.ModuleList(encs)
        rev = list(reversed(fm))
        self.decoders = nn.ModuleList([
            _ResidualDecoder(rev[i], rev[i + 1], order, num_groups)
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
            x = skip + dec.upsampling(x, skip.shape[2:])
            x = dec.basic_module(x)
        return self.final_conv(x)


class ResidualUNet3D(nn.Module):
    """The residual variant (reference unet3d.py:494-509): ExtResNetBlock
    basic modules, max-pool encoders, transposed-convolution upsampling
    joined by summation, final 1x1x1 conv; 5 levels by default."""

    def __init__(self, in_channels: int, out_channels: int, f_maps=32,
                 layer_order: str = "cge", num_groups: int = 8,
                 num_levels: int = 5):
        super().__init__()
        self.abstract_3d_unet = _ResidualAbstract3DUNet(
            in_channels, out_channels, f_maps, layer_order, num_groups,
            num_levels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, D, H, W, C] -> [B, D, H, W, C_out]."""
        h = x.permute(0, 4, 1, 2, 3).contiguous()
        with full_f32():
            h = self.abstract_3d_unet(h)
        return h.permute(0, 2, 3, 4, 1).contiguous()


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
        """x: [B, D, H, W, C] -> [B, D, H, W, C_out]. Under a profiler the
        forward is the timed span `unet3d/forward` and its backward
        `unet3d/backward` (core/trace.py)."""
        with span("unet3d/forward", x.device):
            x, close = backward_span("unet3d/backward", x)
            h = x.permute(0, 4, 1, 2, 3).contiguous()
            with full_f32():
                h = self.abstract_3d_unet(h)
            return close(h.permute(0, 2, 3, 4, 1).contiguous())
