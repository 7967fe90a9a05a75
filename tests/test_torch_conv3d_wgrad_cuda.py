"""The filter-gradient kernel (csrc/conv3d_wgrad.cu, bf16x6) on the card:
at every 3x3x3 convolution shape of both stage-2 U-Nets against float64,
beside cuDNN's f32 filter gradient with TF32 off; bit-equal launches; one
launch a convolution of a train step; shapes it does not take.

Marked `cuda`: every test skips without a CUDA device. On a machine with a
card (this file imports no JAX, so the conftest can be left out):

    python -m pytest tests/test_torch_conv3d_wgrad_cuda.py --noconftest -q
"""
import pytest
import torch

from garmentnets_tpu_torch.core.device import full_f32
from garmentnets_tpu_torch.kernels import _build
from garmentnets_tpu_torch.kernels.conv3d_wgrad import (
    conv3d_wgrad_cuda, wgrad_float64)
from garmentnets_tpu_torch.models import unet3d
from garmentnets_tpu_torch.tools import profile_unet3d

pytestmark = pytest.mark.cuda

BATCH = 24
VOLUME = 32
# (unet, convolutions a train step): UNet3D's 14, ResidualUNet3D's 27
UNETS = (("UNet3D", 14), ("ResidualUNet3D", 27))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def cudnn_wgrad(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cuDNN's f32 filter gradient, TF32 off, asked for directly."""
    w = torch.empty(g.shape[1], x.shape[1], 3, 3, 3, device=g.device)
    with full_f32():
        return torch.ops.aten.convolution_backward(
            g, x, w, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False,
            [0, 0, 0], 1, [False, True, False])[1]


def _rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.double() - ref).abs().max() / ref.abs().max())


def _inputs(dev, B, cin, cout, side, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, cin, side, side, side, device=dev, generator=gen)
    g = torch.randn(B, cout, side, side, side, device=dev, generator=gen)
    return g, x


def _shapes() -> list:
    seen = []
    for unet, _ in UNETS:
        for shape in profile_unet3d.wgrad_shapes(unet, BATCH, VOLUME):
            if shape not in seen:
                seen.append(shape)
    return seen


def test_every_unet_shape_within_twice_cudnn_error(dev):
    """Each distinct (B, Cin, Cout, side) of both U-Nets at B=24, 32^3:
    the kernel's largest error against float64, over the largest entry, at
    most twice cuDNN's f32 filter gradient's (TF32 off)."""
    rows = []
    for B, cin, cout, side in _shapes():
        g, x = _inputs(dev, B, cin, cout, side)
        ref = wgrad_float64(g, x)
        got = conv3d_wgrad_cuda(g, x)
        lib = cudnn_wgrad(g, x)
        torch.cuda.synchronize()
        rows.append((B, cin, cout, side, _rel(got, ref), _rel(lib, ref)))
        del g, x, ref, got, lib
    for row in rows:
        print("B=%d %4d->%-4d at %2d^3: kernel %.3e, cuDNN %.3e" % row)
    bad = [r for r in rows if r[4] > 2 * r[5]]
    assert not bad, bad


def test_two_launches_are_bit_equal(dev):
    """The split-K partial sums are reduced in a fixed order: no atomics."""
    g, x = _inputs(dev, BATCH, 128, 128, VOLUME, seed=1)
    a = conv3d_wgrad_cuda(g, x)
    b = conv3d_wgrad_cuda(g, x)
    assert torch.equal(a, b)


@pytest.mark.parametrize("unet,convs", UNETS)
def test_train_step_launches_once_a_convolution(dev, unet, convs):
    """One launch for each 3x3x3 convolution's filter gradient of a U-Net
    forward and backward (no launch without a backward)."""
    net = profile_unet3d.build_unet(dev, torch.contiguous_format,
                                    unet=unet)
    x = torch.randn(1, 32, 32, 32, 128, device=dev, requires_grad=True)
    before = _build.LAUNCHES["conv3d_wgrad"]
    with torch.no_grad():
        profile_unet3d.unet_apply(net, x, torch.contiguous_format)
    assert _build.LAUNCHES["conv3d_wgrad"] == before
    with full_f32():
        profile_unet3d.unet_apply(net, x, torch.contiguous_format).sum(
            ).backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["conv3d_wgrad"] == before + convs


def test_shapes_the_kernel_does_not_take_raise(dev):
    """A kernel size or padding other than 3 and 1 on a card raises (no
    fall back to cuDNN), as do float64 and CPU tensors at the launcher."""
    g, x = _inputs(dev, 1, 8, 8, 4)
    with pytest.raises(ValueError, match="3x3x3"):
        unet3d.weight_grad(g, x, torch.empty(8, 8, 1, 1, 1, device=dev),
                           (0, 0, 0))
    with pytest.raises(ValueError, match="3x3x3"):
        unet3d.weight_grad(g, x, torch.empty(8, 8, 3, 3, 3, device=dev),
                           (0, 0, 0))
    with pytest.raises(ValueError, match="float32"):
        conv3d_wgrad_cuda(g.double(), x.double())
    with pytest.raises(ValueError, match="CUDA"):
        conv3d_wgrad_cuda(g.cpu(), x.cpu())
