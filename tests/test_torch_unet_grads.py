"""The U-Net's swapped convolution gradients (models/unet3d.SwapGradConv3d)
against nn.Conv3d's, and the process-wide cuDNN flags around a U-Net
forward and a train step.

The test marked `cuda` skips without a card; on a machine with one (this
file imports no JAX, so the conftest can be left out):

    python -m pytest tests/test_torch_unet_grads.py --noconftest -q
"""
import contextlib
import json

import pytest
import torch

from garmentnets_tpu_torch.core.device import full_f32
from garmentnets_tpu_torch.harness.training import make_adam, make_train_fns
from garmentnets_tpu_torch.models import unet3d
from garmentnets_tpu_torch.models.pipeline import PipelineConfig
from garmentnets_tpu_torch.models.unet3d import (
    SwapGradConv3d, UNet3D, _SwapGrad)
from garmentnets_tpu_torch.tools import profile_unet3d

# the caller's cuDNN flags: torch's defaults, and two sets that differ
# from them and from what full_f32 pins inside
CALLER_FLAGS = [
    dict(benchmark=False, deterministic=False, allow_tf32=True),
    dict(benchmark=True, deterministic=True, allow_tf32=False),
    dict(benchmark=True, deterministic=False, allow_tf32=True),
]
# The card's bar for the swapped gradients against nn.Conv3d's, of each
# tensor's largest entry: both are f32 sums of the same products in
# another order (measured ~6e-6 at B=2 on an H100); TF32 products keep
# ~3 decimal digits and part from the f32 path by ~1e-3 of a tensor's
# largest entry, which the test checks lies above the bar.
CARD_REL = 1e-4


def _cudnn_flags() -> dict:
    c = torch.backends.cudnn
    return dict(benchmark=c.benchmark, deterministic=c.deterministic,
                allow_tf32=c.allow_tf32)


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("k,bias", [(3, False), (3, True), (1, True)])
def test_swapped_gradients_equal_conv3d_gradients(dtype, rel, k, bias):
    """_SwapGrad's output, input, weight and bias gradients against
    nn.Conv3d's, on the CPU (the function is the card's; the identities
    hold on any device), on a box that is not a cube."""
    torch.manual_seed(0)
    conv = SwapGradConv3d(5, 3, k, k // 2, bias).to(dtype)
    x = torch.randn(2, 5, 6, 7, 5, dtype=dtype, requires_grad=True)
    y = torch.nn.Conv3d.forward(conv, x)
    g = torch.randn_like(y)
    wrt = [x] + list(conv.parameters())
    want = torch.autograd.grad(y, wrt, g)
    y2 = _SwapGrad.apply(x, conv.weight, conv.bias, conv.padding)
    got = torch.autograd.grad(y2, wrt, g)
    assert torch.equal(y, y2)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= rel * float(b.abs().max())


@pytest.mark.parametrize("flags", CALLER_FLAGS)
def test_swapped_backward_runs_in_full_f32(monkeypatch, flags):
    """SwapGradConv3d (nn.Conv3d's state dict) takes both gradients
    through input_grad and weight_grad, on the CPU as on a card, with TF32
    off inside its own backward whatever flags autograd's caller has set,
    and leaves the caller's flags as they were."""
    seen = []
    for name in ("input_grad", "weight_grad"):
        def spy(*args, fn=getattr(unet3d, name), name=name):
            seen.append((name, _cudnn_flags(),
                         torch.get_float32_matmul_precision()))
            return fn(*args)
        monkeypatch.setattr(unet3d, name, spy)
    conv = SwapGradConv3d(4, 6, 3, 1, False)
    plain = torch.nn.Conv3d(4, 6, 3, padding=1, bias=False)
    assert conv.state_dict().keys() == plain.state_dict().keys()
    x = torch.randn(1, 4, 5, 5, 5, requires_grad=True)
    with torch.backends.cudnn.flags(enabled=True, **flags):
        conv(x).sum().backward()
        assert _cudnn_flags() == flags
    assert [n for n, _, _ in seen] == ["input_grad", "weight_grad"]
    for _, f, precision in seen:
        assert not f["allow_tf32"] and precision == "highest"
        assert (f["benchmark"], f["deterministic"]) == (
            flags["benchmark"], flags["deterministic"])


def _small_unet():
    torch.manual_seed(0)
    return UNet3D(8, 4, f_maps=8, num_levels=2)


@pytest.mark.parametrize("flags", CALLER_FLAGS)
def test_unet_forward_leaves_cudnn_flags_as_set(flags):
    net = _small_unet()
    seen = []
    net.abstract_3d_unet.encoders[0].basic_module.SingleConv1.conv \
        .register_forward_hook(lambda *a: seen.append(_cudnn_flags()))
    with torch.backends.cudnn.flags(enabled=True, **flags):
        net(torch.randn(1, 4, 4, 4, 8))
        assert _cudnn_flags() == flags
    assert not seen[0]["allow_tf32"]


@pytest.mark.parametrize("flags", CALLER_FLAGS)
def test_train_step_leaves_cudnn_flags_as_set(flags):
    """A train step of a U-Net: TF32 off in its convolutions' forward and
    backward, the caller's flags again after it."""
    net = _small_unet()
    conv = net.abstract_3d_unet.encoders[0].basic_module.SingleConv1.conv
    seen = []
    conv.register_forward_hook(
        lambda *a: seen.append(("fwd", _cudnn_flags())))
    conv.weight.register_hook(
        lambda g: seen.append(("bwd", _cudnn_flags())))
    train_step, _ = make_train_fns(
        net, lambda b, g: net(b["x"]),
        lambda out, b: {"loss": out.square().mean()}, make_adam(net, 1e-3))
    with torch.backends.cudnn.flags(enabled=True, **flags):
        train_step({"x": torch.randn(2, 4, 4, 4, 8)})
        assert _cudnn_flags() == flags
    assert [w for w, _ in seen] == ["fwd", "bwd"]
    assert not any(f["allow_tf32"] for _, f in seen)


def _unet_grads(net, x, gy, scope=full_f32) -> dict:
    """The U-Net's output, input gradient and parameter gradients, its
    forward and backward inside scope() as in a train step."""
    net.zero_grad(set_to_none=True)
    x = x.detach().requires_grad_(True)
    with scope():
        y = net(x)
        y.backward(gy)
    return {"output": y.detach(), "input": x.grad,
            **{k: p.grad for k, p in net.named_parameters()}}


def _worst(got: dict, want: dict) -> tuple:
    return max((float((got[k] - want[k]).abs().max())
                / float(want[k].abs().max()), k) for k in want)


@pytest.mark.cuda
def test_swapped_unet_gradients_match_conv3d_on_card(monkeypatch):
    """The pipeline's U-Net (128 channels in and out, 32^3, 'gcr', 4
    levels) at B=2 in f32 on the card: its output, input gradient and
    every parameter's gradient with SwapGradConv3d against nn.Conv3d's
    own backward, within CARD_REL of each tensor's largest entry; the
    same with the convolutions in TF32 lies outside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the swapped gradients run there")
    dev = torch.device("cuda", 0)
    c = PipelineConfig()
    torch.manual_seed(0)
    net = UNet3D(c.unet_in_channels, c.unet_out_channels,
                 f_maps=c.unet_f_maps, layer_order=c.unet_layer_order,
                 num_groups=c.unet_num_groups,
                 num_levels=c.unet_num_levels).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(2, 32, 32, 32, c.unet_in_channels, device=dev,
                    generator=gen)
    gy = torch.randn(2, 32, 32, 32, c.unet_out_channels, device=dev,
                     generator=gen)
    new = _unet_grads(net, x, gy)
    monkeypatch.setattr(SwapGradConv3d, "forward", torch.nn.Conv3d.forward)
    old = _unet_grads(net, x, gy)
    worst = _worst(new, old)
    assert worst[0] <= CARD_REL, worst
    # the control: nothing pins TF32 off
    monkeypatch.setattr("garmentnets_tpu_torch.models.unet3d.full_f32",
                        contextlib.nullcontext)
    tf32 = _unet_grads(net, x, gy, lambda: torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=False,
        allow_tf32=True))
    assert _worst(tf32, old)[0] > CARD_REL


def test_profile_unet3d_dry_run_on_cpu(tmp_path):
    """The tool's dry run at a tiny size: the heuristic and the port's
    candidate, each in its own process, all 15 convolutions in three
    directions, and the comparison of their gradients."""
    out = tmp_path / "profile.json"
    profile_unet3d.main(["--device", "cpu", "--batch", "2",
                         "--eval-batch", "1", "--cmp-batch", "1",
                         "--volume", "8", "--reps", "1",
                         "--candidates", "port", "--no-flags",
                         "--out", str(out)])
    res = json.loads(out.read_text())
    assert sorted(res["candidates"]) == ["heuristic", "port"]
    for cand in res["candidates"].values():
        assert len(cand["convs"]) == 15
        assert all(row[d + "_ms"] > 0 for row in cand["convs"]
                   for d in profile_unet3d.DIRECTIONS)
    # 2 k^3 B V Cin Cout of the first convolution, 128 -> 128 at 3x3x3
    first = res["candidates"]["port"]["convs"][0]
    assert first["flops"] == 2 * 27 * 2 * 8 ** 3 * 128 * 128
    assert res["diff"]["port"] <= 1e-5
