"""The port's step-phase spans (core/trace.py) around make_train_fns' train
step and batch_to_device: named in a profiler's trace, absent without one,
and without effect on the step's arithmetic.

One test is marked `cuda` and skips without a card; on a machine with one
(this file imports no JAX, so the conftest can be left out):

    python -m pytest tests/test_torch_trace.py --noconftest -q
"""
import itertools
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from garmentnets_tpu_torch.core import trace
from garmentnets_tpu_torch.harness.training import (
    batch_to_device, make_adam, make_train_fns)
from garmentnets_tpu_torch.models import pointnet2_nocs as nocs
from garmentnets_tpu_torch.models.unet3d import UNet3D

PHASES = ["train/batch_to_device", "train/forward", "train/backward",
          "train/optimizer"]
TIMED = PHASES[1:]


def _host_batch(seed: int, B: int = 2, N: int = 64) -> dict:
    rng = np.random.default_rng(seed)
    y = rng.uniform(0.0, 1.0, (B, N, 3)).astype(np.float32)
    return {"x": rng.uniform(0.0, 1.0, (B, N, 3)).astype(np.float32),
            "pos": (rng.uniform(0.0, 1.0, (B, N, 3)) - 0.5).astype(
                np.float32),
            "y": y, "nocs_grip_point": y[:, 0].copy()}


def _stage1(device):
    """A small stage-1 model (dropout on) and make_train_fns' train step."""
    cfg = nocs.PointNet2NOCSConfig(nocs_bins=8, sa1_r=0.2, sa2_r=0.4,
                                   feature_dim=16)
    torch.manual_seed(0)
    model = nocs.PointNet2NOCS(cfg).to(device)
    train_step, _ = make_train_fns(
        model, lambda b, g: model(b["x"], b["pos"], generator=g),
        lambda o, b: nocs.get_metrics(cfg, o, b)[0],
        make_adam(model, 1e-3))
    return model, train_step


def _steps(device, n: int = 1, seed: int = 0):
    """n steps of a fresh model from the same weights, batches and
    dropout draws -> (model, losses)."""
    model, train_step = _stage1(device)
    gen = torch.Generator(device=device).manual_seed(1)
    losses = [train_step(batch_to_device(_host_batch(seed + i), device),
                         gen)["loss"] for i in range(n)]
    return model, losses


def _annotations(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith("train/"))


@pytest.mark.parametrize("all_threads", [False, True])
def test_step_phases_in_a_cpu_trace(tmp_path, all_threads):
    """Under a plain profiler and under one that traces every thread (as
    the benchmark's does)."""
    trace.reset()
    cfg = (torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
           if all_threads else None)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=cfg) as prof:
        _steps("cpu")
    assert [name for _, name in _annotations(prof, tmp_path)] == PHASES
    assert trace.device_ms() == {}          # no card: no device timers


def test_no_profiler_enters_no_range_and_records_no_event(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("entered without a profiler")

    monkeypatch.setattr(trace, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("train/forward", "cuda") is trace.span("x")
    _steps("cpu", n=2)


def test_step_bit_equal_with_and_without_profiler():
    plain, plain_losses = _steps("cpu", n=2)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, traced_losses = _steps("cpu", n=2)
    for a, b in zip(plain_losses, traced_losses):
        assert torch.equal(a, b)
    sa, sb = plain.state_dict(), traced.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.cuda
def test_device_timers_on_a_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the timers are CUDA events")
    dev = torch.device("cuda", 0)
    _steps(dev)                              # build and warm up
    torch.cuda.synchronize()
    trace.reset()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _steps(dev, n=steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    got = trace.device_ms()
    assert sorted(got) == sorted(TIMED)
    for name, (ms, n) in got.items():
        assert n == steps and ms > 0, (name, ms, n)
    assert sum(ms for ms, _ in got.values()) <= wall_ms
    names = [name for _, name in _annotations(prof, tmp_path)]
    assert names == PHASES * steps


def _unet_step(x: torch.Tensor):
    """A small U-Net's forward and backward of its output's sum -> (the
    output, its input's gradient or None, its parameters' gradients)."""
    torch.manual_seed(0)
    net = UNet3D(8, 4, f_maps=8, num_levels=2)
    y = net(x)
    y.sum().backward()
    return y.detach(), x.grad, [p.grad for p in net.parameters()]


def _volume(requires_grad: bool = True) -> torch.Tensor:
    return torch.randn(2, 4, 4, 4, 8, generator=torch.Generator(
        ).manual_seed(1)).requires_grad_(requires_grad)


def test_unet_backward_timer_records_nothing_without_a_profiler(
        monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("timed without a profiler")

    monkeypatch.setattr(trace, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(trace._BackwardMark, "apply", refuse)
    trace.reset()
    x = _volume()
    assert trace.backward_span("unet3d/backward", x)[0] is x
    _, grad, _ = _unet_step(x)
    assert grad is not None
    assert trace.device_ms() == {}


class _FakeEvent:
    """A CUDA event that records a tick of a shared clock."""
    clock = itertools.count(1)

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = next(self.clock)

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_unet_spans_on_a_faked_card(monkeypatch, tmp_path):
    """With the card's events faked on the CPU: one timed forward and one
    backward pair (entry before exit) a step, none for the backward of a
    volume that takes no gradient, and the same numbers as without."""
    plain = _unet_step(_volume())
    monkeypatch.setattr(trace, "_on_card", lambda device: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: 0)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        timed = [_unet_step(_volume()) for _ in range(2)]
        _unet_step(_volume(requires_grad=False))
    # each exit is recorded one tick after its entry
    assert trace.device_ms() == {"unet3d/forward": (3.0, 3),
                                 "unet3d/backward": (2.0, 2)}
    for y, grad, grads in timed:
        assert torch.equal(y, plain[0]) and torch.equal(grad, plain[1])
        assert all(torch.equal(a, b) for a, b in zip(grads, plain[2]))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count("unet3d/forward") == 3


@pytest.mark.cuda
def test_unet_timers_on_a_card():
    """The U-Net's forward and backward timers on the card: one pair each
    a step, the backward's inside the step's wall time and longer than
    none, both absent without a profiler."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the timers are CUDA events")
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    net = UNet3D(16, 8, f_maps=8, num_levels=3).to(dev)
    x = torch.randn(2, 16, 16, 16, 16, device=dev, requires_grad=True)

    def step():
        net(x).square().mean().backward()

    step()
    torch.cuda.synchronize()
    trace.reset()
    step()
    assert trace.device_ms() == {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    got = trace.device_ms()
    assert sorted(got) == ["unet3d/backward", "unet3d/forward"]
    for name, (ms, n) in got.items():
        assert n == 3 and 0 < ms < wall_ms, (name, ms, n)
