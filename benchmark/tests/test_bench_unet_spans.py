"""The readers of the stage-2 U-Net's own device timers, fed synthetic
timer totals; and what they read from a program without them."""
import sys
import types

import pytest

from benchmark.harness import manifest
from benchmark.harness.trace import Trace
from garmentnets_tpu_torch import core
from garmentnets_tpu_torch.core import trace as program_trace

UNET_METRICS = {"unet_forward_device_ms.train": "unet3d/forward",
                "unet_backward_device_ms.train": "unet3d/backward"}


def _ctx(steps=2):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench/window",
           "ts": 0, "dur": 200, "tid": 1}]
    return types.SimpleNamespace(trace_data=Trace(ev), steps=steps,
                                 notes={})


@pytest.mark.parametrize("metric", sorted(UNET_METRICS))
def test_unet_timer_readers(monkeypatch, metric):
    """The mean of the U-Net's own timed spans, which a step may hold more
    or fewer of than the window's steps; None where the table lacks it
    (a program older than those spans, or stage 1)."""
    totals = {"train/forward": (20.0, 2), "unet3d/forward": (9.0, 3),
              "unet3d/backward": (30.0, 4)}
    monkeypatch.setattr(program_trace, "device_ms", lambda: dict(totals))
    got = manifest.reader(metric)(_ctx())
    assert got == pytest.approx({"unet3d/forward": 3.0,
                                 "unet3d/backward": 7.5}[UNET_METRICS[metric]])
    del totals[UNET_METRICS[metric]]
    assert manifest.reader(metric)(_ctx()) is None
    untraced = types.SimpleNamespace(notes={}, steps=3)
    assert manifest.reader(metric)(untraced) is None


@pytest.mark.parametrize("metric", sorted(UNET_METRICS))
def test_a_program_without_the_unet_timers_reads_none(monkeypatch, metric):
    # timers that would read if the module could be imported; the older
    # program has no garmentnets_tpu_torch.core.trace
    monkeypatch.setattr(program_trace, "device_ms",
                        lambda: {UNET_METRICS[metric]: (20.0, 2)})
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "garmentnets_tpu_torch.core.trace",
                        None)
    assert manifest.reader(metric)(_ctx()) is None
    untraced = types.SimpleNamespace(notes={}, steps=3)
    assert manifest.reader(metric)(untraced) is None
