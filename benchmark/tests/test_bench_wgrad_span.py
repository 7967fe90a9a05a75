"""The reader of the stage-2 U-Net's filter-gradient timer
(`unet_wgrad_device_ms.train`), fed synthetic timer totals; and what it
reads from a program without that span."""
import sys
import types

import pytest

from benchmark.harness import manifest
from benchmark.harness.trace import Trace
from garmentnets_tpu_torch import core
from garmentnets_tpu_torch.core import trace as program_trace

METRIC = "unet_wgrad_device_ms.train"


def _ctx(steps=2):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench/window",
           "ts": 0, "dur": 200, "tid": 1}]
    return types.SimpleNamespace(trace_data=Trace(ev), steps=steps,
                                 notes={})


@pytest.mark.parametrize("steps,want", [(2, 21.0), (3, 14.0)])
def test_reads_the_total_over_the_steps(monkeypatch, steps, want):
    """Fourteen spans a step (one a convolution): their total over the
    window's steps, not their mean."""
    totals = {"train/forward": (20.0, steps),
              "unet3d/backward": (90.0, steps),
              "unet3d/wgrad": (42.0, 14 * steps)}
    monkeypatch.setattr(program_trace, "device_ms", lambda: dict(totals))
    assert manifest.reader(METRIC)(_ctx(steps)) == pytest.approx(want)


def test_none_without_the_span_a_trace_or_steps(monkeypatch):
    """The parent program times no filter gradient; an untraced run and a
    window without steps read nothing either."""
    monkeypatch.setattr(program_trace, "device_ms",
                        lambda: {"unet3d/backward": (90.0, 2)})
    assert manifest.reader(METRIC)(_ctx()) is None
    monkeypatch.setattr(program_trace, "device_ms",
                        lambda: {"unet3d/wgrad": (42.0, 28)})
    assert manifest.reader(METRIC)(_ctx(steps=0)) is None
    untraced = types.SimpleNamespace(notes={}, steps=3)
    assert manifest.reader(METRIC)(untraced) is None


def test_a_program_without_the_trace_module_reads_none(monkeypatch):
    monkeypatch.setattr(program_trace, "device_ms",
                        lambda: {"unet3d/wgrad": (42.0, 28)})
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "garmentnets_tpu_torch.core.trace",
                        None)
    assert manifest.reader(METRIC)(_ctx()) is None
