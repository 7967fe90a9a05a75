"""The readers of the program's step-phase spans and device timers, fed
synthetic trace events and timer totals; and what they read from a
program without them."""
import sys
import types

import pytest

from benchmark.harness import manifest
from benchmark.harness.trace import Trace
from garmentnets_tpu_torch import core
from garmentnets_tpu_torch.core import trace as program_trace

SPAN_METRICS = ("copy_ms.train", "forward_issue_ms.train",
                "backward_issue_ms.train", "optimizer_issue_ms.train",
                "copy_idle_share.train")
DEVICE_METRICS = ("forward_device_ms.train", "backward_device_ms.train",
                  "optimizer_device_ms.train")


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _ctx(events, steps=2):
    return types.SimpleNamespace(trace_data=Trace(events), steps=steps,
                                 notes={})


def _events():
    """A 200 us window of two steps; the card is busy 25-45, 60-70,
    130-150 and 160-170; the first copy span (10-40) holds 15 us of idle
    (10-25) and 15 of busy, the second (110-140) holds 20 idle and 10
    busy; one copy span lies partly outside the window and is left out."""
    ann = "user_annotation"
    return [_x(ann, "bench/window", 0, 200),
            _x(ann, "train/batch_to_device", -5, 10),
            _x(ann, "train/batch_to_device", 10, 30),
            _x(ann, "train/forward", 40, 12),
            _x(ann, "train/backward", 52, 20),
            _x(ann, "train/optimizer", 72, 4),
            _x(ann, "train/batch_to_device", 110, 30),
            _x(ann, "train/forward", 140, 8),
            _x(ann, "train/backward", 148, 16),
            _x(ann, "train/optimizer", 164, 6),
            _x("kernel", "a", 25, 20, tid=7),
            _x("kernel", "b", 60, 10, tid=7),
            _x("gpu_memcpy", "copy", 130, 20, tid=8),
            _x("kernel", "c", 160, 10, tid=7)]


def test_host_span_readers():
    ctx = _ctx(_events())
    got = {m: manifest.reader(m)(ctx) for m in SPAN_METRICS}
    assert got["copy_ms.train"] == pytest.approx(30e-3)
    assert got["forward_issue_ms.train"] == pytest.approx(10e-3)
    assert got["backward_issue_ms.train"] == pytest.approx(18e-3)
    assert got["optimizer_issue_ms.train"] == pytest.approx(5e-3)
    # (15 + 20) us idle inside the copy spans of a 200 us window
    assert got["copy_idle_share.train"] == pytest.approx(100 * 35 / 200)
    assert got["copy_idle_share.train"] <= manifest.reader(
        "idle_share.train")(ctx)


def test_idle_inside_a_span_that_holds_no_busy_interval():
    ev = [_x("user_annotation", "bench/window", 0, 100),
          _x("user_annotation", "train/batch_to_device", 40, 20),
          _x("kernel", "a", 0, 30, tid=7), _x("kernel", "b", 70, 30, tid=7)]
    assert manifest.reader("copy_idle_share.train")(
        _ctx(ev)) == pytest.approx(20.0)


def test_device_timer_readers(monkeypatch):
    totals = {"train/forward": (20.0, 2), "train/backward": (50.0, 2),
              "train/optimizer": (3.0, 2)}
    monkeypatch.setattr(program_trace, "device_ms", lambda: dict(totals))
    ctx = _ctx(_events())
    got = [manifest.reader(m)(ctx) for m in DEVICE_METRICS]
    assert got == pytest.approx([10.0, 25.0, 1.5])
    assert ctx.notes["phase_device_counts"]["steps"] == 2


def test_a_program_without_spans_or_timers_reads_none(monkeypatch):
    ann = "user_annotation"
    ev = [_x(ann, "bench/window", 0, 100),
          _x(ann, "bench/batch_to_device", 10, 20),
          _x(ann, "bench/train_step", 30, 50), _x("kernel", "a", 35, 40)]
    # timers that would read if the module could be imported; the older
    # program has no garmentnets_tpu_torch.core.trace
    monkeypatch.setattr(program_trace, "device_ms",
                        lambda: {"train/forward": (20.0, 2)})
    monkeypatch.delattr(core, "trace")
    monkeypatch.setitem(sys.modules, "garmentnets_tpu_torch.core.trace",
                        None)
    ctx = _ctx(ev)
    for m in SPAN_METRICS + DEVICE_METRICS:
        assert manifest.reader(m)(ctx) is None, m
    untraced = types.SimpleNamespace(notes={}, steps=3)
    for m in SPAN_METRICS + DEVICE_METRICS:
        assert manifest.reader(m)(untraced) is None, m
