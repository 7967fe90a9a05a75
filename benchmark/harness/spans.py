"""The program's own step phases in a traced window, for the per-layer
metrics of the training step: the host spans `train/*` that
garmentnets_tpu_torch/core/trace.py opens under a profiler, and the
stream-ordered device ms it times for each. A program without them (one
older than those spans) reads None and does not raise."""
from __future__ import annotations

COPY = "train/batch_to_device"


def _window_spans(t, name: str) -> list:
    """(start, end) of each `name` span that lies inside the window."""
    return [(ts, ts + dur) for ts, dur, n, _ in t.spans
            if n == name and t.ws <= ts and ts + dur <= t.we]


def host_ms(ctx, name: str):
    """Mean host ms of the window's `name` spans, or None."""
    t = getattr(ctx, "trace_data", None)
    spans = _window_spans(t, name) if t is not None else []
    if not spans:
        return None
    return 1e-3 * sum(b - a for a, b in spans) / len(spans)


def _merged(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_share_inside(ctx, name: str):
    """Percent of the window in which no kernel or copy runs on the card
    while the host is inside a `name` span, or None."""
    t = getattr(ctx, "trace_data", None)
    spans = _window_spans(t, name) if t is not None else []
    if not spans or t.window_s <= 0:
        return None
    busy = t._busy_intervals()
    idle, j = 0.0, 0
    for a, b in _merged(spans):
        covered = 0.0
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        idle += (b - a) - covered
    return 100.0 * idle * 1e-6 / t.window_s


def device_ms(ctx, name: str):
    """Mean stream-ordered device ms of the `name` phase over the traced
    window's steps (core.trace.device_ms), or None."""
    if getattr(ctx, "trace_data", None) is None:
        return None
    try:
        from garmentnets_tpu_torch.core import trace
    except ImportError:
        return None
    totals = trace.device_ms()
    ctx.notes["phase_device_counts"] = dict(
        {k: n for k, (_, n) in totals.items()}, steps=ctx.steps)
    ms, n = totals.get(name, (0.0, 0))
    return ms / n if n else None
