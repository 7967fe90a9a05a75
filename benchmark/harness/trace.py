"""Reads a torch.profiler (Kineto) chrome trace into what the per-layer
metrics and the result's breakdown need: the device's kernels and copies
and the host's spans, within the window's `bench/window` span.
"""
from __future__ import annotations

import collections
import json

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
WINDOW_SPAN = "bench/window"


class Trace:
    def __init__(self, events: list):
        self.device = []            # (ts, dur, name, cat)
        self.spans = []             # (ts, dur, name, tid)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append((ts, dur, e.get("name", ""), cat))
            elif cat == "user_annotation":
                self.spans.append((ts, dur, e.get("name", ""), e.get("tid")))
        self.device.sort()
        wins = [s for s in self.spans if s[2] == WINDOW_SPAN]
        if wins:
            self.ws, self.we = wins[0][0], wins[0][0] + wins[0][1]
        elif self.device:
            self.ws = self.device[0][0]
            self.we = max(t + d for t, d, *_ in self.device)
        else:
            self.ws = self.we = 0.0

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # -- the window ------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.we - self.ws) * 1e-6

    def _busy_intervals(self) -> list:
        out = []
        for ts, dur, *_ in self.device:
            a, b = max(ts, self.ws), min(ts + dur, self.we)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy_intervals()) * 1e-6

    # -- breakdown -------------------------------------------------------
    def top_device_ops(self, n: int = 10) -> list:
        acc = collections.Counter()
        for ts, dur, name, _ in self.device:
            if self.ws <= ts < self.we:
                acc[name[:120]] += dur * 1e-6
        return [[k, v] for k, v in acc.most_common(n)]

    def longest_idle_gaps(self, n: int = 10) -> list:
        """The n longest gaps with no device activity in the window, each
        named by the innermost benchmark span that covers its middle."""
        busy = self._busy_intervals()
        edges = [self.ws] + [x for iv in busy for x in iv] + [self.we]
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        out = []
        for length, start in gaps[:n]:
            mid = start + length / 2
            cover = [s for s in self.spans if s[0] <= mid <= s[0] + s[1]
                     and s[2] != WINDOW_SPAN]
            name = min(cover, key=lambda s: s[1])[2] if cover else "no span"
            out.append([name, length * 1e-6])
        return out
