"""Reading a profiler trace: busy time, the window, and idle gaps named
by the span that covers them."""
from benchmark.harness.trace import Trace


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def test_busy_idle_and_spans():
    ev = [_x("user_annotation", "bench/window", 0, 100),
          _x("user_annotation", "bench/train_step", 10, 20),
          _x("cuda_runtime", "cudaLaunchKernel", 12, 1),
          _x("kernel", "a", 20, 10, tid=7),
          _x("kernel", "b", 25, 10, tid=7),
          _x("kernel", "c", 40, 5, tid=7),
          _x("kernel", "d", 60, 10, tid=7),
          _x("gpu_memcpy", "copy", 95, 10, tid=8)]
    t = Trace(ev)
    assert abs(t.window_s - 100e-6) < 1e-12
    assert abs(t.busy_s - (15 + 5 + 10 + 5) * 1e-6) < 1e-12
    assert [k for k, _ in t.top_device_ops(2)] == ["a", "b"]
    gaps = t.longest_idle_gaps(2)
    assert [round(g[1] * 1e6, 6) for g in gaps] == [25.0, 20.0]
    assert [g[0] for g in gaps] == ["no span", "bench/train_step"]
