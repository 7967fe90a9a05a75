"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the metrics, driven by the cell's files.

A driver module (drivers/<traffic's "driver">.py) provides
- setup(ctx): builds the system under test from the seed and warms up
  every shape the traffic uses, calling ctx.mark(name) at the end of
  each phase (the phases' seconds are logged);
- window(ctx, seconds): measures, setting ctx.t0 (the window's start on
  the host clock), ctx.window_s, ctx.attempted and ctx.failed, and, with
  ctx.trace, ctx.trace_file (a torch.profiler chrome trace with a
  `bench/window` span);
- release(ctx): frees the system under test;
- check(ctx): the numbers compared against the cell's limits.
Each metric is then read from ctx by its own reader (metrics/<name>.py).
"""
from __future__ import annotations

import importlib
import math
import os
import sys
import time
import types

from benchmark.harness import guard, manifest
from benchmark.harness.trace import Trace

RUNS_DIR = manifest.BENCH_DIR / ".runs"


class NoDevice(RuntimeError):
    pass


class ForbiddenModules(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cuda_ready(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA device(s), the "
                       f"cell needs {chips}")


def run(bench: dict, cell_name: str, seed: int, seconds: float,
        trace: bool, t_start: float, device: str = "cuda",
        require_cuda: bool = True, config=None, traffic=None,
        limits=None, numbers_out=None) -> dict:
    """The result line of one run; t_start is the process's start on the
    host clock. config, traffic and limits default to the cell's files;
    the harness's own tests give smaller ones and run on the CPU without
    the look for a card. numbers_out, a dict, receives every number the
    check worked out, compared or not (for the readings tool)."""
    cell_ = manifest.cell(bench, cell_name)
    config = config or manifest.config_of(bench, cell_)
    traffic = traffic or manifest.traffic_of(cell_)
    limits = limits or manifest.limits_of(cell_)
    if require_cuda:
        cuda_ready(cell_["chips"])
    import torch
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    marks = [("start", t_start)]
    ctx = types.SimpleNamespace(
        config=config, traffic=traffic, seed=int(seed), device=device,
        trace=bool(trace), cell=cell_name, log=log, trace_file=None,
        notes={}, mark=lambda name: marks.append((name, time.perf_counter())))
    RUNS_DIR.mkdir(exist_ok=True)
    ctx.mark("imports")
    driver.setup(ctx)
    _guard("at the end of set-up")
    driver.window(ctx, seconds)
    ctx.setup_s = ctx.t0 - t_start
    marks.append(("rest", ctx.t0))
    ctx.notes["setup_phases_s"] = {
        name: round(t - marks[i][1], 3)
        for i, (name, t) in enumerate(marks[1:]) if t <= ctx.t0}
    _guard("once the window has closed")
    on_card = torch.device(device).type == "cuda"
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": (torch.cuda.get_device_name(0) if on_card
                         else "cpu"),
                "count": cell_["chips"],
                "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                      if on_card else 0)}
    if ctx.trace_file is not None:
        ctx.trace_data = Trace.load(ctx.trace_file)
        os.unlink(ctx.trace_file)
        dev_info["busy_s"] = ctx.trace_data.busy_s
        dev_info["window_s"] = ctx.trace_data.window_s
    driver.release(ctx)
    t_check = time.perf_counter()
    numbers = driver.check(ctx)
    ctx.log(f"check took {time.perf_counter() - t_check:.1f} s")
    if numbers_out is not None:
        numbers_out.update(numbers)
    compared, correct = decide(numbers, limits)
    metrics = {}
    for m in manifest.metrics_of(bench, cell_name, trace):
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    for k, v in ctx.notes.items():
        ctx.log(f"note {k}: {v}")
    for k, v in compared.items():
        ctx.log(f"compared {k}: {v['value']!r} (limit {v['limit']!r})")
    result = {"correct": bool(correct), "attempted": int(ctx.attempted),
              "failed": int(ctx.failed), "metrics": metrics,
              "device": dev_info}
    if ctx.trace_file is not None:
        result["breakdown"] = {
            "device_ops": ctx.trace_data.top_device_ops(),
            "idle_gaps": ctx.trace_data.longest_idle_gaps()}
    result["compared"] = compared
    return result


def decide(numbers: dict, limits: dict) -> tuple:
    """-> ({number: {"value", "limit"}}, correct): correct where every
    number the limits name is finite and at most its limit."""
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(isinstance(v["value"], float) and math.isfinite(v["value"])
                  and v["value"] <= v["limit"] for v in compared.values())
    return compared, correct


def _guard(when: str) -> None:
    bad = guard.forbidden_loaded()
    if bad:
        raise ForbiddenModules(f"loaded {when}: {', '.join(bad)}")


def start_profiler(ctx):
    """A torch.profiler of the host and the card, started."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(ctx.device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:        # every thread's spans: the service runs on its own
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        prof = torch.profiler.profile(activities=acts,
                                      experimental_config=cfg)
    except TypeError:
        prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_profiler(ctx, prof) -> None:
    prof.stop()
    path = RUNS_DIR / f"{ctx.cell}-trace.json"
    prof.export_chrome_trace(str(path))
    ctx.trace_file = path
