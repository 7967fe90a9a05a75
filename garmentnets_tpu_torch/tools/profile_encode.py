"""Where the predict engine's encode spends its time on the card.

    python -m garmentnets_tpu_torch.tools.profile_encode [--batches 3]
        [--precision high]

Builds the PredictEngine at the full width of PipelineConfig() (B=8,
N=6000, 128^3 WNF) with seeded random weights at a decode tier (the
engine's default 'high' unless --precision says otherwise),
traces --batches calls of engine.encode with torch.profiler and prints:
  - per-stage device ms per encode: the span on the device timeline of
    each of the engine's encode/* ranges (first kernel start to last
    kernel end);
  - device time by kernel name per encode, and the device busy share
    (kernel time over the encode's wall time with the profiler on);
  - the share of valid neighbour slots in each set-abstraction call
    (SA1, SA2), read from one more encode outside the trace;
  - one JSON line with all of it.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from garmentnets_tpu_torch.core.random_weights import seeded_init_
from garmentnets_tpu_torch.harness.predict_engine import PredictEngine
from garmentnets_tpu_torch.models import pointnet2
from garmentnets_tpu_torch.models.pipeline import (
    ConvImplicitWNFPipeline, PipelineConfig)

B, N, VOL = 8, 6000, 128


def _device_ms(evt) -> float:
    """Device ms of a device-side profiler event (a kernel, or a range's
    span on the device timeline)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr) / 1e3
    return 0.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", default="high",
                    choices=("highest", "high", "default"))
    args = ap.parse_args(argv)

    cfg = PipelineConfig()
    model = ConvImplicitWNFPipeline(cfg)
    seeded_init_(model, args.seed)
    engine = PredictEngine(cfg, model.state_dict(), volume_size=VOL,
                           decode_precision=args.precision, mc_threads=1)
    rng = np.random.RandomState(args.seed)
    x = torch.from_numpy(rng.rand(B, N, 3).astype(np.float32)).cuda()
    pos = torch.from_numpy((rng.rand(B, N, 3) - 0.5).astype(
        np.float32)).cuda()
    engine.encode(x, pos)                                      # warm-up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.batches):
            engine.encode(x, pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.batches
    # only device-side events: a host-side range does not see the kernels
    # that the ctypes-loaded libraries launch
    stages, by_name = {}, {}
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        ms = _device_ms(evt) / args.batches
        if evt.key.startswith("encode/"):
            stages[evt.key[len("encode/"):]] = ms
        elif ms > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + ms
    busy = sum(by_name.values())

    # valid-slot shares of the set-abstraction calls, outside the trace
    shares = []
    sa_fused = pointnet2.sa_fused

    def counting_sa_fused(*args):
        shares.append(float(args[4].float().mean()))     # the mask
        return sa_fused(*args)

    pointnet2.sa_fused = counting_sa_fused
    try:
        engine.encode(x, pos)
    finally:
        pointnet2.sa_fused = sa_fused
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]

    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; decode precision {engine.decode_precision}")
    print(f"encode stage spans on the device (ms per encode, "
          f"{args.batches} traced): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    print(f"traced encode: wall {wall_ms:.2f} ms (profiler on), device "
          f"busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%)")
    print("valid neighbour slots: "
          + ", ".join(f"SA{i + 1} {v:.4f}" for i, v in enumerate(shares)))
    for k, v in top:
        print(f"  {v:9.3f} ms  {k[:90]}")
    print(json.dumps({"device": name,
                      "decode_precision": engine.decode_precision,
                      "stage_spans_ms": stages,
                      "traced_wall_ms": wall_ms,
                      "device_busy_ms": busy, "valid_slot_share": shares,
                      "top_kernels_ms": dict(top)}))
    engine.close()


if __name__ == "__main__":
    main()
